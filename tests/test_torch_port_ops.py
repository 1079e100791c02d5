"""The port's ray, encoding, sampling and compositing ops against the JAX
package's functions on the same seeded numpy inputs (float32, CPU)."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from torch_port_helpers import look_at_pose

T = torch.from_numpy


@pytest.mark.parametrize("num_freqs", [0, 4, 10])
def test_positional_encoding(num_freqs):
    from depth_lidar_nerf_tpu.ops.embedding import positional_encoding as jpe
    from depth_lidar_nerf_tpu_torch.ops.embedding import (embedding_dim,
                                                          positional_encoding)

    x = np.random.default_rng(0).uniform(-1.5, 1.5, (5, 7, 3)).astype(np.float32)
    ref = np.asarray(jpe(jnp.asarray(x), num_freqs))
    got = positional_encoding(T(x), num_freqs).numpy()
    assert got.shape[-1] == embedding_dim(3, num_freqs)
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-5)


def test_camera_rays_and_rays_by_coord():
    from depth_lidar_nerf_tpu.ops import rays as jr
    from depth_lidar_nerf_tpu_torch.ops import rays as tr

    c2w = look_at_pose(1)
    H, W, focal = 6, 9, 7.5
    ro, rd = jr.camera_rays(H, W, focal, jnp.asarray(c2w))
    to, td = tr.camera_rays(H, W, focal, T(c2w))
    np.testing.assert_allclose(to.numpy(), np.asarray(ro), rtol=0, atol=0)
    np.testing.assert_allclose(td.numpy(), np.asarray(rd), rtol=1e-6, atol=1e-7)

    coords = np.random.default_rng(2).uniform(0, 9, (11, 2)).astype(np.float32)
    ro, rd = jr.rays_by_coord(H, W, focal, jnp.asarray(c2w), jnp.asarray(coords))
    to, td = tr.rays_by_coord(H, W, focal, T(c2w), T(coords))
    np.testing.assert_allclose(td.numpy(), np.asarray(rd), rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(to.numpy(), np.asarray(ro), rtol=0, atol=0)


def test_ndc_rays():
    from depth_lidar_nerf_tpu.ops.rays import ndc_rays as jndc
    from depth_lidar_nerf_tpu_torch.ops.rays import ndc_rays

    rng = np.random.default_rng(3)
    ro = rng.normal(0, 0.1, (20, 3)).astype(np.float32)
    rd = rng.normal(0, 0.3, (20, 3)).astype(np.float32)
    rd[:, 2] = -1.0
    jo, jd = jndc(8, 12, 10.0, 1.0, jnp.asarray(ro), jnp.asarray(rd))
    to, td = ndc_rays(8, 12, 10.0, 1.0, T(ro), T(rd))
    np.testing.assert_allclose(to.numpy(), np.asarray(jo), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(td.numpy(), np.asarray(jd), rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("lindisp", [False, True])
def test_stratified_z_vals(lindisp):
    from depth_lidar_nerf_tpu.ops.sampling import stratified_z_vals as jz
    from depth_lidar_nerf_tpu_torch.ops.sampling import stratified_z_vals

    near = np.full((5, 1), 2.0, np.float32)
    far = np.full((5, 1), 6.0, np.float32)
    ref = np.asarray(jz(jnp.asarray(near), jnp.asarray(far), 16,
                        lindisp=lindisp, perturb=False))
    got = stratified_z_vals(T(near), T(far), 16, lindisp=lindisp,
                            perturb=False).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-6, atol=1e-6)
    # Jittered: one draw per sample, inside its stratum, reproducible.
    g = torch.Generator().manual_seed(0)
    z1 = stratified_z_vals(T(near), T(far), 16, lindisp=lindisp, generator=g)
    g.manual_seed(0)
    z2 = stratified_z_vals(T(near), T(far), 16, lindisp=lindisp, generator=g)
    assert torch.equal(z1, z2)
    mids = np.concatenate([ref[:, :1], 0.5 * (ref[:, 1:] + ref[:, :-1]),
                           ref[:, -1:]], -1)
    assert (z1.numpy() >= mids[:, :-1] - 1e-6).all()
    assert (z1.numpy() <= mids[:, 1:] + 1e-6).all()
    with pytest.raises(ValueError):
        stratified_z_vals(T(near), T(far), 16, perturb=True)


def test_searchsorted_right():
    from depth_lidar_nerf_tpu.ops.sampling import searchsorted_right as jss
    from depth_lidar_nerf_tpu_torch.ops.sampling import searchsorted_right

    rng = np.random.default_rng(4)
    seq = np.sort(rng.uniform(0, 1, (6, 9)), -1).astype(np.float32)
    vals = rng.uniform(-0.1, 1.1, (6, 13)).astype(np.float32)
    vals[:, 0] = seq[:, 3]  # ties count as <= (side="right")
    ref = np.asarray(jss(jnp.asarray(seq), jnp.asarray(vals)))
    got = searchsorted_right(T(seq), T(vals)).numpy()
    np.testing.assert_array_equal(got, ref)
    np.testing.assert_array_equal(
        got, torch.searchsorted(T(seq), T(vals), right=True).numpy())


def test_sample_pdf_det():
    from depth_lidar_nerf_tpu.ops.sampling import sample_pdf as jsp
    from depth_lidar_nerf_tpu_torch.ops.sampling import sample_pdf

    rng = np.random.default_rng(5)
    bins = np.sort(rng.uniform(2, 6, (10, 17)), -1).astype(np.float32)
    w = rng.uniform(0, 1, (10, 16)).astype(np.float32)
    w[2] = 0.0  # all-zero weights: the 1e-5 floor makes a uniform pdf
    w[3, 5:] = 0.0
    ref = np.asarray(jsp(jnp.asarray(bins), jnp.asarray(w), 24, det=True))
    got = sample_pdf(T(bins), T(w), 24, det=True).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-5)
    with pytest.raises(ValueError):
        sample_pdf(T(bins), T(w), 24, det=False)


def _raw_inputs(N=6, S=20, C=0, seed=6):
    rng = np.random.default_rng(seed)
    raw = rng.normal(0, 2, (N, S, 4 + C)).astype(np.float32)
    z = np.sort(rng.uniform(2, 6, (N, S)), -1).astype(np.float32)
    rd = rng.normal(size=(N, 3)).astype(np.float32)
    return raw, z, rd


@pytest.mark.parametrize("cull_eps", [0.0, 1e-2])
@pytest.mark.parametrize("white_bkgd", [False, True])
def test_raw2outputs(cull_eps, white_bkgd):
    from depth_lidar_nerf_tpu.ops.compositing import raw2outputs as jr2o
    from depth_lidar_nerf_tpu_torch.ops.compositing import raw2outputs

    raw, z, rd = _raw_inputs(C=3)
    ref = jr2o(jnp.asarray(raw), jnp.asarray(z), jnp.asarray(rd),
               white_bkgd=white_bkgd, num_semantic_classes=3,
               cull_eps=cull_eps)
    got = raw2outputs(T(raw), T(z), T(rd), white_bkgd=white_bkgd,
                      num_semantic_classes=3, cull_eps=cull_eps)
    for a, b in zip(ref, got):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=1e-5,
                                   atol=1e-6)


@pytest.mark.parametrize("cull_eps", [0.0, 1e-2])
def test_raw2outputs_t_and_dists(cull_eps):
    from depth_lidar_nerf_tpu.ops import compositing as jc
    from depth_lidar_nerf_tpu_torch.ops import compositing as tc

    raw, z, rd = _raw_inputs()
    noise = np.random.default_rng(7).normal(0, 0.5, z.shape).astype(np.float32)
    raw_t = np.ascontiguousarray(raw.transpose(2, 0, 1))
    np.testing.assert_allclose(
        tc.composit_dists(T(z), T(rd)).numpy(),
        np.asarray(jc.composit_dists(jnp.asarray(z), jnp.asarray(rd))),
        rtol=1e-6)
    ref = jc.raw2outputs_t(jnp.asarray(raw_t), jnp.asarray(z), jnp.asarray(rd),
                           cull_eps=cull_eps, noise=jnp.asarray(noise))
    got = tc.raw2outputs_t(T(raw_t), T(z), T(rd), cull_eps=cull_eps,
                           noise=T(noise))
    for a, b in zip(ref[:5], got[:5]):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=1e-5,
                                   atol=1e-6)
    # Channel-major and point-major compositing agree.
    plain = tc.raw2outputs(T(raw), T(z), T(rd), cull_eps=cull_eps)
    got = tc.raw2outputs_t(T(raw_t), T(z), T(rd), cull_eps=cull_eps)
    for a, b in zip(plain[:5], got[:5]):
        torch.testing.assert_close(b, a, rtol=1e-6, atol=1e-7)


def test_generate_render_path_matches_jax():
    from depth_lidar_nerf_tpu.data.poses import generate_render_path as jgen
    from depth_lidar_nerf_tpu_torch.data.poses import generate_render_path

    base = np.stack([look_at_pose(k) for k in range(5)]).astype(np.float64)
    np.testing.assert_allclose(generate_render_path(base, 88.0, N_views=7),
                               jgen(base, 88.0, N_views=7), rtol=1e-12)
