"""The training step's host side against the JAX package: culled
compositing's exact zeros, the ray tables and their gather, the loss terms,
and the synthetic scene."""

import os

import numpy as np
import pytest
import torch


def test_cull_eps_compositing_gives_exact_zero_cotangents():
    """Under ``cull_eps`` every sample past a ray's termination gets an
    exactly zero cotangent in all four raw channels (what makes the culled
    backward exact), and the per-ray live lengths equal JAX's."""
    import jax
    import jax.numpy as jnp

    from depth_lidar_nerf_tpu.ops.compositing import raw2outputs_t as jcomp
    from depth_lidar_nerf_tpu_torch.ops.compositing import raw2outputs_t

    rng = np.random.default_rng(0)
    N, S, eps = 16, 64, 1e-4
    raw = rng.normal(size=(4, N, S)).astype(np.float32)
    raw[3] *= 3.0
    raw[3, :, 20:] += np.linspace(-4, 8, N)[:, None]  # rays end at many depths
    z = np.sort(rng.uniform(2, 6, (N, S)), -1).astype(np.float32)
    rd = rng.normal(size=(N, 3)).astype(np.float32)
    w = rng.normal(size=(4, N)).astype(np.float32)

    def loss(out, lib, wl):
        return (lib.sum(out.rgb * wl[:3].T) + lib.sum(out.depth * wl[3])
                + lib.sum(out.acc * wl[0]) + lib.sum(out.disp * 1e-3))

    g_jax = np.asarray(jax.grad(lambda r: loss(jcomp(
        r, jnp.asarray(z), jnp.asarray(rd), cull_eps=eps), jnp,
        jnp.asarray(w)))(
        jnp.asarray(raw)))
    rt = torch.from_numpy(raw).requires_grad_()
    out = raw2outputs_t(rt, torch.from_numpy(z), torch.from_numpy(rd),
                        cull_eps=eps)
    loss(out, torch, torch.from_numpy(w)).backward()
    g = rt.grad.numpy()

    def live_lengths(gr):
        act = (gr != 0).any(0)
        return np.max(np.where(act, np.arange(1, S + 1)[None], 0), axis=1)

    dists = np.concatenate([np.diff(z, axis=-1), np.full((N, 1), 1e10)], -1)
    alpha = 1.0 - np.exp(-np.maximum(raw[3], 0)
                         * dists * np.linalg.norm(rd, axis=-1, keepdims=True))
    trans = np.cumprod(np.concatenate([np.ones((N, 1)), 1.0 - alpha + 1e-10],
                                      -1), -1)[:, :-1]
    for n in range(N):
        dead = np.nonzero(trans[n] < eps)[0]
        if dead.size:
            assert np.all(g[:, n, dead[0] + 1:] == 0.0), n
    lengths = live_lengths(g)
    assert (lengths < S).sum() >= 4  # the cull bites on several rays
    np.testing.assert_array_equal(lengths, live_lengths(g_jax))
    np.testing.assert_allclose(g, g_jax, rtol=1e-4, atol=1e-6)


@pytest.mark.parametrize("ndc", [False, True])
def test_ray_tables_and_gather_match_jax(ndc):
    import jax.numpy as jnp

    from depth_lidar_nerf_tpu.render.renderer import RenderConfig as JR
    from depth_lidar_nerf_tpu.train import tables as jt
    from depth_lidar_nerf_tpu_torch.data.synthetic import draw_scene
    from depth_lidar_nerf_tpu_torch.render.renderer import RenderConfig
    from depth_lidar_nerf_tpu_torch.train import tables as tt

    sc = draw_scene(n_images=3, H=10, W=14, focal=12.0, n_depth_points=25,
                    backdrop=True)
    H, W, focal = sc.hwf
    kw = dict(ndc=ndc, near=0.5, far=7.0, use_viewdirs=True)
    jr, tr = JR(**kw), RenderConfig(**kw)
    it = np.array([0, 2])
    cpu = torch.device("cpu")
    pairs = [(jt.build_rgb_table(sc.images, sc.poses, it, H, W, focal, jr),
              tt.build_rgb_table(sc.images, sc.poses, it, H, W, focal, tr,
                                 device=cpu)),
             (jt.build_depth_table(sc.depth_gts, sc.poses, it, H, W, focal, jr),
              tt.build_depth_table(sc.depth_gts, sc.poses, it, H, W, focal, tr,
                                   device=cpu))]
    idx = np.random.default_rng(1).integers(0, 40, 17)
    for jtab, ttab in pairs:
        for a, b in zip(jtab, ttab):
            if a is None:
                assert b is None
                continue
            np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=1e-5,
                                       atol=1e-6)
        jrays = jt.gather_rays(jtab, jnp.asarray(idx), jr)
        trays = tt.gather_rays(ttab, torch.from_numpy(idx), tr)
        for a, b in zip(jrays, trays):
            np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=1e-5,
                                       atol=1e-6)


def test_losses_match_jax():
    import jax.numpy as jnp

    from depth_lidar_nerf_tpu.train import losses as jl
    from depth_lidar_nerf_tpu_torch.train import losses as tl

    rng = np.random.default_rng(0)
    x, y = rng.uniform(0, 1, (2, 50, 3)).astype(np.float32)
    r, t = rng.uniform(1, 5, (2, 40)).astype(np.float32)
    w = rng.uniform(0, 2, 40).astype(np.float32)
    tx, ty, trr, tt_, tw = map(torch.from_numpy, (x, y, r, t, w))
    mse = tl.img2mse(tx, ty)
    np.testing.assert_allclose(mse.item(), float(jl.img2mse(x, y)), rtol=1e-6)
    np.testing.assert_allclose(tl.mse2psnr(mse).item(),
                               float(jl.mse2psnr(jnp.float32(mse.item()))),
                               rtol=1e-6)
    np.testing.assert_array_equal(tl.to8b(x), jl.to8b(x))
    for step in (0, 1, 1234, 250000):
        np.testing.assert_allclose(tl.depth_importance(step, 250),
                                   float(jl.depth_importance(step, 250)),
                                   rtol=1e-6)
    for kw in (dict(), dict(relative=True), dict(weighted=True),
               dict(weighted=True, normalize=True)):
        np.testing.assert_allclose(
            tl.depth_loss(trr, tt_, tw, **kw).item(),
            float(jl.depth_loss(r, t, w, **kw)), rtol=1e-6, err_msg=str(kw))


def test_synthetic_scene_matches_jax_make_scene(tmp_path):
    """The port's copy writes the same LLFF scene as the JAX package's
    ``make_scene``, and ``draw_scene`` holds it without any file."""
    from depth_lidar_nerf_tpu.data.synthetic import make_scene as jmake
    from depth_lidar_nerf_tpu_torch.data.synthetic import draw_scene, make_scene

    kw = dict(n_images=3, H=9, W=13, focal=10.0, n_depth_points=20, seed=4,
              backdrop=True)
    jmake(str(tmp_path / "jax"), **kw)
    make_scene(str(tmp_path / "port"), **kw)
    for name in ("poses_bounds.npy",):
        np.testing.assert_array_equal(np.load(tmp_path / "port" / name),
                                      np.load(tmp_path / "jax" / name))
    dj = np.load(tmp_path / "jax" / "depth_gt.npy", allow_pickle=True)
    dp = np.load(tmp_path / "port" / "depth_gt.npy", allow_pickle=True)
    for a, b in zip(dj, dp):
        for k in ("depth", "coord", "weight"):
            np.testing.assert_array_equal(a[k], b[k])
    sj = np.load(tmp_path / "jax" / "segmentation_gt.npy", allow_pickle=True).item()
    sp = np.load(tmp_path / "port" / "segmentation_gt.npy", allow_pickle=True).item()
    np.testing.assert_array_equal(sj["segmentations"], sp["segmentations"])
    assert sj["num_classes"] == sp["num_classes"]
    assert sorted(os.listdir(tmp_path / "jax" / "images")) == \
        sorted(os.listdir(tmp_path / "port" / "images"))
    sc = draw_scene(**kw)
    assert sc.images.shape == (3, 9, 13, 3) and sc.poses.shape == (3, 3, 4)
    np.testing.assert_allclose(np.load(tmp_path / "port" / "poses_bounds.npy")[:, -2:],
                               np.tile([sc.near, sc.far], (3, 1)))
