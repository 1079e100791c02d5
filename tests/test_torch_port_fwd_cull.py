"""The early-terminating forward (kernel 9, ``DLNERF_CULL_FWD=1``) on the CPU:
its regrouping and its plain twin against JAX ``_fwd_impl_cf`` (Pallas
kernel in the interpreter), its exactness against the dense route (JAX's
``test_fused_fwd_cull_exact``, mirrored), ``render_rays`` with the knob set
against JAX's, and the route.

Tolerances: the regrouping bit for bit; live raw at float32 rtol 1e-4 /
atol 1e-5, and the same blocks skipped (a block's skip compares a
transmittance product against half of ``cull_eps``; the two packages sum its
logs in other orders, so a group within float32 rounding of the threshold
could go either way, which this seeded field does not have); composited
outputs at rtol 1e-4 / atol 1e-5 and gradients at 1e-4 of each tensor's mean
magnitude, as JAX's own test holds them."""

import numpy as np
import pytest

from torch_port_helpers import flax_mlp_params, interpret_pallas, look_at_pose
from torch_port_train_helpers import grad_compare, spy_routes

W, EPS = 128, 1e-3


def _inputs(N, S, seed=0):
    """Rays, depths, a scrambled sort key, the compositor's distance terms
    and sigma noise (numpy, float32)."""
    from torch_port_helpers import ray_batch

    ro, rd, vd, z = ray_batch(N, S, seed=seed)
    rng = np.random.default_rng(seed + 7)
    key = rng.uniform(size=N).astype(np.float32)
    noise = (rng.normal(size=(N, S)) * 0.5).astype(np.float32)
    dists = np.concatenate([z[:, 1:] - z[:, :-1],
                            np.full((N, 1), 1e10, np.float32)], -1)
    deltas = (dists * np.linalg.norm(rd, axis=-1, keepdims=True)).astype(
        np.float32)
    return ro, rd, vd, z, key, deltas, noise


def _port_params(depth, seed=0):
    """Flax params and the port's mapping with the density bias at 30 (JAX
    ``tests/test_fused_mlp.py`` ``_occluding_params``: rays terminate
    mid-range)."""
    import torch

    from depth_lidar_nerf_tpu_torch.weights import mlp_state_dict

    _, params = flax_mlp_params(depth, W, seed=seed)
    sd = mlp_state_dict(params)
    sd["sigma.bias"] = torch.full_like(sd["sigma.bias"], 30.0)
    params["params"]["sigma"]["bias"] = np.full_like(
        params["params"]["sigma"]["bias"], 30.0)
    return params, {k: v.requires_grad_() for k, v in sd.items()}


def _capture_cf_inputs(monkeypatch, fmt):
    """Interpret JAX's pallas_calls and keep the early-terminating kernel's
    inputs (regrouped points, per-group view directions, aux)."""
    interpret_pallas(monkeypatch, fmt)
    patched, seen = fmt.pl.pallas_call, {}

    def spy(kernel, *a, **k):
        call = patched(kernel, *a, **k)
        if getattr(kernel, "func", None) is fmt._fwd_kernel_cf:
            def run(*args):
                seen["xb"], seen["vt"], seen["aux"] = (np.asarray(x)
                                                       for x in args[:3])
                out = call(*args)
                seen["out_b"] = np.asarray(out)
                return out
            return run
        return call

    monkeypatch.setattr(fmt.pl, "pallas_call", spy)
    return seen


@pytest.mark.parametrize("N", [256, 100])
def test_cf_layout_and_twin_match_jax(monkeypatch, N):
    """:func:`cf_layout` equals JAX's regrouping bit for bit (the sort, the
    padding, the block order, the view directions per group) and
    :func:`cf_unlayout` inverts it; kernel 9's twin skips the blocks JAX's
    interpreted kernel skips and matches its live raw, in both layouts."""
    import jax.numpy as jnp
    import torch

    import depth_lidar_nerf_tpu.ops.fused_mlp as jfm
    import depth_lidar_nerf_tpu.ops.fused_mlp_t as jfmt
    from depth_lidar_nerf_tpu_torch.ops import fused_mlp_t as tfmt

    monkeypatch.setenv("DLNERF_CULL_FWD", "1")
    interpret_pallas(monkeypatch, jfm)
    seen = _capture_cf_inputs(monkeypatch, jfmt)
    S = 64
    jparams, tparams = _port_params(4)
    ro, rd, vd, z, key, deltas, noise = _inputs(N, S)
    kw = dict(depth=4, width=W, multires=10, multires_views=4)
    ref = np.asarray(jfmt.fused_nerf_apply_rays(
        jparams, ro, rd, vd, z, dtype=jnp.float32, cull_bwd=True,
        fwd_cull=(jnp.asarray(key), jnp.asarray(deltas), jnp.asarray(noise),
                  EPS), **kw))

    T = torch.from_numpy
    pts_t = tfmt._points_t(T(ro), T(rd), T(z)).contiguous()
    xb, vb, aux, order = tfmt.cf_layout(pts_t, T(vd).T, T(key), T(deltas),
                                        T(noise), S)
    n_full = -(-N // 128) * 128
    np.testing.assert_array_equal(
        order.numpy(), np.asarray(jnp.argsort(jnp.pad(
            jnp.asarray(key), (0, n_full - N), constant_values=jnp.inf))))
    np.testing.assert_array_equal(xb.numpy(), seen["xb"])
    np.testing.assert_array_equal(aux.numpy(), seen["aux"])
    vb_groups = vb.reshape(3, n_full // 128, S // 16, 128)
    assert (vb_groups == vb_groups[:, :, :1]).all()
    np.testing.assert_array_equal(vb_groups[:, :, 0].reshape(3, -1).numpy(),
                                  seen["vt"])
    back = tfmt.cf_unlayout(torch.cat([xb, xb[:1]]), order, N, S)
    np.testing.assert_array_equal(back[:3].numpy(), pts_t.numpy())

    with torch.no_grad():
        out_b = tfmt.fused_nerf_fwd_cf(tparams, xb, vb, aux, S, 0.5 * EPS,
                                       dtype=torch.float32, **kw).numpy()
        got = tfmt.fused_nerf_apply_rays(
            tparams, T(ro), T(rd), T(vd), T(z), dtype=torch.float32,
            cull_bwd=True, fwd_cull=(T(key), T(deltas), T(noise), EPS),
            **kw).numpy()
    assert tfmt.fused_nerf_apply_rays.last_route == "cf"
    for a, b in ((seen["out_b"], out_b), (ref, got)):
        dead = a[3] == -1e10
        np.testing.assert_array_equal(b[3] == -1e10, dead)
        np.testing.assert_allclose(b[:, ~dead], a[:, ~dead], rtol=1e-4,
                                   atol=1e-5)
    blocks = (out_b[3].reshape(-1, 2048) == -1e10)
    assert (blocks.all(1) | ~blocks.any(1)).all()  # whole blocks skip
    if N % 128 == 0:
        assert blocks.all(1).mean() > 0.1, blocks.all(1).mean()


@pytest.mark.parametrize("N", [256, 100])
def test_cf_route_exact_against_dense(monkeypatch, N):
    """JAX ``test_fused_fwd_cull_exact``, mirrored on the port's twins: the
    composited outputs and the weight gradients of the early-terminating
    route equal the dense route's under the same ``cull_eps`` compositing,
    while a real share of blocks is skipped."""
    import torch

    from depth_lidar_nerf_tpu_torch.ops import fused_mlp_t as tfmt
    from depth_lidar_nerf_tpu_torch.ops.compositing import raw2outputs_t

    monkeypatch.setenv("DLNERF_CULL_FWD", "1")
    _, params = _port_params(4)
    T = torch.from_numpy
    ro, rd, vd, z, key, deltas, noise = (T(a) for a in _inputs(N, 64, 3))
    kw = dict(depth=4, width=W, multires=10, multires_views=4,
              dtype=torch.float32, cull_bwd=True)

    def run(fwd):
        for p in params.values():
            p.grad = None
        raw = tfmt.fused_nerf_apply_rays(
            params, ro, rd, vd, z, fwd_cull=(key, deltas, noise, EPS) if fwd
            else None, **kw)
        o = raw2outputs_t(raw, z, rd, raw_noise_std=0.5, cull_eps=EPS,
                          noise=noise)
        (torch.mean(o.rgb ** 2) + torch.mean(o.depth ** 2)
         + torch.mean(o.acc)).backward()
        return raw.detach(), o, {k: p.grad.clone() for k, p in params.items()}

    raw_c, o_c, g_c = run(True)
    assert tfmt.fused_nerf_apply_rays.last_route == "cf"
    raw_d, o_d, g_d = run(False)
    for a, b in ((o_c.rgb, o_d.rgb), (o_c.depth, o_d.depth),
                 (o_c.weights, o_d.weights)):
        np.testing.assert_allclose(a.detach().numpy(), b.detach().numpy(),
                                   rtol=1e-4, atol=1e-5)
    if N % 128 == 0:  # padded rays keep their group's blocks live
        assert float((raw_c[3] < -1e9).float().mean()) > 0.1
    grad_compare(g_d, g_c, 1e-4)


def _cf_render_pair(monkeypatch):
    """Both packages' ``render_rays`` with the early-terminating fine pass:
    coarse and fine D=4 / W=128 (kernel 9 has no skip variant), 64 + 64
    samples, ``cull_eps`` 1e-3, eval mode, the fine density bias raised so
    that rays terminate; the port's weights converted from JAX's."""
    import jax
    import jax.numpy as jnp

    from depth_lidar_nerf_tpu.train import config as jcfg
    from depth_lidar_nerf_tpu.train.state import build_models as jbuild
    from depth_lidar_nerf_tpu_torch.train import config as tcfg
    from depth_lidar_nerf_tpu_torch.train.state import build_models as tbuild
    from depth_lidar_nerf_tpu_torch.weights import params_from_jax

    monkeypatch.setenv("DLNERF_PALLAS_INTERPRET", "1")
    monkeypatch.setenv("DLNERF_CULL_FWD", "1")
    fields = dict(netdepth=4, netdepth_fine=4, netwidth=W, netwidth_fine=W,
                  N_samples=64, N_importance=64, use_viewdirs=True,
                  dataset_type="llff", cull_eps=EPS)
    jc = jcfg.TrainConfig(**fields)
    jr = jcfg.render_config_from(jc, 0, 0.0, 1.0).eval_mode()
    jm = jbuild(jc, jr)
    pe, ve = jnp.zeros((1, 63)), jnp.zeros((1, 27))
    params = {"coarse": jm.coarse.init(jax.random.key(0), pe, ve),
              "fine": jm.fine.init(jax.random.key(1), pe, ve)}
    for k, bias in (("coarse", 2.0), ("fine", 30.0)):
        sig = params[k]["params"]["sigma"]
        sig["bias"] = sig["bias"] + bias
    params = jax.tree.map(np.asarray, params)
    tc = tcfg.TrainConfig(**fields)
    tr = tcfg.render_config_from(tc, 0, 0.0, 1.0).eval_mode()
    tm = tbuild(tc, tr, device="cpu")
    sds = params_from_jax(params)
    tm.coarse.load_state_dict(sds["coarse"])
    tm.fine.load_state_dict(sds["fine"])
    return jm, params, jr, tm, tr


def test_render_rays_fwd_cull_matches_jax(monkeypatch):
    """``render_rays`` with ``DLNERF_CULL_FWD=1``: the fine pass takes the
    early-terminating forward in both packages (JAX
    ``test_render_rays_fwd_cull_matches_flax``, here against JAX itself),
    skips blocks, and the maps agree."""
    import jax.numpy as jnp
    import torch

    import depth_lidar_nerf_tpu.ops.fused_mlp_t as jfmt
    from depth_lidar_nerf_tpu.ops.rays import camera_rays as jrays
    from depth_lidar_nerf_tpu.render.renderer import make_rays as jmake
    from depth_lidar_nerf_tpu.render.renderer import render_rays as jrender
    from depth_lidar_nerf_tpu_torch.ops import fused_mlp_t as tfmt
    from depth_lidar_nerf_tpu_torch.ops.rays import camera_rays
    from depth_lidar_nerf_tpu_torch.render.renderer import (make_rays,
                                                            render_rays)
    from torch_port_helpers import assert_render_close

    jm, params, jr, tm, tr = _cf_render_pair(monkeypatch)
    seen = _capture_cf_inputs(monkeypatch, jfmt)
    cf_outs = []
    orig = tfmt.fused_nerf_fwd_cf

    def spy(*a, **k):
        cf_outs.append(orig(*a, **k))
        return cf_outs[-1]

    monkeypatch.setattr(tfmt, "fused_nerf_fwd_cf", spy)
    H, Wd, focal = 8, 16, 12.0
    c2w = look_at_pose(3)
    ro, rd = jrays(H, Wd, focal, jnp.asarray(c2w))
    ref = jrender(jm.coarse, jm.fine, params, jmake(ro, rd, jr, H, Wd, focal),
                  jr)
    to, td = camera_rays(H, Wd, focal, torch.from_numpy(c2w))
    with torch.no_grad():
        got = render_rays(tm.coarse, tm.fine, make_rays(to, td, tr, H, Wd,
                                                        focal), tr)
    assert "out_b" in seen and len(cf_outs) == 1
    skipped = (cf_outs[0][3].reshape(-1, 2048) == -1e10).all(1)
    np.testing.assert_array_equal(
        skipped.numpy(), (seen["out_b"][3].reshape(-1, 2048) == -1e10).all(1))
    assert skipped.any()
    assert np.asarray(ref["acc_map"]).max() > 0.1
    assert_render_close(ref, got, ("rgb_map", "acc_map", "depth_map",
                                   "weights", "rgb0", "acc0", "depth_map0"))


def _route(monkeypatch, *, depth=4, skips=(), S=64, eps=EPS, knob="1",
           save_acts=False, grad=True):
    """The port's route for one small pass, and the backward it ran."""
    import torch

    from depth_lidar_nerf_tpu_torch.ops import fused_mlp_t as tfmt
    from depth_lidar_nerf_tpu_torch.weights import mlp_state_dict

    monkeypatch.setenv("DLNERF_CULL_FWD", knob)
    calls = []
    spy_routes(monkeypatch, tfmt, calls)
    _, params = flax_mlp_params(depth, W, skips=skips)
    sd = {k: v.requires_grad_(grad) for k, v in mlp_state_dict(params).items()}
    T = torch.from_numpy
    ro, rd, vd, z, key, deltas, noise = (T(a) for a in _inputs(6, S, 1))
    raw = tfmt.fused_nerf_apply_rays(
        sd, ro, rd, vd, z, depth=depth, width=W, multires=10,
        multires_views=4, dtype=torch.float32, skips=skips, cull_bwd=True,
        save_acts=save_acts, fwd_cull=(key, deltas, noise, eps))
    if grad:
        raw.sum().backward()
    return tfmt.fused_nerf_apply_rays.last_route, calls


@pytest.mark.parametrize("bwd_cf,want", [("1", "_bwd_culled_dparams"),
                                         ("0", "_bwd_dense_dparams")])
@pytest.mark.parametrize("save_acts", [False, True])
def test_cf_route_and_its_backward(monkeypatch, save_acts, bwd_cf, want):
    """With the knob set, D=4 and ``cull_eps > 0`` the route is "cf", ahead
    of the saved-activation route; its backward is culled or dense by
    ``DLNERF_CULL_BWD_CF``."""
    monkeypatch.setenv("DLNERF_CULL_BWD_CF", bwd_cf)
    route, calls = _route(monkeypatch, save_acts=save_acts)
    assert route == "cf" and calls == [want]


@pytest.mark.parametrize("case", ["knob_off", "eps_zero", "live_skip",
                                  "short_rays", "no_grad"])
def test_cf_route_conditions(monkeypatch, case):
    """JAX's conditions (``_apply_rays_core``): never with the knob off, at
    ``cull_eps = 0``, with a live skip, or with fewer than 16 samples; and
    without a gradient too, as JAX's primal."""
    kw, want = {"knob_off": (dict(knob="0"), "culled"),
                "eps_zero": (dict(eps=0.0), "culled"),
                "live_skip": (dict(depth=6, skips=(2,)), "culled"),
                "short_rays": (dict(S=8), "dense"),
                "no_grad": (dict(grad=False), "cf")}[case]
    assert _route(monkeypatch, **kw)[0] == want
