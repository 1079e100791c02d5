"""The serving modes that compose with int8 serving, on the CPU against the
JAX package: the renderer's int8 dispatch (``_composite_from_z``), its route
predicates (``supports_rays_shape``, the saved-activation cap, which the
int8 semantic pass skips), ``render_rays`` with ``render_fine_only``,
``render_image`` with ``render_coarse_downsample``, and the config plumbing
(``render_config_from``, ``eval_render_config``, ``render_path``).

Tolerances. Routes exactly. Renders on the float32 kernel twins
as ``assert_render_close`` (rtol 1e-4, atol 1e-5), the ray-summed logits at
rtol 1e-4 and atol 1e-3. Renders through the int8 twins on
``torch_port_q8_helpers.q8_gaps``'s max over max and mean over mean, within
1.1e-3 and 6e-4: about 3x the largest gaps measured (3.5e-4 and 1.9e-4, in
the weights of a fine-only pass). A composited value sums 64-128 samples, so
nearly every pixel carries one of the raw outputs that an activation rounded
to the other int8 value moved; the share of such pixels is not held. The
int8 semantic logits relative to their scale within the forward test's
limits, 1.5e-4 and 3e-5 (``test_torch_port_q8_f32.py``; these inputs flip
no activation, and the gap measured is 1.7e-7)."""

import dataclasses

import numpy as np
import pytest
import torch

from torch_port_helpers import (assert_render_close, look_at_pose, ray_batch,
                                render_pair)
from torch_port_q8_helpers import q8_gaps
from torch_port_semantic_helpers import sem_render_pair

INT8_LIMITS = (1.1e-3, 6e-4)
INT8_LOGIT_LIMITS = (1.5e-4, 3e-5)


def _assert_int8_close(ref, got, keys, limits=INT8_LIMITS):
    for k in keys:
        a, b = np.asarray(ref[k]), got[k].numpy()
        assert a.shape == b.shape, (k, a.shape, b.shape)
        gaps = q8_gaps(b, a)[:2]
        assert all(g <= lim for g, lim in zip(gaps, limits)), (k, gaps)


def _spy(monkeypatch, cls, names, calls):
    for name in names:
        orig = getattr(cls, name)

        def spy(self, *a, _orig=orig, _name=name, **k):
            calls.append(_name)
            return _orig(self, *a, **k)

        monkeypatch.setattr(cls, name, spy)


def _rays(N, S, seed=3):
    ro, rd, vd, z = ray_batch(N, S, seed=seed)
    near = np.full((N, 1), 2.0, np.float32)
    far = np.full((N, 1), 6.0, np.float32)
    return (ro, rd, vd, near, far), z


@pytest.mark.parametrize("S,int8,route", [(64, True, "apply_rays_q8"),
                                          (64, False, "apply_rays"),
                                          (96, True, None), (96, False, None)])
def test_composite_route_matches_jax(monkeypatch, S, int8, route):
    """``render_int8`` takes kernel 10 for an RGB pass in both packages; an
    S that does not divide 2,048 into at most 128 rays (96) takes the plain
    module in both, with int8 or without (the port's predicate gained JAX's
    ``supports_rays_shape``)."""
    import jax.numpy as jnp

    from depth_lidar_nerf_tpu.render import renderer as jrend
    from depth_lidar_nerf_tpu.train.state import FusedMLP as JFused
    from depth_lidar_nerf_tpu_torch.render import renderer as trend
    from depth_lidar_nerf_tpu_torch.train.state import FusedMLP

    jm, params, jr, tm, tr = render_pair(monkeypatch, False)
    names = ("apply_rays_q8", "apply_rays")
    jcalls, tcalls = [], []
    _spy(monkeypatch, JFused, names, jcalls)
    _spy(monkeypatch, FusedMLP, names, tcalls)
    jc = dataclasses.replace(jr, render_int8=int8)
    tc = dataclasses.replace(tr, render_int8=int8)
    rays, z = _rays(8, S)
    ref = jrend._composite_from_z(
        jm.coarse, params["coarse"],
        jrend.Rays(*(jnp.asarray(a) for a in rays)), jnp.asarray(z), jc, None)
    with torch.no_grad():
        got = trend._composite_from_z(
            tm.coarse, trend.Rays(*(torch.from_numpy(a) for a in rays)),
            torch.from_numpy(z), tc, None)
    assert jcalls == tcalls == ([route] if route else [])
    assert trend._fused_ok(tm.coarse, tc, S) == (S == 64)
    ref = {k: getattr(ref, k) for k in ("rgb", "acc", "depth", "weights")}
    got = {k: getattr(got, k) for k in ref}
    if int8 and route:
        _assert_int8_close(ref, got, ref)
    else:
        assert_render_close(ref, got, ref)


@pytest.mark.parametrize("int8", [True, False])
def test_semantic_int8_skips_the_acts_cap(monkeypatch, int8):
    """A semantic pass beyond the saved-activation cap (lowered to 100
    points in both packages) takes the plain module, as in JAX; with
    ``render_int8`` it takes kernel 11 in both, since the int8 pass saves no
    activations (``n_points=0``), and ``fused_eval_ready`` agrees."""
    import jax.numpy as jnp

    import depth_lidar_nerf_tpu.ops.fused_mlp_t as jfmt
    from depth_lidar_nerf_tpu.render import renderer as jrend
    from depth_lidar_nerf_tpu.train.state import FusedMLP as JFused
    from depth_lidar_nerf_tpu_torch.ops import fused_mlp_t as tfmt
    from depth_lidar_nerf_tpu_torch.render import renderer as trend
    from depth_lidar_nerf_tpu_torch.train.state import FusedMLP

    jm, params, jr, tm, tr = sem_render_pair(monkeypatch)
    for mod in (jfmt, tfmt):
        monkeypatch.setattr(mod, "acts_points_cap", lambda *a, **k: 100)
    names = ("apply_rays_semantic_q8", "apply_rays_semantic")
    jcalls, tcalls = [], []
    _spy(monkeypatch, JFused, names, jcalls)
    _spy(monkeypatch, FusedMLP, names, tcalls)
    jc = dataclasses.replace(jr, render_int8=int8)
    tc = dataclasses.replace(tr, render_int8=int8)
    rays, z = _rays(8, 64)
    ref = jrend._composite_from_z(
        jm.coarse, params["coarse"],
        jrend.Rays(*(jnp.asarray(a) for a in rays)), jnp.asarray(z), jc, None)
    with torch.no_grad():
        got = trend._composite_from_z(
            tm.coarse, trend.Rays(*(torch.from_numpy(a) for a in rays)),
            torch.from_numpy(z), tc, None)
    assert jcalls == tcalls == (["apply_rays_semantic_q8"] if int8 else [])
    assert trend.fused_eval_ready(tm.coarse, tm.fine, tc, 8) == int8 == \
        jrend.fused_eval_ready(jm.coarse, jm.fine, params, jc, 8)
    keys = ("rgb", "acc", "depth", "weights")
    ref_m = {k: getattr(ref, k) for k in keys}
    got_m = {k: getattr(got, k) for k in keys}
    if int8:
        _assert_int8_close(ref_m, got_m, keys)
        _assert_int8_close({"s": ref.semantic}, {"s": got.semantic}, "s",
                           INT8_LOGIT_LIMITS)
    else:
        assert_render_close(ref_m, got_m, keys)
        np.testing.assert_allclose(got.semantic.numpy(),
                                   np.asarray(ref.semantic), rtol=1e-4,
                                   atol=1e-3)


def test_int8_paths_raise_under_autograd():
    """The int8 forwards have no backward: under autograd with parameters
    that require a gradient every entry point raises, the renderer's
    included; without a gradient they run."""
    from depth_lidar_nerf_tpu_torch.ops import fused_mlp_t as f
    from depth_lidar_nerf_tpu_torch.render.renderer import (RenderConfig,
                                                            Rays, render_rays)
    from depth_lidar_nerf_tpu_torch.train.state import FusedMLP

    m = FusedMLP(depth=2, width=128, num_semantic_classes=3)
    params = dict(m.named_parameters())
    trunk = {k: v for k, v in params.items() if not k.startswith("semantic")}
    (ro, rd, vd, near, far), z = _rays(4, 16)
    ro, rd, vd, near, far, z = (torch.from_numpy(a) for a in
                                (ro, rd, vd, near, far, z))
    kw = dict(depth=2, width=128, multires=10, multires_views=4)
    pts = torch.rand(3, 64)
    vt = torch.nn.functional.normalize(torch.ones(3, 4), dim=0)
    calls = [lambda: f.fused_nerf_apply_rays_q8(trunk, ro, rd, vd, z, **kw),
             lambda: f.fused_nerf_apply_rays_semantic_q8(params, ro, rd, vd, z,
                                                         **kw),
             lambda: f.fused_nerf_fwd_q8(trunk, pts, vt, 16, **kw),
             lambda: f.fused_nerf_fwd_q8_sem(params, pts, vt, 16, **kw),
             lambda: m.apply_rays_semantic_q8(Rays(ro, rd, vd, near, far), z,
                                              RenderConfig())]
    for call in calls:
        with pytest.raises(RuntimeError, match="eval only"):
            call()
    with torch.no_grad():
        for call in calls:
            call()
    cfg = RenderConfig(N_samples=16, N_importance=0, perturb=False,
                       render_int8=True, num_semantic_classes=3)
    with pytest.raises(RuntimeError, match="eval only"):
        render_rays(m, None, Rays(ro, rd, vd, near, far), cfg)


@pytest.mark.parametrize("mode", ["float32", "int8", "semantic"])
def test_render_rays_fine_only_matches_jax(monkeypatch, mode):
    """``render_fine_only``: the fine pass evaluates only the sorted
    importance samples, in both packages (the semantic stack keeps
    ``sem_preds0``); ``fused_eval_ready`` checks the fine pass at
    ``N_importance`` samples."""
    import jax.numpy as jnp

    from depth_lidar_nerf_tpu.render import renderer as jrend
    from depth_lidar_nerf_tpu_torch.render import renderer as trend

    pair = sem_render_pair if mode == "semantic" else render_pair
    jm, params, jr, tm, tr = (pair(monkeypatch) if mode == "semantic"
                              else pair(monkeypatch, False))
    jc = dataclasses.replace(jr, render_fine_only=True,
                             render_int8=mode == "int8")
    tc = dataclasses.replace(tr, render_fine_only=True,
                             render_int8=mode == "int8")
    N = 8
    rays, _ = _rays(N, 4)
    if mode != "semantic":  # the NDC stack renders [0, 1]
        rays = rays[:3] + (np.zeros((N, 1), np.float32),
                           np.ones((N, 1), np.float32))
    ref = jrend.render_rays(jm.coarse, jm.fine, params,
                            jrend.Rays(*(jnp.asarray(a) for a in rays)), jc)
    with torch.no_grad():
        got = trend.render_rays(tm.coarse, tm.fine,
                                trend.Rays(*(torch.from_numpy(a) for a in rays)),
                                tc)
    assert set(got) == set(ref)
    assert got["weights"].shape == (N, tc.N_importance)
    keys = ("rgb_map", "acc_map", "depth_map", "weights", "rgb0", "acc0",
            "depth_map0", "z_std")
    if mode == "int8":
        _assert_int8_close(ref, got, keys)
    else:
        assert_render_close(ref, got, keys)
    if mode == "semantic":
        for k in ("sem_preds", "sem_preds0"):
            np.testing.assert_allclose(got[k].numpy(), np.asarray(ref[k]),
                                       rtol=1e-4, atol=1e-3, err_msg=k)
    # N_samples 32 + N_importance 64: the union (96) is refused by the
    # 2,048-point tile rule, the fine-only pass (64) is not.
    for fine_only in (False, True):
        jc2 = dataclasses.replace(jc, N_samples=32, render_fine_only=fine_only)
        tc2 = dataclasses.replace(tc, N_samples=32, render_fine_only=fine_only)
        assert trend.fused_eval_ready(tm.coarse, tm.fine, tc2, 64) == \
            jrend.fused_eval_ready(jm.coarse, jm.fine, params, jc2, 64) == \
            fine_only


@pytest.mark.parametrize("int8", [False, True])
def test_render_image_coarse_downsampled_matches_jax(monkeypatch, int8):
    """``render_coarse_downsample=2`` on an 8 x 12 frame: every key of JAX's
    result, the upsampled coarse maps included; a ragged ``tile=40`` gives
    the frame of one tile; k not dividing H raises ``ValueError`` from the
    downsampled renderer, and ``render_image`` then renders the full path."""
    import jax.numpy as jnp

    from depth_lidar_nerf_tpu.render.renderer import render_image as jimage
    from depth_lidar_nerf_tpu_torch.render import renderer as trend

    jm, params, jr, tm, tr = render_pair(monkeypatch, False)
    jc = dataclasses.replace(jr, render_coarse_downsample=2, render_int8=int8)
    tc = dataclasses.replace(tr, render_coarse_downsample=2, render_int8=int8)
    H, W, focal = 8, 12, 10.0
    c2w = look_at_pose(5)
    ref = jimage(jm.coarse, jm.fine, params, H, W, focal, jnp.asarray(c2w), jc)
    got = trend.render_image(tm.coarse, tm.fine, H, W, focal, c2w, tc,
                             device="cpu")
    assert set(got) == set(ref) == {"rgb_map", "disp_map", "acc_map",
                                    "depth_map", "rgb0", "depth_map0", "acc0"}
    assert got["rgb0"].shape == (H, W, 3) and got["acc0"].shape == (H, W)
    keys = ("rgb_map", "acc_map", "depth_map", "disp_map", "rgb0",
            "depth_map0", "acc0")
    if int8:
        _assert_int8_close(ref, got, keys)
    else:
        assert_render_close(ref, got, keys)
    tiled = trend.render_image(tm.coarse, tm.fine, H, W, focal, c2w, tc,
                               tile=40, device="cpu")
    for k in got:
        torch.testing.assert_close(tiled[k], got[k], rtol=0, atol=1e-6)
    with pytest.raises(ValueError, match="render_coarse_downsample=2"):
        trend.render_image_coarse_downsampled(tm.coarse, tm.fine, 9, W, focal,
                                              c2w, tc, device="cpu")
    full = trend.render_image(tm.coarse, tm.fine, 9, W, focal, c2w, tc,
                              device="cpu")
    assert "weights" in full and full["rgb_map"].shape == (9, W, 3)


def test_render_path_reaches_the_downsampled_renderer(monkeypatch):
    """``render_path`` with the eval config of ``--render_coarse_downsample
    2 --render_int8`` renders each pose through
    ``render_image_coarse_downsampled``."""
    from depth_lidar_nerf_tpu_torch.render import renderer as trend
    from depth_lidar_nerf_tpu_torch.train.config import (TrainConfig,
                                                         eval_render_config,
                                                         render_config_from)
    from depth_lidar_nerf_tpu_torch.train.loop import render_path
    from depth_lidar_nerf_tpu_torch.train.state import build_models

    cfg = TrainConfig(netdepth=4, netdepth_fine=8, netwidth=128,
                      netwidth_fine=128, N_samples=16, N_importance=16,
                      use_viewdirs=True, dataset_type="llff",
                      render_coarse_downsample=2, render_int8=True)
    rcfg = eval_render_config(cfg, render_config_from(cfg, 0, 0.0, 1.0))
    models = build_models(cfg, rcfg, device="cpu")
    calls = []
    orig = trend.render_image_coarse_downsampled
    monkeypatch.setattr(trend, "render_image_coarse_downsampled",
                        lambda *a, **k: calls.append(1) or orig(*a, **k))
    poses = np.stack([look_at_pose(s) for s in (1, 2)])
    rgbs, disps = render_path(models, poses, (6, 8, 7.0), rcfg, device="cpu")
    assert len(calls) == 2 and rgbs.shape == (2, 6, 8, 3)
    want = orig(models.coarse, models.fine, 6, 8, 7.0, poses[1], rcfg,
                device="cpu")
    np.testing.assert_array_equal(rgbs[1], want["rgb_map"].numpy())
    np.testing.assert_array_equal(disps[1], want["disp_map"].numpy())


def test_render_config_flags_match_jax():
    """``render_config_from`` leaves the three serving flags off the training
    config, as JAX's does; ``eval_render_config`` sets them (JAX
    ``train/loop.py:588-598``); the grid modes and the int8 patch leg still
    raise; fine-only serving needs a fine pass."""
    from depth_lidar_nerf_tpu.train import config as jcfg
    from depth_lidar_nerf_tpu_torch.render.renderer import RenderConfig
    from depth_lidar_nerf_tpu_torch.train import config as tcfg
    from depth_lidar_nerf_tpu_torch.train.state import build_models
    from depth_lidar_nerf_tpu_torch.train.step import make_train_step

    flags = dict(render_int8=True, render_fine_only=True,
                 render_coarse_downsample=2)
    jr = jcfg.render_config_from(jcfg.TrainConfig(N_importance=64, **flags),
                                 0, 2.0, 6.0)
    tc = tcfg.TrainConfig(N_importance=64, **flags)
    tr = tcfg.render_config_from(tc, 0, 2.0, 6.0)
    assert (tr.render_int8, tr.render_fine_only,
            tr.render_coarse_downsample) == (False, False, 0)
    te = tcfg.eval_render_config(tc, tr)
    je = dataclasses.replace(jr, **flags)
    assert dataclasses.asdict(te) == {k: v for k, v in
                                      dataclasses.asdict(je).items()
                                      if k in dataclasses.asdict(te)}
    assert tcfg.eval_render_config(tcfg.TrainConfig(), tr) == tr
    assert tcfg.eval_render_config(
        tcfg.TrainConfig(render_coarse_downsample=1), tr) == tr
    for bad in (dict(render_grid=64), dict(render_grid_fine_only=True),
                dict(render_grid_samples=128)):
        with pytest.raises(NotImplementedError, match=next(iter(bad))):
            tcfg.render_config_from(tcfg.TrainConfig(**bad), 0, 2.0, 6.0)
        with pytest.raises(NotImplementedError, match=next(iter(bad))):
            tcfg.eval_render_config(tcfg.TrainConfig(**bad), RenderConfig())
    with pytest.raises(ValueError, match="render_fine_only"):
        tcfg.eval_render_config(
            tcfg.TrainConfig(render_fine_only=True, N_importance=0), tr)
    cfg = tcfg.TrainConfig(netdepth=2, netdepth_fine=2, netwidth=128,
                           netwidth_fine=128, patch_ng_int8=True)
    models = build_models(cfg, tr, device="cpu")
    with pytest.raises(NotImplementedError, match="patch_ng_int8"):
        make_train_step(cfg, tr, models, (4, 4, 4.0))
