"""The port's patch-loss training step against JAX ``make_train_step(...,
feature_on=, smooth_on=)`` (Pallas kernels in the interpreter): the patch
rays, the scatter of the two legs, the table rows of a crop, whole patch
steps (VGG feature + smoothness, semantic, grid, the int8 no-grad leg) from
the same weights, crop, permutation and ray indices, and the variant plan.

Tolerances are the step tests' (``test_torch_port_train_step.py``): metrics
rtol 1e-4, updated parameters rtol 1e-4 with atol 2.5e-5, Adam moments rtol
1e-3; float32 outputs rtol 1e-4, gradients rtol 1e-3.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from depth_lidar_nerf_tpu.ops import rays as jrays
from depth_lidar_nerf_tpu.train import step as jstep
from depth_lidar_nerf_tpu_torch.ops import rays as trays
from depth_lidar_nerf_tpu_torch.train import step as tstep
from torch_port_patch_helpers import patch_pair, patch_step_against_jax

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.mark.parametrize("crop", [(0, 0, 8, 12), (3, 5, 8, 12),
                                  (10, 37, 94, 352)])
def test_patch_ray_dirs_match_jax(crop):
    from torch_port_helpers import look_at_pose

    sh, sw, nH, nW = crop
    H, W, focal = 104, 390, 88.0
    c2w = look_at_pose(3)
    jo, jd = jrays.patch_ray_dirs(H, W, focal, jnp.asarray(c2w),
                                  jnp.float32(sh), jnp.float32(sw), nH, nW)
    to, td = trays.patch_ray_dirs(H, W, focal, torch.from_numpy(c2w),
                                  torch.tensor(sh), torch.tensor(sw), nH, nW)
    assert td.shape == (nH, nW, 3) and to.shape == (nH, nW, 3)
    np.testing.assert_allclose(td.numpy(), np.asarray(jd), rtol=1e-4,
                               atol=1e-6)
    np.testing.assert_array_equal(to.numpy(), np.asarray(jo))


def _closure(fn, name):
    """The function ``name`` that ``fn``'s closures (and theirs) hold."""
    seen, todo = set(), [fn]
    while todo:
        f = todo.pop()
        if id(f) in seen or not callable(f):
            continue
        seen.add(id(f))
        f = getattr(f, "__wrapped__", f)
        for var, cell in zip(getattr(f, "__code__", None).co_freevars
                             if hasattr(f, "__code__") else (),
                             f.__closure__ or ()):
            if var == name:
                return cell.cell_contents
            todo.append(cell.cell_contents)
    raise LookupError(name)


def test_assemble_patch_and_its_gradient_match_jax():
    """The two legs' values scatter into scan-line order as JAX's; the
    gradient reaches only the grad leg's values, and equals JAX's there."""
    rng = np.random.default_rng(0)
    nH, nW, n_grad = 6, 10, 16
    perm = rng.permutation(nH * nW)
    vg = rng.normal(size=(2, n_grad, 3)).astype(np.float32)
    vn = rng.normal(size=(2, nH * nW - n_grad, 3)).astype(np.float32)
    cot = rng.normal(size=(2, nH, nW, 3)).astype(np.float32)

    def jf(g):
        return jnp.sum(jstep._assemble_patch(g, jnp.asarray(vn),
                                             jnp.asarray(perm), n_grad, nH,
                                             nW) * cot)

    jout = jstep._assemble_patch(jnp.asarray(vg), jnp.asarray(vn),
                                 jnp.asarray(perm), n_grad, nH, nW)
    g = torch.from_numpy(vg).requires_grad_()
    n = torch.from_numpy(vn).requires_grad_()
    tout = tstep._assemble_patch(g, n, torch.from_numpy(perm), n_grad, nH, nW)
    np.testing.assert_array_equal(tout.detach().numpy(), np.asarray(jout))
    (tout * torch.from_numpy(cot)).sum().backward()
    np.testing.assert_allclose(g.grad.numpy(),
                               np.asarray(jax.grad(jf)(jnp.asarray(vg))),
                               rtol=1e-3)
    assert n.grad is None  # the no-grad leg's values are detached


def test_patch_rows_match_jax():
    """The rgb table's rows of a crop, in the permutation's order, against
    the closure JAX's grid patch step uses."""
    from depth_lidar_nerf_tpu.train.config import TrainConfig as JCfg
    from depth_lidar_nerf_tpu.train.config import render_config_from

    H, W = 12, 16
    cfg = JCfg(nH=8, nW=12, gradH=2, gradW=4, depth_inverse_loss=True,
               grid_train=True, N_importance=8, N_samples=8)
    rcfg = render_config_from(cfg, 0, 0.0, 1.0)
    fn = jstep.make_train_step(cfg, rcfg, None, (H, W, 14.0), grid_mode=True,
                               smooth_on=True, _jit=False)
    j_rows = _closure(fn, "_patch_rows")
    rng = np.random.default_rng(1)
    for img, sh, sw in ((0, 0, 0), (1, 4, 4), (2, 3, 1)):
        perm = rng.permutation(96)
        jp = jstep.PatchBatch(None, None, jnp.float32(sh), jnp.float32(sw),
                              jnp.asarray(perm, jnp.int32), jnp.int32(img))
        tp = tstep.PatchBatch(None, None, torch.tensor(sh), torch.tensor(sw),
                              torch.from_numpy(perm), torch.tensor(img))
        np.testing.assert_array_equal(
            tstep._patch_rows(tp, H, W, 8, 12).numpy(),
            np.asarray(j_rows(jp)))


def test_clip_splits_the_gradient_at_ties_as_jnp_clip():
    """``jnp.clip`` is ``minimum(maximum(x, 0), 1)``: at x = 0 or 1 half the
    gradient passes, where ``torch.clamp`` would pass all of it."""
    x = np.array([-0.5, 0.0, 0.3, 1.0, 1.5], np.float32)
    want = np.asarray(jax.grad(lambda v: jnp.sum(jnp.clip(v, 0.0, 1.0)))(
        jnp.asarray(x)))
    t = torch.from_numpy(x).requires_grad_()
    tstep._clip01(t).sum().backward()
    np.testing.assert_array_equal(t.grad.numpy(), want)
    assert want[1] == want[3] == 0.5


def test_feature_smooth_patch_step_matches_jax(monkeypatch):
    """The KITTI stack's patch iteration at a tiny size: two MLPs, the VGG
    content loss (conv1_2, conv2_2, l1) on both passes' crops and the
    inverse-depth smoothness, one step against JAX's."""
    t = patch_pair(monkeypatch, feature_on=True, smooth_on=True)
    tm, _ = patch_step_against_jax(t)
    assert {"inv_loss", "feature_loss", "feature_loss0"} <= set(tm)


def test_semantic_patch_step_matches_jax(monkeypatch):
    """The same with a 19-class semantic head on both MLPs (fine D=8
    skip@4) and the semantic loss: both legs go through the semantic
    kernels' twins."""
    t = patch_pair(monkeypatch, feature_on=True, smooth_on=True,
                   semantic=True)
    tm, _ = patch_step_against_jax(t)
    assert {"semantic_loss", "inv_loss", "feature_loss"} <= set(tm)


def test_grid_patch_step_matches_jax(monkeypatch):
    """Grid mode (``grid_train_fine_only``, ``patch_render_samples`` 32):
    the patch legs render the fine pass from the crop's baked rows; no
    coarse leg, so no ``feature_loss0`` (JAX
    ``tests/test_grid_train.py:152-215``)."""
    t = patch_pair(monkeypatch, feature_on=True, smooth_on=True, grid=True,
                   grid_train_fine_only=True, patch_render_samples=32)
    tm, _ = patch_step_against_jax(t)
    assert "feature_loss0" not in tm and "img_loss0" not in tm


def test_patch_ng_int8_route_matches_jax(monkeypatch):
    """With ``patch_ng_int8`` the no-grad leg takes the int8 forward (kernel
    10's twin), on both passes of its one tile, in both packages; the grad
    leg and the base render do not. The step then matches JAX's: both
    quantize bit for bit alike (``test_torch_port_q8_f32.py``)."""
    from depth_lidar_nerf_tpu.train import state as jstate
    from depth_lidar_nerf_tpu_torch.train import state as tstate

    calls = {"jax": 0, "port": 0}
    for key, cls in (("jax", jstate.FusedMLP), ("port", tstate.FusedMLP)):
        orig = cls.apply_rays_q8

        def spy(self, *a, _orig=orig, _key=key, **k):
            calls[_key] += 1
            return _orig(self, *a, **k)

        monkeypatch.setattr(cls, "apply_rays_q8", spy)
    t = patch_pair(monkeypatch, smooth_on=True, patch_ng_int8=True)
    patch_step_against_jax(t)
    assert calls == {"jax": 2, "port": 2}


def test_oversized_patch_is_refused():
    from depth_lidar_nerf_tpu_torch.train.config import (TrainConfig,
                                                         render_config_from)

    cfg = TrainConfig(nH=64, nW=16, gradH=4, gradW=4, depth_inverse_loss=True)
    rcfg = render_config_from(cfg, 0, 0.0, 1.0)
    with pytest.raises(ValueError, match="larger than image"):
        tstep.make_train_step(cfg, rcfg, None, (24, 32, 30.0), smooth_on=True)
    with pytest.raises(ValueError, match="larger than image"):
        tstep.build_step_fns(cfg, rcfg, None, (24, 32, 30.0))
    # The GAN step is refused the same way, and without a discriminator.
    with pytest.raises(ValueError, match="larger than image"):
        tstep.make_train_step(cfg, rcfg, None, (24, 32, 30.0), gan_on=True)
    with pytest.raises(ValueError, match="needs the discriminator"):
        tstep.make_train_step(cfg, rcfg, None, (94, 352, 88.0), gan_on=True)


def test_variant_key_matches_jax_on_the_flagship_schedule():
    """``variant_key(i)`` is JAX's tuple for i = 0..60 on
    ``configs/flagship_synthetic.txt``'s schedule, and with grid training
    switched on past step 30; ``select`` caches one step a key."""
    from depth_lidar_nerf_tpu.train import config as jcfg
    from depth_lidar_nerf_tpu_torch.train import config as tcfg

    argv = ["--config", os.path.join(REPO, "configs", "flagship_synthetic.txt")]
    for extra in ([], ["--grid_train", "True", "--grid_train_after", "30"]):
        jc, tc = jcfg.parse_args(argv + extra), tcfg.parse_args(argv + extra)
        jr = jcfg.render_config_from(jc, 4, 0.0, 1.0)
        tr = tcfg.render_config_from(tc, 4, 0.0, 1.0)
        jplan = jstep.build_step_fns(jc, jr, None, (94, 352, 88.0))
        tplan = tstep.build_step_fns(tc, tr, None, (94, 352, 88.0))
        keys = [tplan.variant_key(i) for i in range(61)]
        assert keys == [jplan.variant_key(i) for i in range(61)]
        assert sum(k[0] and k[2] for k in keys) == 6  # i = 10, 20, ..., 60
        assert keys[10][:3] == (True, False, True) and keys[11][:3] == (
            False, False, False)
    tplan = tstep.build_step_fns(
        tc.replace(semantic_loss=False, feature_loss=False), tr, None,
        (94, 352, 88.0))
    step_a, patch_a = tplan.select(10)
    step_b, patch_b = tplan.select(20)
    assert step_a is step_b and patch_a and patch_b
    assert tplan.select(11)[0] is not step_a and not tplan.select(11)[1]


def test_feature_step_runs_cudnn_deterministic_and_restores_the_flag():
    """A feature-loss step runs the perceptual model under cuDNN's
    deterministic algorithms (the default backward accumulates with atomics
    on the card, so runs from one state would part) and gives the caller's
    setting back; a step without the feature loss leaves it alone. The
    patch comes from a ``PatchSource``, drawn by ``sample_patch``."""
    from depth_lidar_nerf_tpu_torch.data.synthetic import draw_scene
    from depth_lidar_nerf_tpu_torch.train.config import (TrainConfig,
                                                         render_config_from)
    from depth_lidar_nerf_tpu_torch.train.state import (build_models,
                                                        init_train_state)
    from depth_lidar_nerf_tpu_torch.train.tables import (build_depth_table,
                                                         build_rgb_table)

    sc = draw_scene(n_images=2, H=12, W=16, focal=14.0, n_depth_points=40)
    cfg = TrainConfig(N_rand=32, N_samples=8, N_importance=8, netdepth=2,
                      netwidth=32, netdepth_fine=2, netwidth_fine=32,
                      no_ndc=True, colmap_depth=True, depth_loss=True,
                      feature_loss=True, vgg_layers=["conv1_2"],
                      vgg_layer_weights=[1.0], datadir="/nonexistent",
                      use_fused_mlp=False, nH=8, nW=12, gradH=2, gradW=4)
    rcfg = render_config_from(cfg, 0, sc.near, sc.far)
    models = build_models(cfg, rcfg, device="cpu")
    state = init_train_state(cfg, models)
    tabs = (build_rgb_table(sc.images, sc.poses, range(2), *sc.hwf, rcfg,
                            device="cpu"),
            build_depth_table(sc.depth_gts, sc.poses, range(2), *sc.hwf, rcfg,
                              device="cpu"))
    src = tstep.PatchSource(torch.as_tensor(sc.images, dtype=torch.float32),
                            torch.as_tensor(sc.poses, dtype=torch.float32))
    seen = []
    models.vgg.register_forward_pre_hook(
        lambda m, a: seen.append(torch.backends.cudnn.deterministic))
    gen = torch.Generator().manual_seed(0)
    before = torch.backends.cudnn.deterministic
    m = tstep.make_train_step(cfg, rcfg, models, sc.hwf, feature_on=True)(
        state, *tabs, gen, patch=src)
    assert seen == [True, True] and "feature_loss" in m
    assert torch.backends.cudnn.deterministic == before
    tstep.make_train_step(cfg, rcfg, models, sc.hwf, smooth_on=True)(
        state, *tabs, gen, patch=src)
    assert seen == [True, True] and state.step == 2
    with pytest.raises(ValueError, match="patch="):
        tstep.make_train_step(cfg, rcfg, models, sc.hwf, smooth_on=True)(
            state, *tabs, gen)
