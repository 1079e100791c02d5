"""The port's single-image batching (``no_batching``, ``precrop_iters``,
``precrop_frac``; ``run_nerf.py:1376-1404``) against the JAX package on the
CPU: where the draws fall, the step on JAX's own indices against JAX
``make_train_step(..., precrop_on=)``, the variant plan, and the driver
(JAX ``tests/test_train_e2e.py:193``).

Tolerances are the step tests' (``test_torch_port_train_step.py``):
metrics rtol 1e-4, updated parameters rtol 1e-4 with atol 2.5e-5, Adam
moments rtol 1e-3.
"""

import numpy as np
import pytest
import torch

from test_torch_port_driver import _cfg, _train
from torch_port_patch_helpers import patch_pair, patch_step_against_jax


def _jax_no_batching_indices(precrop_on, H, W, frac):
    """The ray indices JAX's ``no_batching`` step draws from its step key:
    ``keys = split(split(rng, 3)[1], 8)``, the image, rows and columns from
    ``split(keys[0], 3)``, the depth rays uniform from ``keys[1]``."""
    import jax

    def indices(rng, n_rgb, n_depth, m_rgb, m_depth):
        keys = jax.random.split(jax.random.split(rng, 3)[1], 8)
        ki, kr, kc = jax.random.split(keys[0], 3)
        img = jax.random.randint(ki, (), 0, m_rgb // (H * W))
        if precrop_on:
            dH, dW = int(H // 2 * frac), int(W // 2 * frac)
            rows = jax.random.randint(kr, (n_rgb,), H // 2 - dH, H // 2 + dH)
            cols = jax.random.randint(kc, (n_rgb,), W // 2 - dW, W // 2 + dW)
        else:
            rows = jax.random.randint(kr, (n_rgb,), 0, H)
            cols = jax.random.randint(kc, (n_rgb,), 0, W)
        idx = img * (H * W) + rows * W + cols
        idx_d = jax.random.randint(keys[1], (n_depth,), 0, m_depth)
        return np.asarray(idx), np.asarray(idx_d)

    return indices


@pytest.mark.parametrize("precrop_on", [True, False])
def test_no_batching_step_matches_jax(monkeypatch, precrop_on):
    """One ``no_batching`` step on JAX's indices (one image; with precrop
    the central half) against JAX's step of the same variant."""
    t = patch_pair(monkeypatch, precrop_on=precrop_on, no_batching=True,
                   precrop_iters=10, precrop_frac=0.5)
    H, W, _ = t["scene"].hwf
    ind = _jax_no_batching_indices(precrop_on, H, W, 0.5)
    j_rgb, j_dep = t["jax_tables"]
    import jax

    idx, _ = ind(jax.random.key(300), 32, 32, j_rgb.origins.shape[0],
                 j_dep.origins.shape[0])
    assert len(set(idx // (H * W))) == 1
    patch_step_against_jax(t, indices=ind)


def _step_rows(monkeypatch, cfg, n_steps, precrop_on):
    """The RGB ray indices the port's ``no_batching`` step draws from its
    generator over ``n_steps`` steps, caught at the table gather."""
    from depth_lidar_nerf_tpu_torch.data.synthetic import draw_scene
    from depth_lidar_nerf_tpu_torch.train import step as tstep
    from depth_lidar_nerf_tpu_torch.train.config import render_config_from
    from depth_lidar_nerf_tpu_torch.train.state import (build_models,
                                                        init_train_state)
    from depth_lidar_nerf_tpu_torch.train.tables import build_rgb_table

    sc = draw_scene(n_images=3, H=20, W=28, focal=20.0)
    rcfg = render_config_from(cfg, 0, sc.near, sc.far)
    state = init_train_state(cfg, build_models(cfg, rcfg, device="cpu"))
    table = build_rgb_table(sc.images, sc.poses, range(3), *sc.hwf, rcfg,
                            device="cpu")
    seen = []
    orig = tstep.gather_rays

    def spy(tab, idx, rc):
        seen.append(idx.clone())
        return orig(tab, idx, rc)

    monkeypatch.setattr(tstep, "gather_rays", spy)
    step = tstep.make_train_step(cfg, rcfg, state.models, sc.hwf,
                                 precrop_on=precrop_on)
    gen = torch.Generator().manual_seed(0)
    for _ in range(n_steps):
        step(state, table, None, gen)
    return seen, sc.hwf


def test_no_batching_draws_one_image_inside_the_precrop(monkeypatch):
    """While ``precrop_on`` every step's rays lie in one image and inside
    its central ``precrop_frac`` window (rows [H/2 - dH, H/2 + dH)); after
    it, in one image anywhere; the images vary over steps."""
    from depth_lidar_nerf_tpu_torch.train.config import TrainConfig

    cfg = TrainConfig(N_rand=256, N_samples=4, N_importance=0, netdepth=1,
                      netwidth=8, multires=2, multires_views=1,
                      no_batching=True, precrop_frac=0.5, no_ndc=True,
                      use_fused_mlp=False)
    for precrop_on in (True, False):
        seen, (H, W, _) = _step_rows(monkeypatch, cfg, 6, precrop_on)
        dH, dW = int(H // 2 * 0.5), int(W // 2 * 0.5)
        imgs = set()
        inside = []
        for idx in seen:
            img = idx // (H * W)
            assert len(set(img.tolist())) == 1 and idx.numel() == 256
            imgs.add(int(img[0]))
            r, c = (idx % (H * W)) // W, idx % W
            inside.append(bool(((r >= H // 2 - dH) & (r < H // 2 + dH)
                                & (c >= W // 2 - dW) & (c < W // 2 + dW))
                               .all()))
        assert len(imgs) > 1
        assert all(inside) if precrop_on else not any(inside)


def test_select_passes_precrop_on_and_caches_a_step_a_key(monkeypatch):
    """``build_step_fns``' plan builds the precrop variant below
    ``precrop_iters`` and the plain one after, each once, as JAX's
    ``variant_key`` says."""
    from depth_lidar_nerf_tpu.train import config as jcfg
    from depth_lidar_nerf_tpu.train import step as jstep
    from depth_lidar_nerf_tpu_torch.train import config as tcfg
    from depth_lidar_nerf_tpu_torch.train import step as tstep

    kw = dict(no_batching=True, precrop_iters=10, N_importance=8)
    jc, tc = jcfg.TrainConfig(**kw), tcfg.TrainConfig(**kw)
    jplan = jstep.build_step_fns(jc, jcfg.render_config_from(jc, 0, 0.0, 1.0),
                                 None, (24, 32, 30.0))
    built = []
    monkeypatch.setattr(tstep, "make_train_step",
                        lambda *a, **k: built.append(k) or object())
    plan = tstep.build_step_fns(tc, tcfg.render_config_from(tc, 0, 0.0, 1.0),
                                None, (24, 32, 30.0))
    steps = [plan.select(i)[0] for i in range(1, 21)]
    assert [plan.variant_key(i) for i in range(21)] == [
        jplan.variant_key(i) for i in range(21)]
    assert [k["precrop_on"] for k in built] == [True, False]
    assert steps[0] is steps[8] and steps[9] is steps[19]
    assert steps[8] is not steps[9]


@pytest.fixture(scope="module")
def scene_dir(tmp_path_factory):
    from depth_lidar_nerf_tpu_torch.data.synthetic import make_scene

    d = tmp_path_factory.mktemp("scene")
    make_scene(str(d), n_images=3, H=24, W=32, focal=30.0, n_depth_points=120)
    return str(d)


def test_driver_no_batching_precrop(scene_dir, tmp_path, monkeypatch):
    """JAX ``test_no_batching_precrop``: 20 driver steps, the first 9 on the
    central crop (``precrop_iters`` 10), reach ``N_iters`` with finite
    metrics."""
    monkeypatch.chdir(tmp_path)
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    seen = {}
    try:
        state = _train(_cfg(scene_dir, tmp_path, no_batching=True,
                            precrop_iters=10, precrop_frac=0.5, N_iters=20,
                            i_weights=20, i_print=5),
                       metrics_hook=lambda i, m: seen.setdefault(i, m))
    finally:
        torch.set_num_threads(threads)
    assert state.step == 20 and sorted(seen) == [5, 10, 15, 20]
    assert all(np.isfinite(v) for m in seen.values() for v in m.values())
