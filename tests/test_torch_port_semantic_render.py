"""The semantic stack's glue on the CPU against the JAX package: the route
predicate (``supports_raw_semantic`` / ``semantic_padded_rays``), the
renderer's semantic branch (``_composite_from_z``, ``render_rays`` with
``sem_preds``/``sem_preds0``), the semantic cross-entropy, the scene's
labels and the weight conversion of a model with a semantic head.

Tolerances: route choices and ray counts exactly; renders as
``assert_render_close`` (rgb/acc/depth/weights rtol 1e-4, atol 1e-5) with
the ray-summed logits at rtol 1e-4 and atol 1e-3 (a logit sums S samples);
the loss at rtol 1e-6."""

import dataclasses

import numpy as np
import pytest
import torch

from torch_port_helpers import assert_render_close, ray_batch
from torch_port_semantic_helpers import flax_sem_params, sem_render_pair


@pytest.mark.parametrize("depth,width,dtype", [(8, 256, "bfloat16"),
                                               (4, 256, "bfloat16"),
                                               (8, 256, "float32"),
                                               (6, 128, "float32")])
def test_semantic_route_matches_jax(monkeypatch, depth, width, dtype):
    import jax.numpy as jnp

    from depth_lidar_nerf_tpu.ops import fused_mlp_t as jfmt
    from depth_lidar_nerf_tpu.render.renderer import RenderConfig as JRC
    from depth_lidar_nerf_tpu.train.state import FusedMLP as JFused
    from depth_lidar_nerf_tpu_torch.ops import fused_mlp_t as tfmt
    from depth_lidar_nerf_tpu_torch.render.renderer import RenderConfig
    from depth_lidar_nerf_tpu_torch.train.state import FusedMLP
    from depth_lidar_nerf_tpu_torch.weights import mlp_state_dict

    monkeypatch.setenv("DLNERF_PALLAS_INTERPRET", "1")
    model, params = flax_sem_params(depth, width, 19)
    jm = JFused(model.clone(dtype=getattr(jnp, dtype)))
    tm = FusedMLP(depth=depth, width=width, num_semantic_classes=19,
                  dtype=getattr(torch, dtype))
    tm.load_state_dict(mlp_state_dict(params))
    jr, tr = JRC(num_semantic_classes=19), RenderConfig(num_semantic_classes=19)
    for S in (32, 64, 128, 192):
        for n in (1, 100, 4096, 16384, 16385, 18000, 18944, 19000, 32768,
                  33088):
            assert tfmt.semantic_padded_rays(
                n, S, depth, width, getattr(torch, dtype)) == \
                jfmt.semantic_padded_rays(n, S, depth, width,
                                          getattr(jnp, dtype)), (n, S)
            want = jm.supports_raw_semantic(params, jr, n_points=n * S, S=S)
            assert tm.supports_raw_semantic(tr, n_points=n * S, S=S) == \
                want, (n, S)
        assert tfmt.supports_rays_shape(S) == jfmt.supports_rays_shape(S)
    assert tm.supports_raw_semantic(tr) and jm.supports_raw_semantic(params, jr)
    if (depth, width, dtype) == (8, 256, "bfloat16"):
        # A serving tile of `chunk` 32,768 rays at 128 samples is beyond the
        # D=8 cap (2,428,457 points): the plain module; 16,384 is within it.
        assert not tm.supports_raw_semantic(tr, n_points=32768 * 128, S=128)
        assert tm.supports_raw_semantic(tr, n_points=16384 * 128, S=128)


def test_composite_from_z_semantic_matches_jax(monkeypatch):
    import jax.numpy as jnp

    import depth_lidar_nerf_tpu.ops.fused_mlp_t as jfmt
    from depth_lidar_nerf_tpu.render import renderer as jrend
    from depth_lidar_nerf_tpu_torch.ops import fused_mlp_t as tfmt
    from depth_lidar_nerf_tpu_torch.render import renderer as trend

    jm, params, jr, tm, tr = sem_render_pair(monkeypatch)
    calls = []
    orig = jfmt.fused_nerf_apply_rays_semantic
    monkeypatch.setattr(jfmt, "fused_nerf_apply_rays_semantic",
                        lambda *a, **k: calls.append(1) or orig(*a, **k))
    N, S = 8, 64
    ro, rd, vd, z = ray_batch(N, S, seed=3)
    near, far = np.full((N, 1), 2.0, np.float32), np.full((N, 1), 6.0, np.float32)
    ref = jrend._composite_from_z(
        jm.coarse, params["coarse"],
        jrend.Rays(*(jnp.asarray(a) for a in (ro, rd, vd, near, far))),
        jnp.asarray(z), jr, None)
    assert calls  # JAX took the semantic kernels
    t = [torch.from_numpy(a) for a in (ro, rd, vd, near, far)]
    tfmt.fused_nerf_apply_rays_semantic.last_route = None
    with torch.no_grad():
        got = trend._composite_from_z(tm.coarse, trend.Rays(*t),
                                      torch.from_numpy(z), tr, None)
    assert tfmt.fused_nerf_apply_rays_semantic.last_route == "forward"
    for k in ("rgb", "acc", "depth", "weights"):
        np.testing.assert_allclose(getattr(got, k).numpy(),
                                   np.asarray(getattr(ref, k)), rtol=1e-4,
                                   atol=1e-5, err_msg=k)
    assert got.semantic.shape == (N, 19)
    np.testing.assert_allclose(got.semantic.numpy(), np.asarray(ref.semantic),
                               rtol=1e-4, atol=1e-3)

    # With sigma noise the branch draws it as the RGB branch does: one
    # normal per sample from the generator, before the network runs.
    noisy = dataclasses.replace(tr, raw_noise_std=1.0)
    gen = torch.Generator().manual_seed(5)
    with torch.no_grad():
        got_n = trend._composite_from_z(tm.coarse, trend.Rays(*t),
                                        torch.from_numpy(z), noisy, gen)
        noise = torch.randn((N, S), generator=torch.Generator().manual_seed(5))
        raw_t, sem = tm.coarse.apply_rays_semantic(trend.Rays(*t),
                                                   torch.from_numpy(z), noisy)
        want = trend.raw2outputs_t(raw_t, torch.from_numpy(z), t[1],
                                   raw_noise_std=1.0, noise=noise)
    torch.testing.assert_close(got_n.rgb, want.rgb)
    torch.testing.assert_close(got_n.semantic, sem)


def test_render_rays_semantic_matches_jax(monkeypatch):
    import jax.numpy as jnp

    from depth_lidar_nerf_tpu.render import renderer as jrend
    from depth_lidar_nerf_tpu_torch.render import renderer as trend

    jm, params, jr, tm, tr = sem_render_pair(monkeypatch)
    N = 8
    ro, rd, vd, _ = ray_batch(N, 4, seed=3)
    near, far = np.full((N, 1), 2.0, np.float32), np.full((N, 1), 6.0, np.float32)
    ref = jrend.render_rays(
        jm.coarse, jm.fine, params,
        jrend.Rays(*(jnp.asarray(a) for a in (ro, rd, vd, near, far))), jr)
    with torch.no_grad():
        got = trend.render_rays(
            tm.coarse, tm.fine,
            trend.Rays(*(torch.from_numpy(a) for a in (ro, rd, vd, near, far))),
            tr)
    assert set(got) == set(ref)
    assert_render_close(ref, got, ("rgb_map", "acc_map", "depth_map",
                                   "rgb0", "acc0", "depth_map0"))
    for k in ("sem_preds", "sem_preds0"):
        assert got[k].shape == (N, 19)
        np.testing.assert_allclose(got[k].numpy(), np.asarray(ref[k]),
                                   rtol=1e-4, atol=1e-3, err_msg=k)
    # The tile policy admits the semantic passes at `chunk` rays here.
    assert trend.fused_eval_ready(tm.coarse, tm.fine, tr, 1024)


def test_semantic_cross_entropy_matches_jax():
    import jax.numpy as jnp

    from depth_lidar_nerf_tpu.train import losses as jl
    from depth_lidar_nerf_tpu_torch.train import losses as tl

    rng = np.random.default_rng(0)
    logits = (rng.normal(size=(300, 19)) * 40).astype(np.float32)
    labels = rng.integers(0, 19, 300).astype(np.int32)
    got = tl.semantic_cross_entropy(torch.from_numpy(logits),
                                    torch.from_numpy(labels))
    want = jl.semantic_cross_entropy(jnp.asarray(logits), jnp.asarray(labels))
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-6)


def test_scene_labels_and_tables_match_jax(tmp_path):
    """``draw_scene(num_classes=19)`` holds the labels and class count that
    JAX ``make_scene(num_classes=19)`` writes, and the RGB tables of both
    packages carry them per ray."""
    from depth_lidar_nerf_tpu.data.synthetic import make_scene as jmake
    from depth_lidar_nerf_tpu.render.renderer import RenderConfig as JRC
    from depth_lidar_nerf_tpu.train.tables import build_rgb_table as jtable
    from depth_lidar_nerf_tpu_torch.data.synthetic import draw_scene
    from depth_lidar_nerf_tpu_torch.render.renderer import RenderConfig
    from depth_lidar_nerf_tpu_torch.train.tables import build_rgb_table

    kw = dict(n_images=2, H=9, W=13, focal=10.0, n_depth_points=20, seed=2,
              backdrop=True, num_classes=19)
    jmake(str(tmp_path), **kw)
    sj = np.load(tmp_path / "segmentation_gt.npy", allow_pickle=True).item()
    sc = draw_scene(**kw)
    np.testing.assert_array_equal(sc.segmentation, sj["segmentations"])
    assert sc.num_classes == sj["num_classes"] == 19
    assert len(np.unique(sc.segmentation)) > 1
    jt = jtable(sc.images, sc.poses, [0, 1], *sc.hwf, JRC(ndc=False),
                segmentation=sc.segmentation)
    tt = build_rgb_table(sc.images, sc.poses, [0, 1], *sc.hwf,
                         RenderConfig(ndc=False), segmentation=sc.segmentation,
                         device="cpu")
    np.testing.assert_array_equal(tt.semantic.numpy(), np.asarray(jt.semantic))


def test_flax_tree_with_semantic_head_loads(monkeypatch):
    """A Flax tree with ``semantic_0``/``semantic_1`` goes through
    ``params_from_jax`` and loads into ``FusedMLP`` with ``strict=True``;
    the plain module then gives the Flax module's outputs."""
    import jax.numpy as jnp

    from depth_lidar_nerf_tpu_torch.ops.embedding import positional_encoding
    from depth_lidar_nerf_tpu_torch.train.state import FusedMLP
    from depth_lidar_nerf_tpu_torch.weights import params_from_jax

    model, params = flax_sem_params(8, 64, 6)
    sds = params_from_jax({"coarse": params, "fine": None})
    assert sds["fine"] is None
    assert {"semantic_0.weight", "semantic_1.bias"} <= set(sds["coarse"])
    m = FusedMLP(depth=8, width=64, num_semantic_classes=6)
    m.load_state_dict(sds["coarse"], strict=True)
    x = np.random.default_rng(0).normal(size=(5, 3)).astype(np.float32)
    v = np.random.default_rng(1).normal(size=(5, 3)).astype(np.float32)
    pe, ve = (positional_encoding(torch.from_numpy(a), n)
              for a, n in ((x, 10), (v, 4)))
    want = np.asarray(model.apply(params, jnp.asarray(pe.numpy()),
                                  jnp.asarray(ve.numpy())))
    with torch.no_grad():
        got = m(pe, ve).numpy()
    assert got.shape == (5, 10)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
