"""The DS-NeRF sigma-loss slice on the CPU against JAX (Pallas kernels in the
interpreter): ``sigma_loss_from_sigma``, the probing API (``sample_sigma``,
``render_test_ray``), ``query_network``'s route to the packed-lane kernels 12
and 13, and three whole ``two_mlp`` training steps with ``sigma_loss=True``.

Tolerances: the loss function at rtol 1e-6 (the same float32 operations);
the probes at rtol 1e-4 / atol 1e-5 (kernel 12's twin against JAX's
interpreted kernel, float32); the steps as ``test_torch_port_train_step.py``
(metrics rtol 1e-4, parameters rtol 1e-4 / atol 2.5e-5, Adam moments rtol
1e-3)."""

import numpy as np
import pytest

from torch_port_train_helpers import three_steps_against_jax, train_pair


@pytest.mark.parametrize("case", ["random", "overflow_last", "overflow_mid"])
def test_sigma_loss_from_sigma_matches_jax(case):
    import jax.numpy as jnp
    import torch

    from depth_lidar_nerf_tpu.train import losses as jl
    from depth_lidar_nerf_tpu_torch.train import losses as tl

    rng = np.random.default_rng(0)
    s = np.maximum(rng.normal(size=(16, 12)) * 3, 0).astype(np.float32)
    if case == "overflow_last":  # JAX tests/test_losses.py:146
        s = np.zeros((4, 12), np.float32)
        s[:, -1] = 500.0
    elif case == "overflow_mid":
        s[:, 5] = 400.0
    ref = np.asarray(jl.sigma_loss_from_sigma(jnp.asarray(s)))
    got = tl.sigma_loss_from_sigma(torch.from_numpy(s)).numpy()
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, ref, rtol=1e-6, atol=1e-7)
    if case == "overflow_last":
        np.testing.assert_allclose(got, -1.0, atol=1e-4)


def _model_pair(monkeypatch, depth, skips=(4,), semantic=0, width=128,
                seed=0):
    """JAX ``FusedMLP`` (interpreted kernels) and the port's ``FusedMLP`` on
    the CPU with the same weights (the density bias raised so that the
    probes see an opaque field)."""
    import jax
    import jax.numpy as jnp

    from depth_lidar_nerf_tpu.models import NeRFMLP as JMLP
    from depth_lidar_nerf_tpu.train.state import FusedMLP as JFused
    from depth_lidar_nerf_tpu_torch.train.state import FusedMLP
    from depth_lidar_nerf_tpu_torch.weights import mlp_state_dict

    monkeypatch.setenv("DLNERF_PALLAS_INTERPRET", "1")
    module = JMLP(depth=depth, width=width, in_channels=63,
                  in_channels_views=27, skips=skips,
                  num_semantic_classes=semantic, dtype=jnp.float32)
    params = module.init(jax.random.key(seed), jnp.zeros((1, 63)),
                         jnp.zeros((1, 27)))
    params = jax.tree.map(np.asarray, params)
    params["params"]["sigma"]["bias"] = params["params"]["sigma"]["bias"] + 2.0
    tm = FusedMLP(depth=depth, width=width, skips=skips,
                  num_semantic_classes=semantic)
    tm.load_state_dict(mlp_state_dict(params))
    return JFused(module), params, tm


def _rays(N, seed):
    import jax.numpy as jnp
    import torch

    from depth_lidar_nerf_tpu.render.renderer import Rays as JRays
    from depth_lidar_nerf_tpu_torch.render.renderer import Rays

    rng = np.random.default_rng(seed)
    ro = rng.normal(size=(N, 3)).astype(np.float32) * 0.2
    rd = rng.normal(size=(N, 3)).astype(np.float32)
    vd = rd / np.linalg.norm(rd, axis=-1, keepdims=True)
    near = np.full((N, 1), 0.5, np.float32)
    far = rng.uniform(2.0, 4.0, (N, 1)).astype(np.float32)
    arrs = (ro, rd, vd, near, far)
    return (JRays(*(jnp.asarray(a) for a in arrs)),
            Rays(*(torch.from_numpy(a) for a in arrs)))


def _spy_raw(monkeypatch, model, calls, tag):
    orig = model.apply_raw

    def spy(*a, **k):
        calls.append(tag)
        return orig(*a, **k)

    monkeypatch.setattr(model, "apply_raw", spy)


def test_sample_sigma_and_render_test_ray_match_jax(monkeypatch):
    import jax.numpy as jnp
    import torch

    from depth_lidar_nerf_tpu.render import renderer as jr
    from depth_lidar_nerf_tpu_torch.render import renderer as tr

    jm, params, tm = _model_pair(monkeypatch, depth=4)
    jrays, trays = _rays(16, seed=1)
    cfg_j = jr.RenderConfig(N_samples=64, multires=10, multires_views=4,
                            ndc=False)
    cfg_t = tr.RenderConfig(N_samples=64, multires=10, multires_views=4,
                            ndc=False)
    calls = []
    _spy_raw(monkeypatch, jm, calls, "jax")
    _spy_raw(monkeypatch, tm, calls, "port")
    ref = jr.render_test_ray(jm, params, jrays, cfg_j)
    with torch.no_grad():
        got = tr.render_test_ray(tm, trays, cfg_t)
    assert calls == ["jax", "port"]
    for name, a, b in zip(("rgb", "sigma", "z_vals", "depth"), ref, got):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=1e-4,
                                   atol=1e-5, err_msg=name)
    assert float(jnp.max(ref[1])) > 1.0  # the field is not empty
    z = np.sort(np.random.default_rng(2).uniform(0.5, 2.0, (16, 32)),
                -1).astype(np.float32)
    rgb_j, sig_j, out_j = jr.sample_sigma(jm, params, jrays, jnp.asarray(z),
                                          cfg_j)
    with torch.no_grad():
        rgb_t, sig_t, out_t = tr.sample_sigma(tm, trays, torch.from_numpy(z),
                                              cfg_t)
    assert calls == ["jax", "port"] * 2
    for a, b in ((rgb_j, rgb_t), (sig_j, sig_t), (out_j.rgb, out_t.rgb),
                 (out_j.depth, out_t.depth), (out_j.weights, out_t.weights)):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=1e-4,
                                   atol=1e-5)


ROUTE_MODELS = {"D4": (4, (4,)), "D8skip4": (8, (4,))}


@pytest.mark.parametrize("semantic", [0, 3])
@pytest.mark.parametrize("S", [8, 64, 96, 128])
@pytest.mark.parametrize("model", sorted(ROUTE_MODELS))
def test_query_network_route_matches_jax(monkeypatch, model, S, semantic):
    """Both packages' ``query_network`` take the packed-lane kernels (a spy
    on each ``apply_raw``, which returns zeros here) for the same models and
    sample counts: D=4 at S dividing 1,024 without a semantic head."""
    import jax.numpy as jnp
    import torch

    from depth_lidar_nerf_tpu.render import renderer as jr
    from depth_lidar_nerf_tpu_torch.render import renderer as tr

    depth, skips = ROUTE_MODELS[model]
    jm, params, tm = _model_pair(monkeypatch, depth, skips, semantic,
                                 width=128)
    calls = []
    monkeypatch.setattr(jm, "apply_raw", lambda p, pts, vd, c: (
        calls.append("jax"), jnp.zeros(pts.shape[:2] + (4,)))[1])
    monkeypatch.setattr(tm, "apply_raw", lambda pts, vd, c: (
        calls.append("port"), torch.zeros(pts.shape[:2] + (4,)))[1])
    rng = np.random.default_rng(S)
    pts = rng.uniform(-1, 1, (4, S, 3)).astype(np.float32)
    vd = rng.normal(size=(4, 3)).astype(np.float32)
    vd /= np.linalg.norm(vd, axis=-1, keepdims=True)
    kw = dict(N_samples=S, multires=10, multires_views=4,
              num_semantic_classes=semantic)
    jr.query_network(jm, params, jnp.asarray(pts), jnp.asarray(vd),
                     jr.RenderConfig(**kw))
    with torch.no_grad():
        tr.query_network(tm, torch.from_numpy(pts), torch.from_numpy(vd),
                         tr.RenderConfig(**kw))
    want = depth <= 4 and semantic == 0 and 1024 % S == 0
    assert calls == (["jax", "port"] if want else []), calls


def test_sigma_loss_steps_match_jax(monkeypatch):
    """Three ``two_mlp`` steps (coarse and fine D=4, W=128) with the sigma
    loss; its raw query takes ``fused_nerf_apply_raw`` in both packages."""
    import depth_lidar_nerf_tpu.ops.fused_mlp as jfm
    from depth_lidar_nerf_tpu_torch.ops import fused_mlp as tfm

    t = train_pair(monkeypatch, 1e-4, netdepth_fine=4, sigma_loss=True)
    raw_calls = []
    for mod, tag in ((jfm, "jax"), (tfm, "port")):
        orig = mod.fused_nerf_apply_raw

        def spy(*a, _orig=orig, _tag=tag, **k):
            raw_calls.append(_tag)
            return _orig(*a, **k)

        monkeypatch.setattr(mod, "fused_nerf_apply_raw", spy)
    jcalls, tcalls = three_steps_against_jax(monkeypatch, t)
    # JAX traces its step once; the port runs every pass every step.
    assert sorted(jcalls) == ["_bwd_acts_dparams", "_bwd_culled_dparams"]
    assert sorted(tcalls) == sorted(jcalls * 3)
    assert raw_calls.count("jax") == 1 and raw_calls.count("port") == 3


def test_sigma_loss_step_draws_after_the_render(monkeypatch):
    """With perturbation and noise on, the step draws the sigma loss's
    jitter and noise from the generator after the render's draws: the
    render's outputs are those of the same step without the sigma loss."""
    import torch

    from depth_lidar_nerf_tpu_torch.data.synthetic import draw_scene
    from depth_lidar_nerf_tpu_torch.train.config import (TrainConfig,
                                                         render_config_from)
    from depth_lidar_nerf_tpu_torch.train.state import (build_models,
                                                        init_train_state)
    from depth_lidar_nerf_tpu_torch.train.step import make_train_step
    from depth_lidar_nerf_tpu_torch.train.tables import (build_depth_table,
                                                         build_rgb_table)

    sc = draw_scene(n_images=1, H=8, W=8, focal=8.0, n_depth_points=30,
                    seed=0, backdrop=True)
    out = {}
    for sigma_loss in (False, True):
        cfg = TrainConfig(dataset_type="llff", N_rand=32, N_samples=16,
                          N_importance=16, netdepth=2, netwidth=128,
                          netdepth_fine=2, netwidth_fine=128, no_ndc=True,
                          use_viewdirs=True, raw_noise_std=1.0,
                          colmap_depth=True, depth_loss=True,
                          sigma_loss=sigma_loss, seed=0)
        rcfg = render_config_from(cfg, 0, sc.near, sc.far)
        models = build_models(cfg, rcfg, device="cpu")
        tabs = (build_rgb_table(sc.images, sc.poses, [0], *sc.hwf, rcfg,
                                device="cpu"),
                build_depth_table(sc.depth_gts, sc.poses, [0], *sc.hwf, rcfg,
                                  device="cpu"))
        step = make_train_step(cfg, rcfg, models, sc.hwf)
        gen = torch.Generator().manual_seed(5)
        out[sigma_loss] = step(init_train_state(cfg, models), *tabs, gen)
    assert "sigma_loss" in out[True] and "sigma_loss" not in out[False]
    assert np.isfinite(out[True]["sigma_loss"].item())
    for k in ("img_loss", "img_loss0", "depth_loss"):
        assert out[True][k].item() == out[False][k].item(), k
    np.testing.assert_allclose(
        out[True]["loss"].item(),
        out[False]["loss"].item() + 0.1 * out[True]["sigma_loss"].item(),
        rtol=1e-6)
