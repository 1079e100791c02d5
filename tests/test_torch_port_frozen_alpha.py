"""The port's frozen-alpha model (``FrozenAlphaMLP``, ``FrozenModel``,
``load_alpha_params``; ``--alpha_model_path``, ``--no_coarse``) against the
JAX package on the CPU: the ``frozen_sigma`` substitution, the density
head's zero gradient, one training step of each path against JAX
``make_train_step`` with the wrappers built from the same alpha weights,
the alpha model read from a checkpoint of the port, and the driver's
fine-tune from a trained source.

Tolerances: float32 outputs rtol 1e-4, gradients rtol 1e-3; step metrics
rtol 1e-4, updated parameters rtol 1e-4 with atol 2.5e-5, Adam moments
rtol 1e-3 (the step tests', ``test_torch_port_train_step.py``).
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from depth_lidar_nerf_tpu.models import NeRFMLP as JMLP
from depth_lidar_nerf_tpu.train import state as jstate
from depth_lidar_nerf_tpu_torch.models.nerf_mlp import NeRFMLP as TMLP
from depth_lidar_nerf_tpu_torch.train import state as tstate
from depth_lidar_nerf_tpu_torch.weights import mlp_state_dict
from test_torch_port_driver import _cfg, _train


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def test_frozen_sigma_substitution_matches_jax():
    """``frozen_sigma`` replaces the density head's output (JAX
    ``tests/test_models.py:57``), and the rest of the output equals JAX's."""
    pts_dim, views_dim = 63, 27
    jm = JMLP(depth=2, width=32, in_channels=pts_dim,
              in_channels_views=views_dim)
    pe = np.array(jax.random.normal(jax.random.key(1), (5, pts_dim)))
    ve = np.array(jax.random.normal(jax.random.key(2), (5, views_dim)))
    params = jm.init(jax.random.key(0), jnp.asarray(pe), jnp.asarray(ve))
    frozen = np.full((5, 1), 3.25, np.float32)
    want = np.asarray(jm.apply(params, jnp.asarray(pe), jnp.asarray(ve),
                               frozen_sigma=jnp.asarray(frozen)))
    tm = TMLP(depth=2, width=32, in_channels=pts_dim,
              in_channels_views=views_dim)
    tm.load_state_dict(mlp_state_dict(_np(params)))
    with torch.no_grad():
        got = tm(torch.from_numpy(pe), torch.from_numpy(ve),
                 frozen_sigma=torch.from_numpy(frozen)).numpy()
    np.testing.assert_allclose(got[..., 3], 3.25, rtol=1e-6)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-6)


def test_frozen_alpha_density_head_gets_no_gradient():
    """Under ``FrozenAlphaMLP`` the trained density head gets no gradient
    while the colour branch does (JAX ``tests/test_train_e2e.py:599``), and
    every gradient equals JAX's (the density head's zero)."""
    kw = dict(depth=2, width=32, in_channels=9, in_channels_views=6)
    jm = JMLP(**kw)
    pe, ve = jnp.zeros((4, 9)), jnp.zeros((4, 6))
    alpha_params = jm.init(jax.random.key(0), pe, ve)
    params = jm.init(jax.random.key(1), pe, ve)
    wrapper = jstate.FrozenAlphaMLP(jm, jm, alpha_params)
    x = np.random.default_rng(0).normal(size=(4, 9)).astype(np.float32)
    v = np.random.default_rng(1).normal(size=(4, 6)).astype(np.float32)

    def loss(p):
        out = wrapper.apply(p, jnp.asarray(x), jnp.asarray(v))
        return jnp.mean(out[..., 3] ** 2) + jnp.mean(out[..., :3] ** 2)

    jg = mlp_state_dict(_np(jax.grad(loss)(params)))
    alpha = TMLP(**kw)
    alpha.load_state_dict(mlp_state_dict(_np(alpha_params)))
    tm = tstate.FrozenAlphaMLP(alpha.requires_grad_(False), **kw)
    tm.load_state_dict(mlp_state_dict(_np(params)))
    assert set(dict(tm.named_parameters())) == set(jg)  # alpha not among them
    out = tm(torch.from_numpy(x), torch.from_numpy(v))
    (torch.mean(out[..., 3] ** 2) + torch.mean(out[..., :3] ** 2)).backward()
    assert tm.sigma.weight.grad is None and tm.sigma.bias.grad is None
    assert not jg["sigma.weight"].any() and not jg["sigma.bias"].any()
    assert tm.rgb.weight.grad.abs().sum() > 0
    for name, p in tm.named_parameters():
        if p.grad is not None:
            np.testing.assert_allclose(p.grad.numpy(), jg[name].numpy(),
                                       rtol=1e-3, atol=1e-7, err_msg=name)


def _alpha_pair(monkeypatch, no_coarse):
    """Both packages' steps with the frozen-alpha models built from one
    alpha model (fine widths, its density head of weight 0 and bias 0.8 so
    that the importance samples sit at the same depths in both, as
    ``torch_port_train_helpers.train_pair`` pins the coarse density): two
    MLPs D=4 / W=64, 32 + 32 samples, half LiDAR depth rays, float32,
    ``perturb`` and sigma noise off."""
    from depth_lidar_nerf_tpu.train import config as jcfg
    from depth_lidar_nerf_tpu.train import step as jstep
    from depth_lidar_nerf_tpu.train import tables as jtables
    from depth_lidar_nerf_tpu_torch.data.synthetic import draw_scene
    from depth_lidar_nerf_tpu_torch.train import config as tcfg
    from depth_lidar_nerf_tpu_torch.train import step as tstep
    from depth_lidar_nerf_tpu_torch.train import tables as ttables
    from depth_lidar_nerf_tpu_torch.weights import params_from_jax

    sc = draw_scene(n_images=2, H=12, W=16, focal=14.0, n_depth_points=40,
                    seed=0, backdrop=True)
    H, W, focal = sc.hwf
    fields = dict(dataset_type="llff", N_rand=64, N_samples=32,
                  N_importance=32, netdepth=4, netwidth=64, netdepth_fine=4,
                  netwidth_fine=64, use_viewdirs=True, no_ndc=True,
                  perturb=0.0, raw_noise_std=0.0, colmap_depth=True,
                  depth_loss=True, depth_lambda=0.01, multires=4,
                  multires_views=2, use_fused_mlp=False, no_coarse=no_coarse)
    jc, tc = jcfg.TrainConfig(**fields), tcfg.TrainConfig(**fields)
    jr = jcfg.render_config_from(jc, 0, sc.near, sc.far)
    tr = tcfg.render_config_from(tc, 0, sc.near, sc.far)
    base = jstate.build_models(jc, jr)
    alpha_mod = JMLP(depth=4, width=64, in_channels=base.coarse.in_channels,
                     in_channels_views=base.coarse.in_channels_views,
                     output_ch=5)
    pe = jnp.zeros((1, base.coarse.in_channels))
    ve = jnp.zeros((1, base.coarse.in_channels_views))
    ap = _np(alpha_mod.init(jax.random.key(5), pe, ve))
    ap["params"]["sigma"]["kernel"] = ap["params"]["sigma"]["kernel"] * 0.0
    ap["params"]["sigma"]["bias"] = ap["params"]["sigma"]["bias"] + 0.8
    coarse = (jstate.FrozenModel(alpha_mod, ap) if no_coarse
              else jstate.FrozenAlphaMLP(base.coarse, alpha_mod, ap))
    jm = jstate.Models(coarse, jstate.FrozenAlphaMLP(base.fine, alpha_mod, ap),
                       None, None)
    js = jstate.init_train_state(jc, jr, jm, jax.random.key(0))

    alpha = TMLP(depth=4, width=64, in_channels=base.coarse.in_channels,
                 in_channels_views=base.coarse.in_channels_views, output_ch=5)
    alpha.load_state_dict(mlp_state_dict(ap))
    alpha.requires_grad_(False)
    kw = dict(depth=4, width=64, in_channels=base.coarse.in_channels,
              in_channels_views=base.coarse.in_channels_views, output_ch=5)
    sds = params_from_jax(_np(js.params))
    fine = tstate.FrozenAlphaMLP(alpha, **kw)
    fine.load_state_dict(sds["fine"])
    if no_coarse:
        tcoarse = tstate.FrozenModel(alpha)
    else:
        tcoarse = tstate.FrozenAlphaMLP(alpha, **kw)
        tcoarse.load_state_dict(sds["coarse"])
    tm = tstate.Models(tcoarse, fine)
    cpu = torch.device("cpu")
    i_train = np.arange(2)
    return dict(
        jax_step=jstep.make_train_step(jc, jr, jm, sc.hwf), jax_state=js,
        jax_tables=(jtables.build_rgb_table(sc.images, sc.poses, i_train, H,
                                            W, focal, jr),
                    jtables.build_depth_table(sc.depth_gts, sc.poses,
                                              i_train, H, W, focal, jr)),
        port_step=tstep.make_train_step(tc, tr, tm, sc.hwf),
        port_state=tstate.init_train_state(tc, tm),
        port_tables=(ttables.build_rgb_table(sc.images, sc.poses, i_train, H,
                                             W, focal, tr, device=cpu),
                     ttables.build_depth_table(sc.depth_gts, sc.poses,
                                               i_train, H, W, focal, tr,
                                               device=cpu)),
        alpha=alpha)


@pytest.mark.parametrize("no_coarse", [False, True])
def test_frozen_alpha_step_matches_jax(monkeypatch, no_coarse):
    """One ``alpha_model_path`` step (both passes' density from the alpha
    model, their colour branches trained) and one ``no_coarse`` step (the
    coarse pass the alpha model itself, no ``img_loss0``) against JAX's:
    metrics, the trained parameters and moments; the density heads keep no
    Adam state (JAX's moments for them are zero, their update zero)."""
    from torch_port_train_helpers import _jax_state_dicts, jax_step_indices

    t = _alpha_pair(monkeypatch, no_coarse)
    js, ts = t["jax_state"], t["port_state"]
    j_rgb, j_dep = t["jax_tables"]
    rng = jax.random.key(11)
    idx, idx_d = jax_step_indices(rng, 32, 32, j_rgb.origins.shape[0],
                                  j_dep.origins.shape[0])
    p0 = {n: p.detach().clone()
          for n, p in ts.models.fine.named_parameters()}
    js, jm = t["jax_step"](js, j_rgb, j_dep, None, None, rng)
    tm = t["port_step"](ts, *t["port_tables"], idx=idx, idx_d=idx_d)
    assert set(tm) == set(jm)
    assert ("img_loss0" in tm) == (not no_coarse)
    for k in jm:
        np.testing.assert_allclose(tm[k].item(), float(jm[k]), rtol=1e-4,
                                   err_msg=k)
    params, mu, nu = _jax_state_dicts(js)
    nets = {"fine": ts.models.fine}
    if not no_coarse:
        nets["coarse"] = ts.models.coarse
    else:
        assert not list(ts.models.coarse.parameters())
    for net, m in nets.items():
        for name, p in m.named_parameters():
            np.testing.assert_allclose(
                p.detach().numpy(), params[net][name].numpy(), rtol=1e-4,
                atol=2.5e-5, err_msg=f"{net} {name}")
            st = ts.optimizer.state.get(p)
            if name.startswith("sigma."):
                assert not st and not mu[net][name].numpy().any()
                continue
            for key, want in (("exp_avg", mu), ("exp_avg_sq", nu)):
                w = want[net][name].numpy()
                np.testing.assert_allclose(
                    st[key].numpy(), w, rtol=1e-3,
                    atol=1e-3 * np.abs(w).max() + 1e-30,
                    err_msg=f"{net} {name} {key}")
    assert torch.equal(ts.models.fine.sigma.weight, p0["sigma.weight"])
    # The alpha model is neither trained nor among the optimizer's tensors.
    held = {id(p) for g in ts.optimizer.param_groups for p in g["params"]}
    assert not any(id(p) in held for p in t["alpha"].parameters())


def test_load_alpha_params_from_a_port_checkpoint(tmp_path):
    """``alpha_model_path`` names a checkpoint file of the port, or its
    directory (the newest step): the alpha model takes its fine MLP, stays
    out of the optimizer and the checkpoint; another topology is refused
    with ``checkpoint.restore``'s message."""
    from depth_lidar_nerf_tpu_torch.train import checkpoint
    from depth_lidar_nerf_tpu_torch.train.config import (TrainConfig,
                                                         render_config_from)

    cfg = TrainConfig(netdepth=2, netwidth=32, netdepth_fine=3,
                      netwidth_fine=24, N_samples=8, N_importance=8,
                      multires=3, multires_views=2, use_viewdirs=True,
                      use_fused_mlp=False)
    rcfg = render_config_from(cfg, 0, 0.0, 1.0)
    src = tstate.init_train_state(cfg, tstate.build_models(
        cfg, rcfg, device="cpu", seed=3))
    d = str(tmp_path / "ck")
    checkpoint.save_state(d, src, 7, checkpoint.topology(cfg, 0))
    for path in (checkpoint.path_of(d, 7), d):
        ft = cfg.replace(alpha_model_path=path)
        models = tstate.build_models(ft, rcfg, device="cpu")
        assert isinstance(models.fine, tstate.FrozenAlphaMLP)
        alpha = models.fine.alpha_module
        for k, v in src.models.fine.state_dict().items():
            assert torch.equal(alpha.state_dict()[k], v), k
        assert models.coarse.alpha_module is alpha
        state = tstate.init_train_state(ft, models)
        held = {id(p) for p in state.optimizer.param_groups[0]["params"]}
        assert not any(id(p) in held for p in alpha.parameters())
        assert (set(models.fine.state_dict())
                == set(src.models.fine.state_dict()))
    nc = tstate.build_models(cfg.replace(alpha_model_path=d, no_coarse=True),
                             rcfg, device="cpu")
    assert isinstance(nc.coarse, tstate.FrozenModel)
    assert not list(nc.coarse.parameters()) and not nc.coarse.state_dict()
    with pytest.raises(ValueError, match=r"netwidth_fine=24 \(this run: 32\)"
                       ".*check the netdepth/netwidth"):
        tstate.build_models(cfg.replace(alpha_model_path=d, netwidth_fine=32),
                            rcfg, device="cpu")


@pytest.fixture(scope="module")
def scene_dir(tmp_path_factory):
    from depth_lidar_nerf_tpu_torch.data.synthetic import make_scene

    d = tmp_path_factory.mktemp("scene")
    make_scene(str(d), n_images=3, H=24, W=32, focal=30.0, n_depth_points=120)
    return str(d)


@pytest.fixture(autouse=True)
def _in_tmp(tmp_path, monkeypatch):
    """As ``test_torch_port_driver.py``: the summary writer's ``runs/``
    under ``tmp_path``, one intra-op thread."""
    monkeypatch.chdir(tmp_path)
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.mark.parametrize("no_coarse", [False, True])
def test_driver_fine_tunes_on_a_frozen_alpha(scene_dir, tmp_path, no_coarse):
    """JAX ``test_frozen_alpha_model_path`` (``tests/test_train_e2e.py:581``):
    train a source, checkpoint it, then fine-tune the colour with the frozen
    density from its checkpoint directory, with and without ``no_coarse``.
    The fine-tune's density heads have not moved from their seeded
    initialisation, and its rendered density is the source's fine MLP's."""
    from depth_lidar_nerf_tpu_torch.train import checkpoint
    from depth_lidar_nerf_tpu_torch.train.config import render_config_from

    src = _train(_cfg(scene_dir, tmp_path, N_iters=20, i_weights=20,
                      expname="alpha_src"))
    d = checkpoint.ckpt_dir(str(tmp_path), "alpha_src")
    assert checkpoint.steps(d) == [20]
    cfg = _cfg(scene_dir, tmp_path, N_iters=10, i_weights=10,
               expname="alpha_ft", alpha_model_path=d, no_coarse=no_coarse)
    state = _train(cfg)
    assert state.step == 10
    init = tstate.build_models(cfg, render_config_from(cfg, 0, 0.0, 1.0),
                               device="cpu", seed=cfg.seed)
    for k in ("sigma.weight", "sigma.bias"):
        assert torch.equal(state.models.fine.state_dict()[k],
                           init.fine.state_dict()[k])
    assert not torch.equal(state.models.fine.rgb.weight, init.fine.rgb.weight)
    x = torch.randn(6, state.models.fine.in_channels)
    v = torch.randn(6, state.models.fine.in_channels_views)
    with torch.no_grad():
        got = state.models.fine(x, v)[..., 3]
        want = src.models.fine(x, v)[..., 3]
    assert torch.equal(got, want)
    if no_coarse:
        assert isinstance(state.models.coarse, tstate.FrozenModel)
    ck = checkpoint.load_file(checkpoint.path_of(
        checkpoint.ckpt_dir(str(tmp_path), "alpha_ft"), 10))
    assert not any("alpha" in k for k in ck["models"]["fine"])
    assert os.path.getsize(checkpoint.path_of(
        checkpoint.ckpt_dir(str(tmp_path), "alpha_ft"), 10)) > 0
