"""The port stands alone: importing every module of
``depth_lidar_nerf_tpu_torch`` loads neither ``jax`` nor the JAX package, and
its entry points refuse to run without a card unless asked for the CPU."""

import os
import subprocess
import sys

import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_GUARD = """
import importlib, pkgutil, sys
import depth_lidar_nerf_tpu_torch as pkg
names = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + ".")]
for n in names:
    importlib.import_module(n)
bad = sorted(m for m in sys.modules
             if m == "jax" or m.startswith(("jax.", "jaxlib", "flax"))
             or m == "depth_lidar_nerf_tpu" or m.startswith("depth_lidar_nerf_tpu."))
print(len(names), bad)
assert not bad, bad
"""


def test_port_imports_no_jax():
    out = subprocess.run([sys.executable, "-c", _GUARD], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr + out.stdout
    n_modules = int(out.stdout.split()[0])
    assert n_modules >= 15, out.stdout


def test_entry_points_need_a_device(monkeypatch):
    from depth_lidar_nerf_tpu_torch.device import resolve_device
    from depth_lidar_nerf_tpu_torch.render.renderer import render_image
    from depth_lidar_nerf_tpu_torch.train.config import (TrainConfig,
                                                         render_config_from)
    from depth_lidar_nerf_tpu_torch.train.loop import render_path
    from depth_lidar_nerf_tpu_torch.train.state import build_models

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = TrainConfig(netwidth=128, netwidth_fine=128, N_importance=8,
                      N_samples=8, use_viewdirs=True)
    rcfg = render_config_from(cfg, 0, 0.0, 1.0)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        build_models(cfg, rcfg)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        resolve_device("cuda")
    models = build_models(cfg, rcfg, device="cpu")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        render_image(models.coarse, models.fine, 2, 2, 1.0, torch.eye(4),
                     rcfg)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        render_path(models, [torch.eye(4).numpy()], (2, 2, 1.0), rcfg)
    assert resolve_device("cpu") == torch.device("cpu")


def test_wrappers_refuse_other_devices_and_gradients():
    from depth_lidar_nerf_tpu_torch.models.nerf_mlp import NeRFMLP
    from depth_lidar_nerf_tpu_torch.ops.fused_mlp_t import fused_nerf_fwd
    from depth_lidar_nerf_tpu_torch.ops.sampling_cuda import inverse_cdf

    m = NeRFMLP(depth=2, width=128)
    params = dict(m.named_parameters())
    kw = dict(depth=2, width=128, multires=10, multires_views=4)
    pts = torch.linspace(-1, 1, 24).reshape(3, 8)
    vd = torch.nn.functional.normalize(torch.ones(3, 2), dim=0)
    # Under autograd the wrapper trains: a gradient reaches every parameter.
    with torch.no_grad():
        m.sigma.bias += 1.0  # a live density, so every layer gets a signal
    fused_nerf_fwd(params, pts, vd, 4, **kw).square().sum().backward()
    for name, p in params.items():
        assert p.grad is not None and p.grad.abs().sum() > 0, name
    with torch.no_grad():
        assert fused_nerf_fwd(params, pts, vd, 4, **kw).shape == (4, 8)
        with pytest.raises(ValueError, match="unsupported"):
            fused_nerf_fwd(params, pts.to("meta"), vd.to("meta"), 4, **kw)
        with pytest.raises(ValueError, match="bad shapes"):
            fused_nerf_fwd(params, pts, vd, 3, **kw)
    b, w, u = torch.zeros(2, 5), torch.ones(2, 4), torch.zeros(2, 3)
    with pytest.raises(ValueError, match="unsupported"):
        inverse_cdf(b.to("meta"), w.to("meta"), u.to("meta"))


def test_render_config_refuses_unported_modes():
    from depth_lidar_nerf_tpu_torch.train.config import (TrainConfig,
                                                         render_config_from)

    with pytest.raises(NotImplementedError, match="render_grid"):
        render_config_from(TrainConfig(render_grid=64), 0, 0.0, 1.0)
    with pytest.raises(NotImplementedError, match="render_grid_fine_only"):
        render_config_from(TrainConfig(render_grid_fine_only=True), 0, 0.0,
                           1.0)


def test_chip_smoke_imports_no_jax():
    """``chip_smoke.py`` runs on a machine without JAX: no line of it
    imports ``jax``, Flax or the JAX package."""
    import ast

    tree = ast.parse(open(os.path.join(REPO, "chip_smoke.py")).read())
    names = [a.name for n in ast.walk(tree) if isinstance(n, ast.Import)
             for a in n.names]
    names += [n.module for n in ast.walk(tree)
              if isinstance(n, ast.ImportFrom) and n.module]
    bad = [m for m in names if m.split(".")[0] in ("jax", "jaxlib", "flax",
                                                   "depth_lidar_nerf_tpu")]
    assert not bad, bad
    assert any(m.startswith("depth_lidar_nerf_tpu_torch") for m in names)


def test_semantic_wrappers_refuse_bad_inputs():
    """The semantic kernels' wrappers check shapes and devices as the
    others do, and refuse packed weights without a semantic head."""
    from depth_lidar_nerf_tpu_torch.models.nerf_mlp import NeRFMLP
    from depth_lidar_nerf_tpu_torch.ops import fused_mlp_t as f

    m = NeRFMLP(depth=2, width=128, num_semantic_classes=3)
    params = {k: v.detach() for k, v in m.named_parameters()}
    kw = dict(depth=2, width=128, multires=10, multires_views=4)
    pts = torch.linspace(-1, 1, 24).reshape(3, 8)
    vd = torch.nn.functional.normalize(torch.ones(3, 2), dim=0)
    raw, sem = f.fused_nerf_fwd_sem(params, pts, vd, 4, **kw)
    assert raw.shape == (4, 8) and sem.shape == (2, 3)
    with pytest.raises(ValueError, match="unsupported"):
        f.fused_nerf_fwd_sem(params, pts.to("meta"), vd.to("meta"), 4, **kw)
    with pytest.raises(ValueError, match="bad shapes"):
        f.fused_nerf_fwd_acts_sem(params, pts, vd, 3, **kw)
    pts24 = torch.linspace(-1, 1, 72).reshape(3, 24)  # one ray of 24 samples
    for fn in (f.fused_nerf_fwd_sem, f.fused_nerf_fwd_acts_sem):
        with pytest.raises(ValueError, match="S dividing 64"):
            fn(params, pts24, vd[:, :1], 24, **kw)
    _, acts, _, sem_acts = f.fused_nerf_fwd_acts_sem(params, pts, vd, 4, **kw)
    g = torch.zeros(4, 8)
    with pytest.raises(ValueError, match="bad semantic inputs"):
        f.fused_nerf_bwd_acts_sem(params, pts, vd, g, torch.zeros(3, 3), acts,
                                  sem_acts, 4, **kw)
    trunk = {k: v for k, v in params.items() if not k.startswith("semantic")}
    assert f.pack_params(trunk, 2, torch.float32).sem is None
    with pytest.raises(ValueError, match="no semantic head"):
        f._sem_packed_for(params, 2, torch.float32, torch.device("cpu"),
                          f.pack_params(trunk, 2, torch.float32))
    assert f.supports_semantic(params, True, 2, 128, 10, 4)
    assert not f.supports_semantic(trunk, True, 2, 128, 10, 4)
    assert not f.supports_rays(params, True, 3, 2, 128, 10, 4)
