"""The JAX package's route knobs in the port, on the CPU: with each set, the
port takes the backward route JAX takes and matches JAX's outputs and
gradients (JAX's kernels in the Pallas interpreter).

- ``DLNERF_BWD_ACTS`` (JAX ``ops/fused_mlp_t.py:bwd_acts_enabled``, read at
  call time): other than "1", a pass that asks to save its activations takes
  the recompute backward instead.
- ``DLNERF_BWD_ACTS_MAX_POINTS`` (JAX ``_ACTS_MAX_POINTS``, read at import):
  the saved-activation cap, in D=4/W=256 bfloat16 points. Set in the
  environment of a fresh interpreter, and patched as a module attribute on
  both sides for the routes.
- ``DLNERF_NO_BWD_CULL`` (JAX ``train/state.py:FusedMLP.apply_rays``): "1"
  takes the dense backward where ``cull_eps > 0`` would cull.
- ``DLNERF_ACTS_COARSE`` (JAX ``render/renderer.py:render_rays``): "1"
  saves the coarse pass's activations too.

The port does not honour JAX's tiling knobs ``DLNERF_FUSED_TILE`` and
``DLNERF_CULL_SAMPLE_BLOCK`` (ROADMAP Queue 3): its tiles are the CUDA
kernels' own, and only the route conditions follow JAX's defaults.

Tolerances: the suite's float32 limits. ``render_rays``' outputs at rtol
1e-4 (atol 1e-5, ``assert_render_close``); the cap's gradients at 1e-3 of
each tensor's mean abs (``grad_compare``); for the gradients of every route
a knob moves, both models', three training steps under the knob with the
step tests' rules (``three_steps_against_jax``: metrics and parameters at
rtol 1e-4, the Adam moments, which carry each step's gradients, at rtol
1e-3 with an atol of 1e-3 of the tensor's largest)."""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from torch_port_helpers import assert_render_close, look_at_pose, render_pair
from torch_port_train_helpers import (grad_compare, jax_fused_grads,
                                      spy_routes, three_steps_against_jax,
                                      train_pair, zero_suffix_cotangent)

ROUTE = {"dense": "_bwd_dense_dparams", "culled": "_bwd_culled_dparams",
         "acts": "_bwd_acts_dparams"}
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


# Each knob (unset, then each set alone) with the coarse and fine backward
# routes both packages take where cull_eps > 0.
KNOBS = [
    ({}, "culled", "acts"),
    ({"DLNERF_NO_BWD_CULL": "1"}, "dense", "acts"),
    ({"DLNERF_ACTS_COARSE": "1"}, "acts", "acts"),
    ({"DLNERF_BWD_ACTS": "0"}, "culled", "culled"),
]


@pytest.mark.parametrize("env,coarse,fine", KNOBS)
def test_render_rays_routes_follow_knobs_as_jax(monkeypatch, env, coarse,
                                                fine):
    """``render_rays`` under autograd (``cull_eps`` 1e-4) on 32 rays: both
    packages' coarse and fine backward routes and their outputs. The
    gradients of these routes are compared in
    :func:`test_train_steps_under_knobs_match_jax`: here a coarse trunk ReLU
    gate whose pre-activation lies within float32 rounding of zero opens in
    one package and not in the other, with every knob and without one, and
    moves one point's share of trunk_1's gradient (3 of its elements off
    JAX's by 1.2e-3 of the tensor's largest; the step tests' rules hold at
    their 64 rays)."""
    import jax
    import jax.numpy as jnp

    import depth_lidar_nerf_tpu.ops.fused_mlp_t as jfmt
    from depth_lidar_nerf_tpu.ops.rays import camera_rays as jrays
    from depth_lidar_nerf_tpu.render.renderer import make_rays as jmake
    from depth_lidar_nerf_tpu.render.renderer import render_rays as jrender
    from depth_lidar_nerf_tpu_torch.ops import fused_mlp_t as tfmt
    from depth_lidar_nerf_tpu_torch.ops.rays import camera_rays
    from depth_lidar_nerf_tpu_torch.render.renderer import (make_rays,
                                                            render_rays)

    for k, v in env.items():
        monkeypatch.setenv(k, v)
    jm, params, jr, tm, tr = render_pair(monkeypatch, False)
    assert jr.cull_eps > 0 and tr.cull_eps == jr.cull_eps
    H, W, focal = 4, 8, 6.0
    c2w = look_at_pose(5)
    rng = np.random.default_rng(0)
    c0, c1 = (rng.normal(size=(H * W, 3)).astype(np.float32) for _ in "01")

    jcalls, tcalls = [], []
    spy_routes(monkeypatch, jfmt, jcalls)
    spy_routes(monkeypatch, tfmt, tcalls)
    ro, rd = jrays(H, W, focal, jnp.asarray(c2w))
    jrays_ = jmake(ro, rd, jr, H, W, focal)

    def jloss(p):
        out = jrender(jm.coarse, jm.fine, p, jrays_, jr)
        return (jnp.sum(out["rgb0"] * c0) + jnp.sum(out["rgb_map"] * c1),
                out)

    (_, ref), _ = jax.value_and_grad(jloss, has_aux=True)(params)
    to, td = camera_rays(H, W, focal, torch.from_numpy(c2w))
    got = render_rays(tm.coarse, tm.fine, make_rays(to, td, tr, H, W, focal),
                      tr)
    (torch.sum(got["rgb0"] * torch.from_numpy(c0))
     + torch.sum(got["rgb_map"] * torch.from_numpy(c1))).backward()

    want = sorted([ROUTE[coarse], ROUTE[fine]])
    assert sorted(jcalls) == want
    assert sorted(tcalls) == want
    assert_render_close(ref, {k: v.detach() for k, v in got.items()},
                        ("rgb_map", "rgb0", "acc0", "depth_map0"))


@pytest.mark.parametrize("env,coarse,fine", KNOBS)
def test_train_steps_under_knobs_match_jax(monkeypatch, env, coarse, fine):
    """Three training steps of both packages (``train_pair``: 64 rays, coarse
    D=4, fine D=8 skip@4, ``cull_eps`` 1e-4) with each knob set: the routes
    JAX traces, the port's each step, and the metrics, parameters and Adam
    moments of both models by the step tests' rules."""
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    t = train_pair(monkeypatch, 1e-4)
    jcalls, tcalls = three_steps_against_jax(monkeypatch, t)
    assert sorted(jcalls) == sorted([ROUTE[coarse], ROUTE[fine]])
    assert sorted(tcalls) == sorted(jcalls * 3)


@pytest.mark.parametrize("over", [False, True])
def test_acts_cap_attribute_routes_as_jax(monkeypatch, over):
    """The saved-activation cap patched on both modules, just below or
    just above what a pass of 8 rays x 64 samples needs after JAX's ray
    padding: the same route (recompute or saved activations), the same
    gradients; the semantic predicate follows the same cap."""
    import jax.numpy as jnp

    import depth_lidar_nerf_tpu.ops.fused_mlp_t as jfmt
    from depth_lidar_nerf_tpu.render.renderer import RenderConfig as JRC
    from depth_lidar_nerf_tpu.train.state import FusedMLP as JFused
    from depth_lidar_nerf_tpu_torch.ops import fused_mlp_t as tfmt
    from depth_lidar_nerf_tpu_torch.render.renderer import RenderConfig
    from depth_lidar_nerf_tpu_torch.train.state import FusedMLP
    from depth_lidar_nerf_tpu_torch.weights import mlp_state_dict
    from torch_port_semantic_helpers import flax_sem_params

    depth, width, S, N = 4, 64, 64, 8
    n_pts = tfmt.semantic_padded_rays(N, S, depth, width, torch.float32) * S
    # float32 at D=4 / W=64: 1,408 bytes a point, so the cap is 2x the knob.
    cap_pts = n_pts // 2 + (1 if over else -1)
    monkeypatch.setattr(jfmt, "_ACTS_MAX_POINTS", cap_pts)
    monkeypatch.setattr(tfmt, "_ACTS_MAX_POINTS", cap_pts)
    cap = tfmt.acts_points_cap(depth, width, torch.float32)
    assert cap == jfmt.acts_points_cap(depth, width, jnp.float32)
    assert (cap >= n_pts) == over

    g = zero_suffix_cotangent(N, S, seed=3)
    ref, jcalls, params, rays = jax_fused_grads(
        monkeypatch, depth, width, S, "float32", True, True, g, N=N)
    route = "acts" if over else "culled"
    assert jcalls == [ROUTE[route]]
    calls = []
    spy_routes(monkeypatch, tfmt, calls)
    sd = mlp_state_dict(params)
    leaves = {k: v.clone().requires_grad_() for k, v in sd.items()}
    raw = tfmt.fused_nerf_apply_rays(
        leaves, *(torch.from_numpy(a) for a in rays), depth=depth,
        width=width, multires=10, multires_views=4, dtype=torch.float32,
        skips=(4,), cull_bwd=True, save_acts=True)
    raw.backward(torch.from_numpy(g))
    assert tfmt.fused_nerf_apply_rays.last_route == route
    assert calls == jcalls
    grad_compare(ref, {k: v.grad for k, v in leaves.items()}, 1e-3)

    monkeypatch.setenv("DLNERF_PALLAS_INTERPRET", "1")
    model, sparams = flax_sem_params(8, 256, 19)
    jm = JFused(model.clone(dtype=jnp.bfloat16))
    tm = FusedMLP(depth=8, width=256, num_semantic_classes=19,
                  dtype=torch.bfloat16)
    jr, tr = JRC(num_semantic_classes=19), RenderConfig(num_semantic_classes=19)
    for n in (1, 64, 128, 256, 1024):
        assert tm.supports_raw_semantic(tr, n_points=n * 128, S=128) == \
            jm.supports_raw_semantic(sparams, jr, n_points=n * 128, S=128), n


def test_acts_cap_knob_read_at_import():
    """``DLNERF_BWD_ACTS_MAX_POINTS`` in the environment of a new
    interpreter sets both packages' cap as they are imported."""
    code = ("import depth_lidar_nerf_tpu.ops.fused_mlp_t as j, "
            "depth_lidar_nerf_tpu_torch.ops.fused_mlp_t as t; "
            "print(j._ACTS_MAX_POINTS, t._ACTS_MAX_POINTS, "
            "j.acts_points_cap(8, 256), t.acts_points_cap(8, 256))")
    env = dict(os.environ, DLNERF_BWD_ACTS_MAX_POINTS="123456",
               JAX_PLATFORMS="cpu")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, check=True).stdout
    j_pts, t_pts, j_cap, t_cap = (int(x) for x in out.split())
    assert j_pts == t_pts == 123456
    assert j_cap == t_cap == 123456 * 2816 // 4864
