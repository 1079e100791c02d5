"""Kernels 2-5 on the CPU, float32: the port's plain twins and its autograd
Functions against the gradients of JAX ``fused_nerf_apply_rays`` (Pallas
interpreter), on each backward route.

Tolerance: the JAX suite's ``_grad_compare`` metric below 1e-3
(``tests/test_fused_mlp.py``): the same products in another summation order.
The autograd Functions run the twins on the CPU, so they equal the twins
called directly up to float32 summation order."""

import numpy as np
import pytest
import torch

from torch_port_train_helpers import (grad_compare, jax_fused_grads,
                                      spy_routes, zero_suffix_cotangent)

ROUTE = {"dense": "_bwd_dense_dparams", "culled": "_bwd_culled_dparams",
         "acts": "_bwd_acts_dparams"}


def _port_inputs(params, rays):
    from depth_lidar_nerf_tpu_torch.weights import mlp_state_dict

    ro, rd, vd, z = (torch.from_numpy(a) for a in rays)
    N, S = z.shape
    pts_t = (ro.T[:, :, None] + rd.T[:, :, None] * z[None]).reshape(3, N * S)
    return mlp_state_dict(params), (ro, rd, vd, z), pts_t, vd.T.contiguous()


def _twin_grads(route, sd, pts_t, vd_t, g, S, kw):
    from depth_lidar_nerf_tpu_torch.ops import fused_mlp_t as f

    if route == "dense":
        return f.fused_nerf_bwd_plain(sd, pts_t, vd_t, g, S, **kw)
    if route == "culled":
        xb, vb, gb, flags = f.culled_layout(pts_t, vd_t, g, S)
        assert 0 < int(flags.sum()) < flags.numel()
        return f.fused_nerf_bwd_plain(sd, xb, vb, gb, f.SAMPLE_BLOCK,
                                      flags=flags, **kw)
    _, acts = f.fused_nerf_fwd_acts_plain(sd, pts_t, vd_t, S, **kw)
    return f.fused_nerf_bwd_acts_plain(sd, pts_t, vd_t, g, acts, S, **kw)


def _function_grads(monkeypatch, route, sd, rays, g, kw):
    from depth_lidar_nerf_tpu_torch.ops import fused_mlp_t as f

    calls = []
    spy_routes(monkeypatch, f, calls)
    leaves = {k: v.clone().requires_grad_() for k, v in sd.items()}
    raw = f.fused_nerf_apply_rays(leaves, *rays, cull_bwd=route == "culled",
                                  save_acts=route == "acts", **kw)
    raw.backward(g.reshape(raw.shape))
    assert f.fused_nerf_apply_rays.last_route == route
    return {k: v.grad for k, v in leaves.items()}, calls


@pytest.mark.parametrize("route,depth,S", [
    ("dense", 4, 64), ("dense", 8, 128), ("culled", 4, 64), ("culled", 8, 128),
    ("acts", 4, 128), ("acts", 8, 64)])
def test_backward_twins_and_functions_match_jax_f32(monkeypatch, route, depth,
                                                    S):
    N = 8
    g = zero_suffix_cotangent(N, S, seed=depth + S)
    ref, jax_calls, params, rays = jax_fused_grads(
        monkeypatch, depth, 64, S, "float32", route == "culled",
        route == "acts", g, N=N)
    assert jax_calls == [ROUTE[route]]
    kw = dict(depth=depth, width=64, multires=10, multires_views=4,
              dtype=torch.float32, skips=(4,))
    sd, trays, pts_t, vd_t = _port_inputs(params, rays)
    gt = torch.from_numpy(g).reshape(4, N * S)
    twin = _twin_grads(route, sd, pts_t, vd_t, gt, S, kw)
    assert set(twin) == set(ref)
    grad_compare(ref, twin, 1e-3)
    fn, calls = _function_grads(monkeypatch, route, sd, trays, gt, kw)
    assert calls == jax_calls  # the route JAX took
    for k in ref:
        torch.testing.assert_close(fn[k], twin[k], rtol=1e-5, atol=1e-7)


@pytest.mark.parametrize("depth,S", [(4, 64), (8, 128), (4, 32)])
def test_culled_route_equals_dense_route(monkeypatch, depth, S):
    """Culling is exact: on per-ray zero-suffix cotangents (some rays all
    zero, some live to the end) the culled backward's gradients equal the
    dense backward's at 1e-4 (float32 summation order)."""
    N = 12
    lengths = np.array([0, 0, 1, S // 4, S // 2, S, S, 3, 17, S - 1, 0, 9])
    g = torch.from_numpy(zero_suffix_cotangent(N, S, 5, lengths)).reshape(4, -1)
    from depth_lidar_nerf_tpu_torch.models.nerf_mlp import NeRFMLP
    from torch_port_helpers import ray_batch

    m = NeRFMLP(depth=depth, width=64, generator=torch.Generator().manual_seed(1))
    sd = {k: v.detach() for k, v in m.named_parameters()}
    rays = tuple(torch.from_numpy(a) for a in ray_batch(N, S, seed=2))
    kw = dict(depth=depth, width=64, multires=10, multires_views=4,
              dtype=torch.float32, skips=(4,))
    dense, calls = _function_grads(monkeypatch, "dense", sd, rays, g, kw)
    assert calls == ["_bwd_dense_dparams"]
    monkeypatch.undo()
    culled, calls = _function_grads(monkeypatch, "culled", sd, rays, g, kw)
    assert calls == ["_bwd_culled_dparams"]
    grad_compare({k: v.numpy() for k, v in dense.items()}, culled, 1e-4)
