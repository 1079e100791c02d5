"""Kernels 2-5 on the CPU, bfloat16: the port's autograd Functions (plain
twins inside) against the gradients of JAX ``fused_nerf_apply_rays``
(Pallas interpreter), on each backward route.

Tolerance: bfloat16 level, a relative L2 error per tensor below 3e-2 (about
8 bfloat16 ulps). The two packages round the encodings differently in
bfloat16 (JAX's double-angle recurrence against direct sin/cos), and each
rounding flip can move a ReLU gate; JAX's own bfloat16 gradients differ from
its float32 ones about 7x more than from the port's."""

import pytest
import torch

from torch_port_train_helpers import (grad_compare_bf16, jax_fused_grads,
                                      spy_routes, zero_suffix_cotangent)


@pytest.mark.parametrize("route,depth,S", [("dense", 4, 64), ("culled", 8, 64),
                                           ("acts", 4, 128)])
def test_backward_functions_match_jax_bf16(monkeypatch, route, depth, S):
    from depth_lidar_nerf_tpu_torch.ops import fused_mlp_t as f
    from depth_lidar_nerf_tpu_torch.weights import mlp_state_dict

    N = 8
    g = zero_suffix_cotangent(N, S, seed=3 * S + depth)
    ref, jax_calls, params, rays = jax_fused_grads(
        monkeypatch, depth, 64, S, "bfloat16", route == "culled",
        route == "acts", g, N=N)
    calls = []
    spy_routes(monkeypatch, f, calls)
    leaves = {k: v.requires_grad_() for k, v in mlp_state_dict(params).items()}
    raw = f.fused_nerf_apply_rays(
        leaves, *(torch.from_numpy(a) for a in rays), depth=depth, width=64,
        multires=10, multires_views=4, dtype=torch.bfloat16, skips=(4,),
        cull_bwd=route == "culled", save_acts=route == "acts")
    raw.backward(torch.from_numpy(g))
    assert calls == jax_calls == [f"_bwd_{route}_dparams"]
    grad_compare_bf16(ref, {k: v.grad for k, v in leaves.items()})
