"""Kernels 6-8 on the CPU, bfloat16: the port's semantic autograd Function
(plain twins inside) against JAX ``fused_nerf_apply_rays_semantic`` (Pallas
interpreter).

Tolerance: bfloat16 level, a relative L2 error per tensor below 3e-2 (about
8 bfloat16 ulps) for raw, the logits and every gradient. The two packages
round the encodings differently in bfloat16 (JAX's double-angle recurrence
against direct sin/cos), and each rounding flip can move a ReLU gate."""

import numpy as np
import pytest
import torch

from torch_port_semantic_helpers import jax_semantic, port_inputs
from torch_port_train_helpers import grad_compare_bf16


def _rel_l2(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.linalg.norm(a - b) / (np.linalg.norm(b) + 1e-12)


@pytest.mark.parametrize("depth,C,S", [(4, 19, 128), (8, 5, 64)])
def test_semantic_function_matches_jax_bf16(monkeypatch, depth, C, S):
    from depth_lidar_nerf_tpu_torch.ops import fused_mlp_t as f

    N = 8
    ref = jax_semantic(monkeypatch, depth, 128, C, S, "bfloat16", N=N)
    sd, rays, _, _ = port_inputs(ref["params"], ref["rays"])
    kw = dict(depth=depth, width=128, multires=10, multires_views=4,
              dtype=torch.bfloat16, skips=(4,))
    leaves = {k: v.clone().requires_grad_() for k, v in sd.items()}
    raw, sem = f.fused_nerf_apply_rays_semantic(leaves, *rays, **kw)
    assert _rel_l2(raw.detach().numpy(), ref["raw"]) < 3e-2
    assert _rel_l2(sem.detach().numpy(), ref["sem"]) < 3e-2
    torch.autograd.backward([raw, sem], [torch.from_numpy(ref["g"]),
                                         torch.from_numpy(ref["gsem"])])
    grad_compare_bf16(ref["grads"], {k: v.grad for k, v in leaves.items()})
