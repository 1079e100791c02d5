"""Kernels 10 and 11 on the CPU, float32: the int8 helpers and the port's
W8A8 twins against JAX's (``_quant_cols``, ``_qdot``, ``_pack_params_q8``,
``fused_nerf_apply_rays_q8`` and ``fused_nerf_apply_rays_semantic_q8`` in
the Pallas interpreter), W=128, D=4 and D=8 skip@4.

Tolerances. The helpers are held bit for bit. Whole forwards on the three
numbers of ``torch_port_q8_helpers.q8_gaps`` (max over max, mean over mean,
share of elements off by more than 1e-5 of the scale): raw within 2e-2,
7e-5 and 1.2e-2, about 3x the largest gaps measured on these inputs (6.1e-3,
2.3e-5, 3.9e-3: a few activations rounded to the other int8 value). The
ray-summed logits relative to their scale, max 1.5e-4 and mean 3e-5 (3x
the measured 4.8e-5 and 8.6e-6); their share is not held, since a sum of S
samples carries float32 differences above 1e-5 of its scale. Against the
float32 plain module, JAX's own int8 band (``tests/test_fused_q8.py``): max
0.05, mean 0.01."""

import numpy as np
import pytest
import torch

from torch_port_q8_helpers import (assert_gaps, check_quant_helpers, q8_pair,
                                   q8_sem_pair)

RAW_LIMITS = (2e-2, 7e-5, 1.2e-2)
LOGIT_LIMITS = (1.5e-4, 3e-5, 1.0)


@pytest.mark.parametrize("depth", [4, 8])
def test_quant_helpers_bit_exact_f32(depth):
    check_quant_helpers(depth, "float32", seed=depth)


@pytest.mark.parametrize("depth,S,N,seed", [(4, 64, 8, 3), (8, 128, 8, 3),
                                            (8, 128, 5, 0), (4, 64, 40, 0)])
def test_q8_forward_matches_jax_f32(monkeypatch, depth, S, N, seed):
    """Raw of kernel 10's twin against JAX's interpreted kernel; N=5 at
    S=128 pads to the 64 rays of a JAX forward tile and slices back."""
    ref, got, _, _ = q8_pair(monkeypatch, depth, S, "float32", N=N, seed=seed)
    assert got.shape == ref.shape == (4, N, S)
    assert_gaps(got, ref, RAW_LIMITS)


@pytest.mark.parametrize("depth,S", [(4, 64), (8, 128)])
def test_q8_semantic_matches_jax_f32(monkeypatch, depth, S):
    (raw, sem), (graw, gsem) = q8_sem_pair(monkeypatch, depth, S, "float32")
    assert gsem.shape == sem.shape == (8, 19)
    assert_gaps(graw, raw, RAW_LIMITS, "raw")
    assert_gaps(gsem, sem, LOGIT_LIMITS, "logits")


@pytest.mark.parametrize("depth", [4, 8])
def test_q8_within_jax_band_of_plain_module(monkeypatch, depth):
    """The int8 forward against the float32 plain module on the same
    weights stays within JAX's band for its own int8 kernel."""
    from depth_lidar_nerf_tpu_torch.models.nerf_mlp import NeRFMLP
    from depth_lidar_nerf_tpu_torch.ops.embedding import positional_encoding
    from depth_lidar_nerf_tpu_torch.weights import mlp_state_dict

    _, got, params, (ro, rd, vd, z) = q8_pair(monkeypatch, depth, 128,
                                              "float32", seed=depth)
    m = NeRFMLP(depth=depth, width=128)
    m.load_state_dict(mlp_state_dict(params))
    pts = torch.from_numpy(ro[:, None] + rd[:, None] * z[..., None])
    ve = positional_encoding(torch.from_numpy(vd), 4)[:, None].expand(
        -1, z.shape[1], -1)
    with torch.no_grad():
        ref = m(positional_encoding(pts, 10), ve).numpy()
    err = np.abs(got.transpose(1, 2, 0) - ref)
    assert err.max() < 0.05 and err.mean() < 0.01, (err.max(), err.mean())
