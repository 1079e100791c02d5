"""Kernel 1 (fused NeRF MLP forward), bfloat16 operands: the port's plain
version against JAX ``fused_nerf_apply_rays`` in the Pallas interpreter.

Tolerance 2e-2 of the output scale: the JAX kernel forms bf16 encodings by a
double-angle recurrence and the port by direct sin/cos, so stored bf16
activations differ by an ulp here and there (a bf16 ulp is 2^-8 relative)."""

import numpy as np
import pytest

from torch_port_helpers import fused_pair


@pytest.mark.parametrize("S", [64, 128])
@pytest.mark.parametrize("width", [64, 128])
@pytest.mark.parametrize("depth", [4, 8])
def test_fused_fwd_plain_matches_jax_bf16(monkeypatch, depth, width, S):
    ref, got = fused_pair(monkeypatch, depth, width, S, "bfloat16")
    assert got.shape == ref.shape == (4, 8, S)
    scale = np.abs(ref).max()
    np.testing.assert_allclose(got, ref, rtol=0, atol=2e-2 * scale)
