"""Kernel 1 (fused NeRF MLP forward), float32: the port's plain version
against JAX ``fused_nerf_apply_rays`` in the Pallas interpreter.

f32 tolerance rtol 1e-4 / atol 1e-5: the same products in another summation
order, and sinf of exact phases on both sides."""

import numpy as np
import pytest

from torch_port_helpers import fused_pair


@pytest.mark.parametrize("S", [64, 128])
@pytest.mark.parametrize("width", [64, 128])
@pytest.mark.parametrize("depth", [4, 8])
def test_fused_fwd_plain_matches_jax_f32(monkeypatch, depth, width, S):
    ref, got = fused_pair(monkeypatch, depth, width, S, "float32")
    assert got.shape == ref.shape == (4, 8, S)
    np.testing.assert_allclose(got, ref, rtol=1e-4, atol=1e-5)
