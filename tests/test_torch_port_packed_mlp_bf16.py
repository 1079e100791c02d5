"""Kernels 12 and 13 (the v3 packed-lane MLP) on the CPU, bfloat16:
``fused_nerf_apply_raw`` (the kernels' plain twins) against JAX
``fused_nerf_apply_raw`` with its Pallas kernels in the interpreter, at D = 1,
2 and 4, S = 8, 64 and 128, with and without ray padding.

Tolerances at bfloat16 level: raw at 1e-2 of its largest magnitude in max abs
error, and 3e-3 in relative L2 error; gradients per tensor at 3e-2 in
relative L2 error. The two packages' float32 encodings differ in the last bit
for a few phases, which now and then rounds a bfloat16 lane the other way
and moves a ReLU gate."""

import numpy as np
import pytest

from torch_port_packed_helpers import RAYS, raw_pair
from torch_port_train_helpers import grad_compare_bf16

CASES = [(d, S, N) for d in (1, 2, 4) for S in (8, 64, 128) for N in RAYS[S]]


@pytest.mark.parametrize("depth,S,N", CASES)
def test_apply_raw_matches_jax_bf16(monkeypatch, depth, S, N):
    ref, got, jg, tg = raw_pair(monkeypatch, depth, S, N, "bfloat16")
    assert got.shape == ref.shape == (N, S, 4)
    d = np.abs(got - ref)
    assert d.max() <= 1e-2 * np.abs(ref).max(), d.max()
    assert np.linalg.norm(got - ref) <= 3e-3 * np.linalg.norm(ref)
    grad_compare_bf16(jg, tg, 3e-2)
