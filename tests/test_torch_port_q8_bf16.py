"""Kernels 10 and 11 on the CPU, bfloat16: the int8 helpers bit for bit and
the port's W8A8 twins against JAX's interpreted kernels, W=128, D=4 and D=8
skip@4 (see ``test_torch_port_q8_f32.py``).

Tolerances on ``q8_gaps``: raw within 6e-2, 1.4e-3 and 0.17, about 3x the
largest gaps measured (1.9e-2, 4.6e-4, 5.7e-2). They are wider than in
float32 because the two packages round the encodings differently in
bfloat16 (JAX's double-angle recurrence against direct sin/cos), and every
such flip can move an int8 activation. Logits relative to their scale:
max 9e-3, mean 5e-3 (measured 3.0e-3, 1.6e-3)."""

import pytest

from torch_port_q8_helpers import (assert_gaps, check_quant_helpers, q8_pair,
                                   q8_sem_pair)

RAW_LIMITS = (6e-2, 1.4e-3, 0.17)
LOGIT_LIMITS = (9e-3, 5e-3, 1.0)


@pytest.mark.parametrize("depth", [4, 8])
def test_quant_helpers_bit_exact_bf16(depth):
    check_quant_helpers(depth, "bfloat16", seed=depth)


@pytest.mark.parametrize("depth,S,N,seed", [(4, 128, 8, 3), (8, 64, 8, 0),
                                            (8, 128, 5, 3)])
def test_q8_forward_matches_jax_bf16(monkeypatch, depth, S, N, seed):
    ref, got, _, _ = q8_pair(monkeypatch, depth, S, "bfloat16", N=N,
                             seed=seed)
    assert got.shape == ref.shape == (4, N, S)
    assert_gaps(got, ref, RAW_LIMITS)


@pytest.mark.parametrize("depth,S", [(4, 128), (8, 64)])
def test_q8_semantic_matches_jax_bf16(monkeypatch, depth, S):
    (raw, sem), (graw, gsem) = q8_sem_pair(monkeypatch, depth, S, "bfloat16")
    assert gsem.shape == sem.shape == (8, 19)
    assert_gaps(graw, raw, RAW_LIMITS, "raw")
    assert_gaps(gsem, sem, LOGIT_LIMITS, "logits")
