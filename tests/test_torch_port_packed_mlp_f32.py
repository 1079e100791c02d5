"""Kernels 12 and 13 (the v3 packed-lane MLP) on the CPU, float32: the
port's packing against JAX's, and ``fused_nerf_apply_raw`` (the kernels'
plain twins) against JAX ``fused_nerf_apply_raw`` with its Pallas kernels in
the interpreter, at D = 1, 2 and 4, S = 8, 64 and 128, with and without ray
padding.

Tolerances: raw at rtol 1e-4 (atol 1e-5); gradients per parameter tensor at
1e-3 of the tensor's mean magnitude in max abs error (the JAX suite's
``_grad_compare`` metric): float32 sums of ~2,000 points in other orders.
The packing is bit for bit. The two frameworks' float32 ``sin``/``cos``
differ in the last bit for ~5% of the phases, so the packed encoding is held
bit for bit on JAX's own float32 encoding, and the encoding itself within a
float32 ulp of the phase's magnitude."""

import numpy as np
import pytest

from torch_port_helpers import flax_mlp_params
from torch_port_packed_helpers import RAYS, WIDTH, raw_inputs, raw_pair
from torch_port_train_helpers import grad_compare


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("depth", [1, 2, 4])
def test_pack_params_bitwise(depth, dtype):
    import jax.numpy as jnp
    import torch

    from depth_lidar_nerf_tpu.ops.fused_mlp import _pack_params
    from depth_lidar_nerf_tpu_torch.ops.fused_mlp import pack_params
    from depth_lidar_nerf_tpu_torch.weights import mlp_state_dict

    _, params = flax_mlp_params(depth, WIDTH, seed=depth)
    ref = _pack_params(params, depth, 63, 27, getattr(jnp, dtype))
    got = pack_params(mlp_state_dict(params), depth, 63, 27,
                      getattr(torch, dtype))
    assert len(got) == len(ref)
    for a, b in zip(ref, got):
        assert tuple(a.shape) == tuple(b.shape)
        assert str(b.dtype)[6:] == str(a.dtype)
        np.testing.assert_array_equal(b.float().numpy(),
                                      np.asarray(a, np.float32))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_pack_encoding_bitwise(monkeypatch, dtype):
    import jax
    import jax.numpy as jnp
    import torch

    import depth_lidar_nerf_tpu.ops.fused_mlp as jfm
    from depth_lidar_nerf_tpu.ops.embedding import positional_encoding as jpe
    from depth_lidar_nerf_tpu_torch.ops import fused_mlp as tfm
    from depth_lidar_nerf_tpu_torch.ops.embedding import positional_encoding

    N, S = 20, 64  # pads to 32 rays
    pts, vd, _ = raw_inputs(N, S, seed=3)
    _, params = flax_mlp_params(2, WIDTH)
    seen = {}

    def spy(params, packed, *a):
        seen["packed"] = np.asarray(packed.astype(jnp.float32))
        return jnp.zeros((packed.shape[0], 8), jnp.float32)

    monkeypatch.setattr(jfm, "_fused_packed", spy)
    jfm.fused_nerf_apply_raw(params, jnp.asarray(pts), jnp.asarray(vd),
                             depth=2, width=WIDTH, multires=10,
                             multires_views=4, dtype=getattr(jnp, dtype))
    pad_p = np.pad(pts, ((0, 12), (0, 0), (0, 0)))
    pad_v = np.pad(vd, ((0, 12), (0, 0)))
    # The port's packing of JAX's float32 encoding: bit for bit.
    monkeypatch.setattr(tfm, "positional_encoding", lambda x, n: torch.from_numpy(
        np.array(jpe(jnp.asarray(x.numpy()), n))))
    got = tfm.pack_encoding(torch.from_numpy(pad_p), torch.from_numpy(pad_v),
                            10, 4, getattr(torch, dtype))
    assert got.dtype == getattr(torch, dtype) and got.shape == (32 * S, 128)
    np.testing.assert_array_equal(got.float().numpy(), seen["packed"])
    # Its own encoding: within a float32 ulp of each phase (|sin| <= 1).
    monkeypatch.undo()
    for x, n in ((pad_p, 10), (pad_v, 4)):
        ref = np.asarray(jax.jit(jpe, static_argnums=1)(jnp.asarray(x), n))
        np.testing.assert_allclose(positional_encoding(torch.from_numpy(x),
                                                       n).numpy(), ref,
                                   rtol=0, atol=1.2e-7)


CASES = [(d, S, N) for d in (1, 2, 4) for S in (8, 64, 128) for N in RAYS[S]]


@pytest.mark.parametrize("depth,S,N", CASES)
def test_apply_raw_matches_jax_f32(monkeypatch, depth, S, N):
    ref, got, jg, tg = raw_pair(monkeypatch, depth, S, N, "float32")
    assert got.shape == ref.shape == (N, S, 4)
    np.testing.assert_allclose(got, ref, rtol=1e-4, atol=1e-5)
    grad_compare(jg, tg, 1e-3)


@pytest.mark.parametrize("depth,width,skips", [(4, 64, (4,)), (4, 128, (4,)),
                                               (2, 256, (4,)), (8, 128, (4,)),
                                               (4, 128, (2,)), (4, 128, (3,))])
def test_supports_matches_jax(depth, width, skips):
    """JAX ``fused_mlp.supports`` (``tests/test_fused_mlp.py``
    ``test_supports_predicate``) and the port's on the same models, sample
    counts, view-direction and semantic settings."""
    from depth_lidar_nerf_tpu.ops.fused_mlp import supports as jsupports
    from depth_lidar_nerf_tpu_torch.ops.fused_mlp import supports
    from depth_lidar_nerf_tpu_torch.weights import mlp_state_dict

    _, params = flax_mlp_params(depth, width, skips=skips)
    sd = mlp_state_dict(params)
    for S in (128, 100, 8, -1):
        for viewdirs, n_sem in ((True, 0), (False, 0), (True, 5)):
            args = (viewdirs, n_sem, depth, width, S, 10, 4)
            assert supports(sd, *args, skips=skips) == bool(
                jsupports(params, *args, skips=skips)), (S, viewdirs, n_sem)
