"""Shared inputs and checks for the PyTorch-port int8 serving tests
(``test_torch_port_q8_*``).

JAX runs its int8 Pallas kernels (``_fwd_kernel_q8``, ``_fwd_kernel_q8_sem``)
in the interpreter; inputs are made with numpy from a seed and handed to both
packages, weights converted from the Flax pytrees with ``params_from_jax``.

A whole int8 forward is compared on three numbers (:func:`q8_gaps`): the
max abs error over the reference's max abs, the mean abs error over its mean
abs, and the share of elements that differ by more than 1e-5 of the
reference's max abs. The integer part of the arithmetic is exact, but an
activation ``h r`` within float32 noise of a ``.5`` boundary rounds one way
in JAX and the other in the port (their float32 products sum in different
orders, and in bfloat16 their encodings round differently), and one such
flip moves an output by up to ``m / 127`` of a column's scale. So the max is
loose, and the mean and the share carry the check's power: a wrong
quantization moves every element.
"""

import numpy as np

from torch_port_helpers import flax_mlp_params, interpret_pallas, ray_batch


def q8_gaps(got, ref):
    """(max abs err / max abs ref, mean abs err / mean abs ref, share of
    elements off by more than 1e-5 of max abs ref)."""
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    d, scale = np.abs(got - ref), np.abs(ref).max()
    return (d.max() / scale, d.mean() / np.abs(ref).mean(),
            float((d > 1e-5 * scale).mean()))


def assert_gaps(got, ref, limits, what=""):
    gaps = q8_gaps(got, ref)
    assert all(g <= lim for g, lim in zip(gaps, limits)), (what, gaps, limits)


def check_quant_helpers(depth, dtype, width=128, seed=0):
    """``quant_cols``, ``qdot_plain`` and ``pack_params_q8`` against JAX's
    ``_quant_cols``, ``_qdot`` and ``_pack_params_q8``, bit for bit, in
    ``dtype`` ("float32" or "bfloat16"): a weight whose column scales span
    three decades with an all-zero column, activations with an all-zero row
    and a row of one nonzero value, and a whole D-layer pack with the skip
    at layer 4."""
    import jax.numpy as jnp
    import torch

    import depth_lidar_nerf_tpu.ops.fused_mlp_t as jf
    from depth_lidar_nerf_tpu_torch.ops import fused_mlp_t as tf
    from depth_lidar_nerf_tpu_torch.weights import mlp_state_dict

    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)

    def both(a):  # numpy float32 -> (jax in dtype, torch in dtype), same values
        j = jnp.asarray(a, jnp.float32).astype(jdt)
        return j, torch.from_numpy(np.array(j.astype(jnp.float32))).to(tdt)

    rng = np.random.default_rng(seed)
    w = rng.normal(size=(width, width)) * np.geomspace(1e-2, 10.0, width)
    w[:, 3] = 0.0
    wj, wt = both(w.astype(np.float32))
    qj, sj = jf._quant_cols(wj)
    qt, st = tf.quant_cols(wt)
    assert qt.dtype == torch.int8 and st.dtype == torch.float32
    np.testing.assert_array_equal(qt.numpy(), np.asarray(qj))
    np.testing.assert_array_equal(st.numpy(), np.asarray(sj))

    h = np.maximum(rng.normal(size=(37, width)), 0.0) * rng.uniform(
        0.1, 30.0, (37, 1))
    h[5] = 0.0
    h[9] = 0.0
    h[9, 17] = 2.5
    hj, ht = both(h.astype(np.float32))
    np.testing.assert_array_equal(tf.qdot_plain(ht, qt, st).numpy(),
                                  np.asarray(jf._qdot(hj, qj, sj)))

    _, params = flax_mlp_params(depth, width, seed=seed)
    skips = jf._live_skips(depth, (4,))
    ws = jf._unflatten_q8(jf._pack_params_q8(params, depth, 10, 4, jdt, (4,)),
                          depth, skips)
    packed = tf.pack_params_q8(mlp_state_dict(params), depth, tdt, skips=(4,))
    want = list(ws[2]) + [ws[5], ws[8]]  # trunk, feature, view-f int8 weights
    assert len(packed.q) == len(want) == depth + 1
    for a, b in zip(packed.q, want):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    np.testing.assert_array_equal(packed.scales.numpy(), np.asarray(ws[13]))
    # The kernels' copy: 4 int8 along K in each int32 word, byte e = row 4k+e.
    for j, q in enumerate(packed.q):
        K, N = q.shape
        o = packed.q_offsets[j]
        words = packed.wq4[o:o + K * N // 4].view(torch.int8).reshape(K // 4, N, 4)
        torch.testing.assert_close(words.permute(0, 2, 1).reshape(K, N), q,
                                   rtol=0, atol=0)


def q8_pair(monkeypatch, depth, S, dtype, N=8, seed=0, width=128):
    """Kernel 10: JAX ``fused_nerf_apply_rays_q8`` (Pallas interpreter) and
    the port's on the same rays and converted weights. Returns (jax raw,
    port raw, flax params, rays), raw [4, N, S]."""
    import jax.numpy as jnp
    import torch

    import depth_lidar_nerf_tpu.ops.fused_mlp as fm
    import depth_lidar_nerf_tpu.ops.fused_mlp_t as jf
    from depth_lidar_nerf_tpu_torch.ops import fused_mlp_t as tf
    from depth_lidar_nerf_tpu_torch.weights import mlp_state_dict

    interpret_pallas(monkeypatch, fm, jf)
    _, params = flax_mlp_params(depth, width, seed=seed)
    rays = ray_batch(N, S, seed=seed + 1)
    kw = dict(depth=depth, width=width, multires=10, multires_views=4,
              skips=(4,))
    ref = np.asarray(jf.fused_nerf_apply_rays_q8(
        params, *rays, dtype=getattr(jnp, dtype), **kw))
    with torch.no_grad():
        got = tf.fused_nerf_apply_rays_q8(
            mlp_state_dict(params), *(torch.from_numpy(a) for a in rays),
            dtype=getattr(torch, dtype), **kw).numpy()
    return ref, got, params, rays


def q8_sem_pair(monkeypatch, depth, S, dtype, C=19, N=8, seed=0, width=128):
    """Kernel 11: JAX ``fused_nerf_apply_rays_semantic_q8`` (Pallas
    interpreter) and the port's. Returns ((jax raw, jax logits), (port raw,
    port logits))."""
    import jax.numpy as jnp
    import torch

    import depth_lidar_nerf_tpu.ops.fused_mlp as fm
    import depth_lidar_nerf_tpu.ops.fused_mlp_t as jf
    from depth_lidar_nerf_tpu_torch.ops import fused_mlp_t as tf
    from depth_lidar_nerf_tpu_torch.weights import mlp_state_dict
    from torch_port_semantic_helpers import flax_sem_params

    interpret_pallas(monkeypatch, fm, jf)
    _, params = flax_sem_params(depth, width, C, seed=seed)
    rays = ray_batch(N, S, seed=seed + 1)
    kw = dict(depth=depth, width=width, multires=10, multires_views=4,
              skips=(4,))
    raw, sem = jf.fused_nerf_apply_rays_semantic_q8(
        params, *rays, dtype=getattr(jnp, dtype), **kw)
    with torch.no_grad():
        got = tf.fused_nerf_apply_rays_semantic_q8(
            mlp_state_dict(params), *(torch.from_numpy(a) for a in rays),
            dtype=getattr(torch, dtype), **kw)
    return (np.asarray(raw), np.asarray(sem)), tuple(x.numpy() for x in got)
