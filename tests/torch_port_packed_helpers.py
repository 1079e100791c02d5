"""Shared inputs for the PyTorch-port tests of the packed-lane MLP (kernels
12 and 13, ``test_torch_port_packed_mlp_*``).

JAX ``fused_nerf_apply_raw`` runs its Pallas kernels in the interpreter;
points, view directions and cotangents are made with numpy from a seed and
handed to both packages, weights converted from the Flax pytree.
"""

import numpy as np

from torch_port_helpers import flax_mlp_params, interpret_pallas

WIDTH = 128
# Rays per case: one 2,048-point TPU tile, or fewer rays that pad to it.
RAYS = {8: (256, 100), 64: (32, 20), 128: (16, 10)}


def raw_inputs(N, S, seed=0):
    """Float32 numpy points ``[N, S, 3]``, unit view directions ``[N, 3]``
    and a cotangent ``[N, S, 4]``."""
    rng = np.random.default_rng(seed)
    pts = rng.uniform(-1.5, 1.5, (N, S, 3)).astype(np.float32)
    vd = rng.normal(size=(N, 3)).astype(np.float32)
    vd /= np.linalg.norm(vd, axis=-1, keepdims=True)
    g = rng.normal(size=(N, S, 4)).astype(np.float32)
    return pts, vd, g


def raw_pair(monkeypatch, depth, S, N, dtype, seed=0):
    """JAX ``fused_nerf_apply_raw`` (Pallas interpreter) and the port's on
    the CPU (kernels 12 and 13's twins) on the same inputs: each side's raw
    ``[N, S, 4]`` and parameter gradients for the cotangent, as numpy and
    the port's parameter mapping. ``dtype`` "float32" or "bfloat16"."""
    import jax
    import jax.numpy as jnp
    import torch

    import depth_lidar_nerf_tpu.ops.fused_mlp as jfm
    from depth_lidar_nerf_tpu_torch.ops import fused_mlp as tfm
    from depth_lidar_nerf_tpu_torch.weights import mlp_state_dict

    interpret_pallas(monkeypatch, jfm)
    _, params = flax_mlp_params(depth, WIDTH, seed=seed)
    pts, vd, g = raw_inputs(N, S, seed=seed + 1)
    kw = dict(depth=depth, width=WIDTH, multires=10, multires_views=4)

    def f(p):
        return jfm.fused_nerf_apply_raw(p, jnp.asarray(pts), jnp.asarray(vd),
                                        dtype=getattr(jnp, dtype), **kw)

    ref, vjp = jax.vjp(f, params)
    (jg,) = vjp(jnp.asarray(g))
    sd = {k: v.requires_grad_() for k, v in mlp_state_dict(params).items()}
    got = tfm.fused_nerf_apply_raw(sd, torch.from_numpy(pts),
                                   torch.from_numpy(vd),
                                   dtype=getattr(torch, dtype), **kw)
    (got * torch.from_numpy(g)).sum().backward()
    tg = {k: v.grad for k, v in sd.items()}
    return (np.asarray(ref, np.float32), got.detach().numpy(),
            mlp_state_dict(jax.tree.map(np.asarray, jg)), tg)
