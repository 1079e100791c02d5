"""Kernels 6-8 on the CPU, float32: the port's semantic twins and its
autograd Function against JAX ``fused_nerf_apply_rays_semantic`` (Pallas
interpreter), at D=4 and D=8 skip@4, W=128, 4 to 19 classes.

Tolerances: raw at rtol/atol 1e-4, the ray-summed logits at rtol 1e-4 and
atol 1e-3 (``tests/test_fused_mlp.py``'s semantic check: a logit sums S
samples); gradients on the JAX suite's ``_grad_compare`` metric below 1e-3
(the same products in another summation order). The autograd Function runs
the twins on the CPU, so it equals them up to float32 summation order."""

import numpy as np
import pytest
import torch

from torch_port_semantic_helpers import jax_semantic, port_inputs
from torch_port_train_helpers import grad_compare, spy_routes


@pytest.mark.parametrize("depth,C,S", [(4, 4, 64), (8, 19, 128), (8, 7, 64)])
def test_semantic_twins_and_function_match_jax_f32(monkeypatch, depth, C, S):
    from depth_lidar_nerf_tpu_torch.ops import fused_mlp_t as f

    N = 8
    ref = jax_semantic(monkeypatch, depth, 128, C, S, "float32", N=N)
    sd, rays, pts_t, vd_t = port_inputs(ref["params"], ref["rays"])
    kw = dict(depth=depth, width=128, multires=10, multires_views=4,
              dtype=torch.float32, skips=(4,))
    raw6, sem6 = f.fused_nerf_fwd_sem_plain(sd, pts_t, vd_t, S, **kw)
    raw7, acts, sem7, sem_acts = f.fused_nerf_fwd_acts_sem_plain(
        sd, pts_t, vd_t, S, **kw)
    for raw, sem in ((raw6, sem6), (raw7, sem7)):
        np.testing.assert_allclose(raw.reshape(4, N, S).numpy(), ref["raw"],
                                   rtol=1e-4, atol=1e-4)
        assert sem.shape == (N, C)
        np.testing.assert_allclose(sem.numpy(), ref["sem"], rtol=1e-4,
                                   atol=1e-3)
    g = torch.from_numpy(ref["g"]).reshape(4, N * S)
    gsem = torch.from_numpy(ref["gsem"])
    twin = f.fused_nerf_bwd_acts_sem_plain(sd, pts_t, vd_t, g, gsem, acts,
                                           sem_acts, S, **kw)
    assert set(twin) == set(ref["grads"]) == set(sd)
    grad_compare(ref["grads"], twin, 1e-3)

    calls = []
    spy_routes(monkeypatch, f, calls)
    leaves = {k: v.clone().requires_grad_() for k, v in sd.items()}
    raw, sem = f.fused_nerf_apply_rays_semantic(leaves, *rays, **kw)
    assert f.fused_nerf_apply_rays_semantic.last_route == "acts"
    torch.autograd.backward([raw, sem], [g.reshape(4, N, S), gsem])
    assert calls == ["_bwd_acts_sem_dparams"]
    for k in twin:
        torch.testing.assert_close(leaves[k].grad, twin[k], rtol=1e-5,
                                   atol=1e-6)
    with torch.no_grad():
        raw_ng, sem_ng = f.fused_nerf_apply_rays_semantic(sd, *rays, **kw)
    assert f.fused_nerf_apply_rays_semantic.last_route == "forward"
    torch.testing.assert_close(sem_ng, sem6, rtol=0, atol=0)


@pytest.mark.parametrize("S", [64, 128, 16, 4])
def test_tile_partials_and_head_sum_each_ray(S):
    """The partial sums of 64-point tiles (one ray spanning several tiles,
    or several rays in one tile), added per ray in tile order, are each
    ray's feature sum, and the slots hold the rays the kernels expect; the
    head's logits equal the per-point head summed over samples (the head is
    affine, so the two commute). A ray count that no route admits, one that
    would straddle a tile unaligned, is refused."""
    from depth_lidar_nerf_tpu_torch.ops import fused_mlp_t as f

    N, W = 7, 128
    rng = np.random.default_rng(S)
    feat = torch.from_numpy(rng.normal(size=(N * S, W)).astype(np.float32))
    fpart = f.sem_tile_partials_plain(feat, S)
    assert fpart.shape == (-(-N * S // 64), f.sem_tile_slots(S), W)
    g = torch.Generator().manual_seed(S)
    params = {"semantic_0.weight": torch.randn(W // 2, W, generator=g) / 8,
              "semantic_0.bias": torch.randn(W // 2, generator=g),
              "semantic_1.weight": torch.randn(5, W // 2, generator=g) / 8,
              "semantic_1.bias": torch.randn(5, generator=g)}
    sem = f.pack_sem(params, torch.float32)
    logits, sem_acts = f.sem_head_plain(fpart, sem, N, S)
    fsum = feat.reshape(N, S, W).sum(1)
    torch.testing.assert_close(sem_acts[:, :W], fsum, rtol=1e-5, atol=1e-4)
    per_point = ((feat @ params["semantic_0.weight"].T
                  + params["semantic_0.bias"]) @ params["semantic_1.weight"].T
                 + params["semantic_1.bias"])
    torch.testing.assert_close(logits, per_point.reshape(N, S, 5).sum(1),
                               rtol=1e-4, atol=1e-3)
    with pytest.raises(ValueError, match="S dividing 64"):
        f.sem_head_plain(fpart, sem, N, S + 8)
