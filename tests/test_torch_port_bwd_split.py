"""The split backward of kernels 5 and 8 on the CPU: phase 1's twin (the
chain, ``fused_nerf_bwd_chain_plain``) and phase 2's (the weight-gradient
products, ``bwd_weight_grads_plain``), composed over chunks of points by
``_bwd_split``, against the saved-activation twin ``_bwd_from_acts`` and
against JAX's interpreted ``_bwd_acts_dparams`` / ``_bwd_acts_sem_dparams``;
phase 2's table and the cotangent buffer's layout; the float64 witness of
the backward's bfloat16 products on exactly rounded values.

Tolerances: the composition against the twin 1e-6 of each gradient's max
abs (the same float32 products; only the order of the sums over chunks and
of the weight products' orientation differs); against JAX the step tests'
metrics (float32 ``grad_compare`` below 1e-3, bfloat16 relative L2 below
3e-2, ``tests/test_torch_port_train_grads_*.py``)."""

import numpy as np
import pytest
import torch

from torch_port_semantic_helpers import jax_semantic, port_inputs
from torch_port_train_helpers import (grad_compare, grad_compare_bf16,
                                      jax_fused_grads, zero_suffix_cotangent)


def _inputs(depth, width, S, N, seed):
    from depth_lidar_nerf_tpu_torch.models.nerf_mlp import NeRFMLP

    m = NeRFMLP(depth=depth, width=width,
                generator=torch.Generator().manual_seed(seed))
    with torch.no_grad():
        m.sigma.bias += 0.5
    params = {k: v.detach() for k, v in m.named_parameters()}
    rng = np.random.default_rng(seed)
    pts = torch.from_numpy(rng.uniform(-1, 1, (3, N * S)).astype(np.float32))
    vd = torch.nn.functional.normalize(torch.from_numpy(
        rng.normal(size=(N, 3)).astype(np.float32)), dim=-1).T.contiguous()
    g = torch.from_numpy(zero_suffix_cotangent(N, S, seed)).reshape(4, -1)
    return params, pts, vd, g


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("depth,width,S,N,chunk,sem", [
    (4, 64, 64, 10, 192, False), (8, 128, 16, 13, 64, False),
    (8, 64, 3, 70, 128, False), (2, 64, 128, 3, 320, False),
    (8, 64, 16, 12, 128, True)])
def test_chunked_phases_equal_twin(monkeypatch, depth, width, S, N, chunk, sem,
                                   dtype):
    """Phases 1 and 2 over chunks (the last one ragged; a ray of S=3 or 16
    straddling a chunk edge) give kernel 5's twin, and with a per-ray
    feature cotangent kernel 8's trunk, within float32 rounding."""
    from depth_lidar_nerf_tpu_torch.ops import fused_mlp_t as f

    params, pts, vd, g = _inputs(depth, width, S, N, depth * S)
    P = N * S
    assert P % chunk
    kw = dict(depth=depth, width=width, multires=10, multires_views=4,
              skips=(4,))
    _, acts = f.fused_nerf_fwd_acts_plain(params, pts, vd, S, dtype=dtype,
                                          **kw)
    dfeat_ray = None
    if sem:
        dfeat_ray = torch.from_numpy(np.random.default_rng(1).normal(
            size=(N, width)).astype(np.float32)).to(dtype)
    ref = f.fused_nerf_bwd_acts_plain(params, pts, vd, g, acts, S,
                                      dtype=dtype, dfeat_ray=dfeat_ray, **kw)
    pk = f.pack_params(params, depth, dtype)
    monkeypatch.setattr(f, "BWD_CHUNK", chunk)
    got = f._bwd_split(params, pk, pts, vd, g, acts, S, dtype=dtype,
                       dfeat_ray=dfeat_ray, **kw)
    assert set(got) == set(ref)
    for k in ref:
        err = (got[k] - ref[k]).abs().max().item()
        assert err <= 1e-6 * ref[k].abs().max().item(), (k, err)


@pytest.mark.parametrize("dtype,depth,S", [("float32", 4, 64),
                                           ("float32", 8, 128),
                                           ("bfloat16", 4, 128)])
def test_chunked_phases_match_jax_acts(monkeypatch, dtype, depth, S):
    """The composed phases against JAX's interpreted saved-activation
    backward (``_bwd_acts_dparams``), on the activations of the port's
    kernel 4 twin, 3 chunks with a ragged last one."""
    from depth_lidar_nerf_tpu_torch.ops import fused_mlp_t as f
    from depth_lidar_nerf_tpu_torch.weights import mlp_state_dict

    N = 8
    g = zero_suffix_cotangent(N, S, seed=depth + 2 * S)
    ref, calls, params, rays = jax_fused_grads(
        monkeypatch, depth, 64, S, dtype, False, True, g, N=N)
    assert calls == ["_bwd_acts_dparams"]
    sd = mlp_state_dict(params)
    ro, rd, vd, z = (torch.from_numpy(a) for a in rays)
    pts = (ro.T[:, :, None] + rd.T[:, :, None] * z[None]).reshape(3, N * S)
    dt = getattr(torch, dtype)
    kw = dict(depth=depth, width=64, multires=10, multires_views=4,
              skips=(4,))
    _, acts = f.fused_nerf_fwd_acts_plain(sd, pts, vd.T.contiguous(), S,
                                          dtype=dt, **kw)
    monkeypatch.setattr(f, "BWD_CHUNK", 3 * N * S // 8)
    got = f._bwd_split(sd, f.pack_params(sd, depth, dt), pts,
                       vd.T.contiguous(), torch.from_numpy(g).reshape(4, -1),
                       acts, S, dtype=dt, **kw)
    assert set(got) == set(ref)
    if dtype == "float32":
        grad_compare(ref, got, 1e-3)
    else:
        grad_compare_bf16(ref, got)


@pytest.mark.parametrize("dtype,depth,C,S", [("float32", 8, 19, 128),
                                             ("bfloat16", 4, 7, 64)])
def test_chunked_phases_match_jax_semantic(monkeypatch, dtype, depth, C, S):
    """Kernel 8 as the head's backward twin, then the composed phases with
    its per-ray feature cotangent, against JAX's interpreted semantic
    backward (``_bwd_acts_sem_dparams``)."""
    from depth_lidar_nerf_tpu_torch.ops import fused_mlp_t as f

    N = 8
    ref = jax_semantic(monkeypatch, depth, 128, C, S, dtype, N=N)
    sd, _, pts_t, vd_t = port_inputs(ref["params"], ref["rays"])
    dt = getattr(torch, dtype)
    kw = dict(depth=depth, width=128, multires=10, multires_views=4,
              skips=(4,))
    _, acts, _, sem_acts = f.fused_nerf_fwd_acts_sem_plain(sd, pts_t, vd_t, S,
                                                           dtype=dt, **kw)
    flat, dfeat_ray = f.sem_head_bwd_plain(torch.from_numpy(ref["gsem"]),
                                           sem_acts, f.pack_sem(sd, dt), S)
    monkeypatch.setattr(f, "BWD_CHUNK", 5 * 64)
    got = f._bwd_split(sd, f.pack_params(sd, depth, dt), pts_t, vd_t,
                       torch.from_numpy(ref["g"]).reshape(4, -1), acts, S,
                       dtype=dt, dfeat_ray=dfeat_ray, **kw)
    got.update(f.unpack_sem_grads(flat, 128, C))
    assert set(got) == set(ref["grads"])
    if dtype == "float32":
        grad_compare(ref["grads"], got, 1e-3)
    else:
        grad_compare_bf16(ref["grads"], got)


@pytest.mark.parametrize("depth,skips,multires", [(8, (4,), 10), (4, (), 10),
                                                  (3, (0, 1), 4)])
def test_wgrad_table_bookkeeping(depth, skips, multires):
    """Phase 2's table: one product per weight block that phase 1 leaves,
    each landing at its parameter's packed offset; the encoding's padded
    columns (filled with garbage here) never reach a gradient; every other
    gradient stays zero."""
    from depth_lidar_nerf_tpu_torch.models.nerf_mlp import NeRFMLP
    from depth_lidar_nerf_tpu_torch.ops import fused_mlp_t as f

    width, P, start, count = 64, 320, 128, 128
    e_p = 3 + 6 * multires
    m = NeRFMLP(depth=depth, width=width, in_channels=e_p, skips=skips,
                generator=torch.Generator().manual_seed(0))
    params = {k: v.detach() for k, v in m.named_parameters()}
    pk = f.pack_params(params, depth, torch.float32)
    gen = torch.Generator().manual_seed(1)
    acts = torch.randn(((depth + 1) * P * width + P * width // 2,),
                       generator=gen)
    cot = torch.randn((f.cot_numel(count, depth, width, multires),),
                      generator=gen)
    ents = f.wgrad_entries(acts, cot, P, start, count, depth, width, multires,
                           skips, pk.w_offsets)
    ls = f.live_skips(depth, skips)
    assert len(ents) == depth + len(ls) + 2
    n = pk.weights.numel() + pk.biases.numel()
    part = torch.zeros((1, n))
    f.bwd_weight_grads_plain(ents, part)
    got = f.unpack_grads(part[0], params, pk, depth)
    hs = [a[start:start + count]
          for a in f.split_acts(acts, P, depth, width)]
    c = f.split_cot(cot, count, depth, width, multires)
    dh, dfeat, dhv, enc = c[:depth], c[depth], c[depth + 1], c[depth + 2]
    assert enc.shape[1] == f._pad16(e_p) and all(
        e[2] == e_p for e in ents if e[0].data_ptr() == enc.data_ptr())
    want = {"trunk_0.weight": dh[0].T @ enc[:, :e_p],
            "feature.weight": dfeat.T @ hs[depth - 1],
            "views_0.weight": torch.cat([dhv.T @ hs[depth],
                                         torch.zeros((width // 2, 27))], 1)}
    for l in range(1, depth):
        t = dh[l].T @ hs[l - 1]
        want[f"trunk_{l}.weight"] = torch.cat([dh[l].T @ enc[:, :e_p], t], 1) \
            if (l - 1) in ls else t
    for k, v in got.items():
        if k in want:
            torch.testing.assert_close(v, want[k], rtol=1e-5, atol=1e-4)
        else:
            assert not v.any(), k


def test_cot_layout_and_chunk_checks(monkeypatch):
    """The cotangent buffer's views tile it exactly, in the saved
    activations' order plus the encoding; a chunk must start on a tile
    and lie within the points."""
    from depth_lidar_nerf_tpu_torch.ops import fused_mlp_t as f

    depth, width, P = 3, 64, 100
    n = f.cot_numel(P, depth, width, 10)
    cot = torch.arange(n, dtype=torch.float32)
    views = f.split_cot(cot, P, depth, width, 10)
    assert [v.shape for v in views] == [(P, width)] * (depth + 1) + [
        (P, width // 2), (P, 64)]
    assert torch.equal(torch.cat([v.reshape(-1) for v in views]), cot)
    params, pts, vd, g = _inputs(depth, width, 4, 25, 0)
    _, acts = f.fused_nerf_fwd_acts_plain(
        params, pts, vd, 4, depth=depth, width=width, multires=10,
        multires_views=4)
    part = torch.zeros((1, 10 ** 6))
    for start, count in ((32, 64), (0, 0), (64, 64)):
        with pytest.raises(ValueError, match="bad chunk"):
            f.fused_nerf_bwd_chain(params, pts, vd, g, acts, 4, start, count,
                                   part, depth=depth, width=width,
                                   multires=10, multires_views=4)
    monkeypatch.setattr(f, "BWD_CHUNK", 96)
    with pytest.raises(ValueError, match="multiple of"):
        f._bwd_split(params, f.pack_params(params, depth, torch.float32),
                     pts, vd, g, acts, 4, depth=depth, width=width,
                     multires=10, multires_views=4, dtype=torch.float32,
                     skips=())


def _exact_cot(f, params, g, acts, S, depth, width, skips, enc):
    """Phase 1's cotangents as float64 products of the bfloat16 operands,
    each rounded once, in the buffer's layout."""
    bf = torch.bfloat16
    w, _ = f._plain_weights(params, bf)
    P = g.shape[1]
    hs = [a.float() for a in f.split_acts(acts, P, depth, width)]
    gb = g.to(bf).float()
    e_p = enc.shape[1]

    def lin(x, wl, gate=None, extra=None):
        z = x.double() @ wl.double()
        if extra is not None:
            z = z + extra.double()
        if gate is not None:
            z = torch.where(gate > 0, z, 0.0)
        return z.float().to(bf).float()

    dhv = lin(gb[:3].T, w("rgb"), hs[depth + 1])
    dfeat = lin(dhv, w("views_0")[:, :width])
    dh, x = [None] * depth, dfeat
    for l in range(depth - 1, -1, -1):
        if l == depth - 1:
            x = lin(x, w("feature"), hs[l], gb[3][:, None] * w("sigma"))
        else:
            wl = w(f"trunk_{l + 1}")
            x = lin(x, wl[:, e_p:] if l in f.live_skips(depth, skips) else wl,
                    hs[l])
        dh[l] = x
    enc16 = torch.nn.functional.pad(enc, (0, f._pad16(e_p) - e_p))
    return torch.cat([a.to(bf).reshape(-1) for a in dh + [dfeat, dhv, enc16]])


@pytest.mark.parametrize("depth,S,skips", [(4, 64, ()), (8, 16, (4,))])
def test_bwd_product_witness_on_cpu(depth, S, skips):
    """Cotangents rounded once from float64 products are exact for the
    witness in every layer; one moved by a bfloat16 step counts as one off
    its layer; a layer in another column order is off wherever its gates
    are open.
    Weight gradients formed in float64 from the buffer's operands are
    within float32 rounding of the witness; one element moved by 1% of the
    block's max is seen."""
    from depth_lidar_nerf_tpu_torch.ops import fused_mlp_t as f

    N, width = 16, 128
    params, pts, vd, g = _inputs(depth, width, S, N, depth + S)
    kw = dict(depth=depth, width=width, multires=10, skips=skips)
    _, acts, enc, _ = f._forward_plain(params, pts, vd, S, depth, width, 10,
                                       4, torch.bfloat16, skips)
    acts = torch.cat([a.to(torch.bfloat16).reshape(-1) for a in acts])
    cot = _exact_cot(f, params, g, acts, S, depth, width, skips, enc)
    P = N * S
    c = f.split_cot(cot, P, depth, width, 10)
    exact = {"trunk_0.weight": c[0].double().T @ c[depth + 2][:, :63].double(),
             "feature.weight": c[depth].double().T @ f.split_acts(
                 acts, P, depth, width)[depth - 1].double()}
    grads = {k: torch.zeros_like(v) for k, v in params.items()}
    for k, v in exact.items():
        grads[k] = v.float()
    got = f.bwd_product_witness(params, g, acts, cot, grads, S, **kw)
    assert got["kernel"] == [0.0] * (depth + 2)
    assert len(got["float32"]) == depth + 2
    for k in exact:
        assert got["wgrad_kernel"][k] < 1e-6, k
    assert got["wgrad_kernel"]["trunk_1.weight"] >= 1.0  # a zero gradient

    n = P * width
    bumped = cot.clone()
    i = int(torch.nonzero(cot[:n])[0])  # dh_0's first nonzero
    bumped.view(torch.int16)[i] += 1
    moved = f.bwd_product_witness(params, g, acts, bumped, grads, S, **kw)
    assert moved["kernel"] == [0.0] * (depth + 1) + [1 / n]
    swapped = cot.clone()
    layer = swapped[(depth - 1) * n:depth * n].view(P, width)
    layer[:] = layer.flip(1)
    open_share = (layer != 0).float().mean().item()
    assert f.bwd_product_witness(params, g, acts, swapped, grads, S,
                                 **kw)["kernel"][2] > 0.5 * open_share > 0.05
    off = {k: v.clone() for k, v in grads.items()}
    off["feature.weight"][3, 5] += 0.01 * exact["feature.weight"].abs().max()
    assert f.bwd_product_witness(params, g, acts, cot, off, S, **kw)[
        "wgrad_kernel"]["feature.weight"] > 1e-3


def test_split_route_on_cpu_is_the_twin():
    """On the CPU, kernels 5 and 8's wrappers run their twins, as before
    (the split is the card's bfloat16 route); neither phase's counter
    moves."""
    from depth_lidar_nerf_tpu_torch.ops import fused_mlp_t as f

    params, pts, vd, g = _inputs(4, 64, 16, 8, 3)
    kw = dict(depth=4, width=64, multires=10, multires_views=4,
              dtype=torch.bfloat16, skips=(4,))
    _, acts = f.fused_nerf_fwd_acts_plain(params, pts, vd, 16, **kw)
    n0 = (f.fused_nerf_bwd_chain.launches, f.bwd_weight_grads.launches)
    got = f.fused_nerf_bwd_acts(params, pts, vd, g, acts, 16, **kw)
    ref = f.fused_nerf_bwd_acts_plain(params, pts, vd, g, acts, 16, **kw)
    assert all(torch.equal(got[k], ref[k]) for k in ref)
    assert (f.fused_nerf_bwd_chain.launches,
            f.bwd_weight_grads.launches) == n0


@pytest.mark.parametrize("depth,width", [(4, 256), (8, 128)])
def test_backward_tc_rows_permute_each_16_run(depth, width):
    """``pack_params``' ``weights_ip`` (the B rows of the bfloat16 backward's
    input products, ``tc_mac_in``) is ``weights`` at the same offsets with
    each run of 16 outputs of a row in ``TC_KPERM`` order, where a layer's
    outputs are a multiple of 16 (sigma and rgb as they are); none in
    float32. Lane t of a quad then finds k = 2t, 2t + 1, 2t + 8, 2t + 9 at
    positions 4t .. 4t + 3 of a run."""
    from depth_lidar_nerf_tpu_torch.models.nerf_mlp import NeRFMLP
    from depth_lidar_nerf_tpu_torch.ops import fused_mlp_t as f

    m = NeRFMLP(depth=depth, width=width, skips=(4,),
                generator=torch.Generator().manual_seed(depth))
    params = dict(m.named_parameters())
    assert f.pack_params(params, depth, torch.float32).weights_ip is None
    pk = f.pack_params(params, depth, torch.bfloat16)
    wi = pk.weights_ip
    assert wi.dtype == torch.bfloat16 and wi.numel() == pk.weights.numel()
    assert [f.TC_KPERM[4 * t:4 * t + 4]
            for t in range(4)] == [(2 * t, 2 * t + 1, 2 * t + 8, 2 * t + 9)
                                   for t in range(4)]
    for i, name in enumerate(f._layer_names(depth)):
        n_out, n_in = params[f"{name}.weight"].shape
        o = pk.w_offsets[i]
        nat = pk.weights[o:o + n_in * n_out].view(n_in, n_out)
        got = wi[o:o + n_in * n_out].view(n_in, n_out)
        if n_out % 16:
            assert torch.equal(got, nat), name
            continue
        runs = got.view(n_in, n_out // 16, 16)
        assert torch.equal(runs, nat.view(n_in, n_out // 16, 16)[
            ..., list(f.TC_KPERM)]), name
