"""Kernels 12 and 13's bfloat16 tensor-core layout on the CPU (the packed-lane
MLP, ``ops/fused_mlp.py``): the split backward's phase twins (phase 1, the
chain ``fused_packed_chain_plain``; phase 2, ``packed_wgrad_entries``'
products) composed over chunks by ``_packed_bwd_split``, against the plain
backward and against JAX's interpreted ``_vjp_bwd``; phase 2's table; the
tensor-core B rows (``tc_weights``) read lane by lane as ``tc_mac`` and
``tc_mac_in`` read them, for the first layer, the feature and sigma tile of
``W + 8`` columns, the view layer's 16-lane runs, the rgb tile and the
chain's input products; the float64 witnesses of both kernels on exactly
rounded values.

Tolerances: the composition against the plain backward 1e-6 of each
gradient's max abs (the same float32 products; only the order of the sums
over chunks differs); against JAX the step tests' metrics (float32
``grad_compare`` below 1e-3, bfloat16 relative L2 below 3e-2). The lane-by-
lane emulation sums each 16-k run in float64 and is compared at 1e-12 of
the product's scale: a fragment read from a wrong row or lane moves an
output by the size of a product."""

import numpy as np
import pytest
import torch

from torch_port_packed_helpers import raw_pair
from torch_port_train_helpers import grad_compare, grad_compare_bf16

E_P, E_V = 63, 27


def _packed_inputs(depth, width, N, S, dtype, seed=0, multires=10,
                   multires_views=4):
    from depth_lidar_nerf_tpu_torch.models.nerf_mlp import NeRFMLP
    from depth_lidar_nerf_tpu_torch.ops import fused_mlp as fm

    e_p, e_v = 3 + 6 * multires, 3 + 6 * multires_views
    m = NeRFMLP(depth=depth, width=width, in_channels=e_p,
                in_channels_views=e_v,
                generator=torch.Generator().manual_seed(seed))
    with torch.no_grad():
        m.sigma.bias += 0.5
    params = {k: v.detach() for k, v in m.named_parameters()}
    rng = np.random.default_rng(seed)
    pts = torch.from_numpy(rng.uniform(-1, 1, (N, S, 3)).astype(np.float32))
    vd = torch.nn.functional.normalize(torch.from_numpy(
        rng.normal(size=(N, 3)).astype(np.float32)), dim=-1)
    x = fm.pack_encoding(pts, vd, multires, multires_views, dtype)
    ws = fm.pack_params(params, depth, e_p, e_v, dtype)
    g = torch.from_numpy(rng.normal(size=(N * S, 8)).astype(np.float32))
    return params, x, ws, g


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("depth", [1, 2, 4])
@pytest.mark.parametrize("S,N", [(8, 100), (64, 10)])
def test_chunked_phases_equal_plain(monkeypatch, depth, S, N, dtype):
    """Chunks of 4 tiles (a ragged last one) through the phase twins give
    the plain backward's gradients; phase 1's buffers hold the chunk's
    activations and cotangents in ``split_acts``' layout."""
    from depth_lidar_nerf_tpu_torch.ops import fused_mlp as fm
    from depth_lidar_nerf_tpu_torch.ops import fused_mlp_t as f

    width = 128
    params, x, ws, g = _packed_inputs(depth, width, N, S, dtype, seed=depth + S)
    monkeypatch.setattr(f, "BWD_CHUNK", 256)
    P = x.shape[0]
    assert P % 256 and P > 512  # three or more chunks, the last ragged
    got = fm._packed_bwd_split(ws, x, g, depth=depth, e_p=E_P, e_v=E_V,
                               dtype=dtype)
    ref = fm.fused_packed_bwd_plain(ws, x, g, depth, dtype, e_p=E_P, e_v=E_V)
    assert [t.shape for t in got] == [t.shape for t in ref]
    gu, ru = (fm.unpack_grads(d, params, depth, E_P, E_V) for d in (got, ref))
    for k, r in ru.items():
        err = (gu[k] - r).abs().max().item()
        assert err <= 1e-6 * r.abs().max().item(), (k, err)

    acts, cot, _, hv = fm.fused_packed_chain_plain(
        ws, x, g, 256, 256, depth=depth, e_p=E_P, e_v=E_V, dtype=dtype)
    assert (acts.numel(), cot.numel()) == fm.chunk_numel(256, depth, width)
    _, (h, feat, _, hv_ref) = fm._forward_tile(depth, dtype, x[256:512], ws)
    for a, b in zip(acts.view(depth + 1, 256, width), h + [feat]):
        assert torch.equal(a, b.to(dtype))
    assert torch.equal(hv.view(256, width // 2), hv_ref.to(dtype))
    *_, dhv, dfeat, dhs = fm._backward_chain(ws, x[256:512], g[256:512],
                                             depth, dtype, E_P, E_V)
    for a, b in zip(f.split_acts(cot, 256, depth, width), dhs + [dfeat, dhv]):
        assert torch.equal(a, b)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("depth", [1, 2, 4])
@pytest.mark.parametrize("S", [8, 64])
def test_split_matches_jax(monkeypatch, depth, S, dtype):
    """``fused_nerf_apply_raw``'s gradients with kernel 13 as the split
    backward (chunks of 512 points, 4 per TPU tile) against JAX's
    interpreted kernels."""
    from depth_lidar_nerf_tpu_torch.ops import fused_mlp as fm
    from depth_lidar_nerf_tpu_torch.ops import fused_mlp_t as f

    monkeypatch.setattr(f, "BWD_CHUNK", 512)
    calls = []

    def split(ws, x, g, **kw):
        calls.append(x.shape[0])
        return fm._packed_bwd_split(ws, x, g, **kw)

    monkeypatch.setattr(fm, "fused_packed_bwd", split)
    N = 2048 // S
    ref, got, jg, tg = raw_pair(monkeypatch, depth, S, N, dtype)
    assert calls == [2048]
    if dtype == "float32":
        np.testing.assert_allclose(got, ref, rtol=1e-4, atol=1e-5)
        grad_compare(jg, tg, 1e-3)
    else:
        grad_compare_bf16(jg, tg, 3e-2)


@pytest.mark.parametrize("depth", [1, 2, 4])
@pytest.mark.parametrize("multires,multires_views", [(10, 4), (4, 2), (10, 10)])
def test_packed_wgrad_table_bookkeeping(depth, multires, multires_views):
    """Phase 2's table: one product per large weight block, each at its
    tensor's offset in the gradient row (d(W1) keeping e_p rows, d(WFS) at
    row stride W + 8, d(WV) at its feature rows and at the rows of the view
    runs), a-operands on 16-byte boundaries of the packed input, and every
    kept row of the unpacked gradients formed."""
    from depth_lidar_nerf_tpu_torch.ops import fused_mlp as fm
    from depth_lidar_nerf_tpu_torch.ops import fused_mlp_t as f

    width, P, start, count = 64, 320, 128, 128
    e_p, e_v = 3 + 6 * multires, 3 + 6 * multires_views
    params, x, ws, _ = _packed_inputs(depth, width, 40, 8, torch.bfloat16,
                                      multires=multires,
                                      multires_views=multires_views)
    assert x.shape[0] == P
    gen = torch.Generator().manual_seed(1)
    acts, cot = (torch.randn((n,), generator=gen).to(torch.bfloat16)
                 for n in fm.chunk_numel(count, depth, width))
    g_at = fm.grad_offsets(ws)
    ents = fm.packed_wgrad_entries(x, acts, cot, start, count, depth, width,
                                   e_p, e_v, g_at)
    assert len(ents) == depth + 3
    v0, v1 = fm.view_runs(e_p, e_v)
    assert v0 % 8 == 0 and v0 <= e_p < v1 and e_p + e_v <= v1 <= 128
    n_b = 2 * (depth - 1)
    wv_at = g_at[n_b + 4]
    outs = [g_at[0]] + [g_at[1 + li] for li in range(1, depth)] \
        + [g_at[n_b + 2], wv_at, wv_at + (width + v0) * (width // 2)]
    assert [e[3] for e in ents] == outs
    assert [e[4] for e in ents] == [width] * depth + [width + 8, width // 2,
                                                      width // 2]
    assert ents[0][2] == e_p and ents[-1][2] == v1 - v0
    for a, b, m_keep, out, ldo in ents:
        assert a.shape[0] == b.shape[0] == count
        assert a.stride(1) == b.stride(1) == 1
        assert (a.storage_offset() * 2) % 16 == 0 and (a.stride(0) * 2) % 16 == 0
        assert a.shape[1] % 8 == 0 and m_keep <= a.shape[1]
        assert out + (m_keep - 1) * ldo + b.shape[1] <= g_at[-1] + ws[-1].numel()
    # The view entry's rows end inside d(WV).
    assert (width + v1) * (width // 2) <= ws[n_b + 4].numel()

    n = g_at[-1] + ws[-1].numel()
    part = torch.zeros((1, n))
    f.bwd_weight_grads_plain(ents, part)
    got = fm.unpack_grads(fm._grad_list(part[0], [t.shape for t in ws]),
                          params, depth, e_p, e_v)
    hs = acts.float().view(depth + 1, count, width)
    cs = [c.float() for c in f.split_acts(cot, count, depth, width)]
    xc = x[start:start + count].float()
    want = {"trunk_0.weight": cs[0].T @ xc[:, :e_p],
            "feature.weight": cs[depth].T @ hs[depth - 1],
            "views_0.weight": torch.cat([cs[depth + 1].T @ hs[depth],
                                         cs[depth + 1].T @ xc[:, e_p:e_p + e_v]], 1)}
    for li in range(1, depth):
        want[f"trunk_{li}.weight"] = cs[li].T @ hs[li - 1]
    for k, v in got.items():
        if k in want:
            torch.testing.assert_close(v, want[k], rtol=1e-5, atol=1e-4)
        else:
            assert not v.any(), k


def _mma_emulate(in_kp, rows, ldk, n0, n_tiles):
    """``tc_mac`` / ``tc_mac_in`` emulated lane by lane: the shared array
    ``in_kp`` ([K][64] float64, K a multiple of 16) times the B rows
    ``rows`` (flat float64: row n at ``n ldk``, lane (gq, t) loading the
    8-byte word at ``4 t`` of each 16-k run of row ``n0 + 8 nt + gq``) for
    the columns ``n0 .. n0 + 8 n_tiles - 1``. The A and B tiles of each
    m16n8k16 step are assembled from the lanes' fragments as the PTX
    contract places them, each step's 16 products summed from zero in
    float64 and added in k order. Returns ``[64, 8 n_tiles]``."""
    K = in_kp.shape[0]
    n_steps = K // 16
    steps = torch.arange(n_steps) * 16
    A = torch.full((4, n_steps, 16, 16), float("nan"), dtype=torch.float64)
    B = torch.full((n_tiles, n_steps, 16, 8), float("nan"), dtype=torch.float64)
    for lane in range(32):
        gq, t = divmod(lane, 4)
        ks = (2 * t, 2 * t + 1, 2 * t + 8, 2 * t + 9)
        for mt in range(4):
            for h in range(2):
                for k in ks:  # a[k kLD + 16 mt + gq + 8 h]
                    A[mt, :, gq + 8 * h, k] = in_kp[steps + k, 16 * mt + gq + 8 * h]
        for nt in range(n_tiles):
            base = (n0 + 8 * nt + gq) * ldk + steps + 4 * t
            for j, k in enumerate(ks):
                B[nt, :, k, gq] = rows[base + j]
    assert not A.isnan().any() and not B.isnan().any()
    C = torch.zeros((4, n_tiles, 16, 8), dtype=torch.float64)
    for st in range(n_steps):
        C += A[:, None, st] @ B[None, :, st]
    # lane (gq, t) holds C[mt][nt][gq + 8 h][2 t + j]: point 16 mt + gq + 8 h,
    # column n0 + 8 nt + 2 t + j
    return C.permute(0, 2, 1, 3).reshape(64, 8 * n_tiles)


def _rand_bf16(shape, gen, relu=False):
    v = torch.randn(shape, generator=gen)
    return (v.relu() if relu else v).to(torch.bfloat16).double()


@pytest.mark.parametrize("width", [128, 256])
@pytest.mark.parametrize("multires,multires_views", [(10, 4), (4, 2)])
def test_forward_tc_rows_lane_by_lane(width, multires, multires_views):
    """Kernel 12's tensor-core products from ``tc_weights``' rows, as the
    lanes read them: the first layer over the lanes below pad16(e_p), each
    trunk layer, the feature and sigma tile of W + 8 columns, the view layer
    over [feat | the view runs] and the rgb tile, each equal to JAX's full
    product (the runs skipped hold only zero rows)."""
    from depth_lidar_nerf_tpu_torch.ops import fused_mlp as fm

    depth = 4
    e_p, e_v = 3 + 6 * multires, 3 + 6 * multires_views
    params, x, ws, _ = _packed_inputs(depth, width, 8, 8, torch.bfloat16,
                                      multires=multires,
                                      multires_views=multires_views)
    kw = fm.kernel_weights(ws, depth, e_p, e_v)
    o = list(kw.offsets)[34:]
    rows = kw.weights_p.double()
    w1, _, tw, _, wfs, _, wv, _, wr, _ = fm._split(ws, depth)
    ep16 = -(-e_p // 16) * 16
    v0, v1 = fm.view_runs(e_p, e_v)
    gen = torch.Generator().manual_seed(width)
    xd = x.double()
    h = _rand_bf16((64, width), gen, relu=True)
    feat = _rand_bf16((64, width), gen)
    hv = _rand_bf16((64, width // 2), gen, relu=True)
    cases = [(xd[:, :ep16], o[0], ep16, width, xd @ w1.double())]
    cases += [(h, o[1 + i], width, width, h @ tw[i].double()) for i in range(3)]
    cases += [(h, o[4], width, width + 8, h @ wfs.double()),
              (torch.cat([feat, xd[:, v0:v1]], 1), o[5], width + v1 - v0,
               width // 2, torch.cat([feat, xd], 1) @ wv.double()),
              (hv, o[6], width // 2, 8, hv @ wr.double())]
    for a, off, ldk, n, want in cases:
        got = _mma_emulate(a.T.contiguous(), rows[off:], ldk, 0, n // 8)
        assert (got - want).abs().max() <= 1e-12 * want.abs().max(), (off, ldk)
    # the sigma column rides the n8 tile that starts at column W (warp 0)
    sig = _mma_emulate(h.T.contiguous(), rows[o[4]:], width, width, 1)
    assert torch.equal(sig[:, [0, 1, 2, 4, 5, 6, 7]],
                       torch.zeros((64, 7), dtype=torch.float64))
    torch.testing.assert_close(sig[:, 3], h @ wfs[:, width + 3].double(),
                               rtol=1e-12, atol=0)
    sizes = [width * ep16] + [width * width] * 3 + [
        (width + 8) * width, width // 2 * (width + v1 - v0), 8 * width // 2]
    assert o[:7] == list(np.cumsum([0] + sizes[:-1]))


@pytest.mark.parametrize("width", [128, 256])
def test_input_rows_lane_by_lane(width):
    """The chain's tensor-core input products from ``tc_weights``' rows, as
    ``tc_mac_in``'s lanes read them (warp ty taking the W / 8 inputs from
    ty W / 8): dfeat = dhv WV[:W]^T, dh = dfeat WFS[:, :W]^T and dh TW_l^T."""
    from depth_lidar_nerf_tpu_torch.ops import fused_mlp as fm

    depth = 4
    _, _, ws, _ = _packed_inputs(depth, width, 8, 8, torch.bfloat16)
    kw = fm.kernel_weights(ws, depth, E_P, E_V)
    o = list(kw.offsets)[41:]
    rows = kw.weights_p.double()
    _, _, tw, _, wfs, _, wv, _, _, _ = fm._split(ws, depth)
    gen = torch.Generator().manual_seed(width)
    dhv = _rand_bf16((64, width // 2), gen)
    dy = _rand_bf16((64, width), gen)
    cases = [(dhv, o[4], width // 2, dhv @ wv[:width].double().T),
             (dy, o[3], width, dy @ wfs[:, :width].double().T)]
    cases += [(dy, o[i], width, dy @ tw[i].double().T) for i in range(3)]
    for a, off, ldk, want in cases:
        got = torch.cat([_mma_emulate(a.T.contiguous(), rows[off:], ldk,
                                      ty * width // 8, width // 64)
                         for ty in range(8)], 1)
        assert (got - want).abs().max() <= 1e-12 * want.abs().max(), off
    assert kw.weights_p.numel() == o[4] + width * width // 2


def _exact_chain(ws, x, g, depth):
    """Kernel 12's activations and the chain's cotangents from float64
    products of bfloat16 operands, each rounded once (as the witnesses
    recompute them), as phase 1's buffers: activations, hv, cotangents."""
    from depth_lidar_nerf_tpu_torch.ops import fused_mlp as fm

    w1, b1, tw, tb, wfs, bfs, wv, bv, wr, br = (
        None if t is None else t for t in fm._split(ws, depth))
    W = wfs.shape[0]

    def rnd(z):
        return z.float().to(torch.bfloat16).float().double()

    d = torch.float64
    xd = x.to(d)
    h = rnd(torch.relu(xd @ w1.to(d) + b1.to(d)))
    hs = [h]
    for i in range(depth - 1):
        h = rnd(torch.relu(h @ tw[i].to(d) + tb[i].to(d)))
        hs.append(h)
    feat = rnd(h @ wfs[:, :W].to(d) + bfs[:, :W].to(d))
    hv = rnd(torch.relu(torch.cat([feat, xd], 1) @ wv.to(d) + bv.to(d)))
    gb = rnd(g)
    dhv = rnd(torch.where(hv > 0, gb[:, :3] @ wr[:, :3].to(d).T, 0.0))
    dfeat = rnd(dhv @ wv[:W].to(d).T)
    dh = dfeat @ wfs[:, :W].to(d).T + gb[:, 3:4] * wfs[:, W + 3].to(d)
    dhs = [None] * depth
    for li in range(depth - 1, -1, -1):
        dhs[li] = rnd(torch.where(hs[li] > 0, dh, 0.0))
        if li:
            dh = dhs[li] @ tw[li - 1].to(d).T
    def flat(ts):
        return torch.cat([t.to(torch.bfloat16).reshape(-1) for t in ts])

    return flat(hs + [feat]), flat([hv]), flat(dhs + [dfeat, dhv])


@pytest.mark.parametrize("depth", [1, 2, 4])
def test_packed_witnesses_on_cpu(depth):
    """Activations and cotangents rounded once from float64 products are
    exact for both witnesses in every layer; one moved by one bfloat16 step
    counts as one off its layer; a layer whose channels come in another
    order is off nearly everywhere. The float32 shares are reported per
    layer too."""
    from depth_lidar_nerf_tpu_torch.ops import fused_mlp as fm

    width, N, S = 128, 16, 16
    _, x, ws, g = _packed_inputs(depth, width, N, S, torch.bfloat16, seed=depth)
    acts, hv, cot = _exact_chain(ws, x, g, depth)
    P, n = N * S, N * S * width
    fw = fm.packed_fwd_witness(ws, x, acts, hv, depth, E_P, E_V)
    bw = fm.packed_bwd_witness(ws, g, acts, hv, cot, depth)
    assert fw["kernel"] == [0.0] * (depth + 2) and len(fw["float32"]) == depth + 2
    assert bw["kernel"] == [0.0] * (depth + 2) and len(bw["float32"]) == depth + 2

    def bumped(buf, layer):
        b = buf.clone()
        i = layer * n + int(torch.nonzero(buf[layer * n:(layer + 1) * n])[0])
        b.view(torch.int16)[i] += 1  # one bfloat16 step up
        return b

    def swapped(buf, layer):
        b = buf.clone()
        blk = b[layer * n:(layer + 1) * n].view(P, width)
        blk[:] = blk.flip(1)
        return b

    moved = fm.packed_fwd_witness(ws, x, bumped(acts, 1), hv, depth, E_P, E_V)
    assert moved["kernel"][:2] == [0.0, 1 / n]
    assert fm.packed_fwd_witness(ws, x, swapped(acts, 1), hv, depth, E_P,
                                 E_V)["kernel"][1] > 0.5
    # cotangent layer dfeat (buffer layer D) is the witness's second entry
    moved = fm.packed_bwd_witness(ws, g, acts, hv, bumped(cot, depth), depth)
    assert moved["kernel"][:2] == [0.0, 1 / n]
    assert fm.packed_bwd_witness(ws, g, acts, hv, swapped(cot, depth),
                                 depth)["kernel"][1] > 0.5
