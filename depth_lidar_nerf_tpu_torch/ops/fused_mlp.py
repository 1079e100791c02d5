"""The v3 packed-lane fused NeRF MLP (port of ``ops/fused_mlp.py``): kernels 12
and 13, for raw queries at arbitrary points (the DS-NeRF sigma loss, the
probing API).

The Pallas kernels it replaces take ONE packed encoding per point, ``[P,
128]`` in the compute dtype: the positional encoding of the point in lanes
``0..e_p-1``, that of its ray's view direction in ``e_p..e_p+e_v-1``, zeros
after. Their weights are a packed list (:func:`pack_params`) in which the
first layer reads the packed lanes through zero rows, sigma rides the
feature product as column ``W + 3`` of a ``[W, W + 8]`` weight, and the view
layer reads ``[feat | packed]``; they write ``[P, 8]`` float32 (rgb 0-2,
sigma 3). The backward recomputes the forward and returns float32 weight
gradients in the packed layout (:func:`unpack_grads`) and zero input
cotangents. Here:

====  ==================  ==================================  =========================
 #    Pallas kernel       CUDA kernel (csrc/)                 wrapper
====  ==================  ==================================  =========================
12    ``_fwd_kernel``     ``fused_nerf_packed.cu`` forward    :func:`fused_packed_fwd`
13    ``_bwd_kernel``     ``fused_nerf_packed.cu`` backward   :func:`fused_packed_bwd`
====  ==================  ==================================  =========================

Each wrapper launches its kernel for CUDA tensors and runs its plain PyTorch
twin (``*_plain``, the TPU kernel's arithmetic step by step with its casts)
for CPU tensors; ``<wrapper>.launches`` counts kernel launches. Kernel 13's
per-block partial gradients are summed by ``fused_nerf_grad_reduce``
(:func:`ops.fused_mlp_t.grad_reduce`). :class:`FusedPacked` pairs them under
autograd and :func:`fused_nerf_apply_raw` is the entry point.

In bfloat16 on the card both kernels form their products on the tensor
cores (csrc/fused_nerf_packed.cu's note), reading their B operands from
:attr:`KernelWeights.weights_p`, and kernel 13 is split as kernel 5 is
(:func:`ops.fused_mlp_t._bwd_split`): per chunk of ``fused_mlp_t.BWD_CHUNK``
points, phase 1 (:func:`fused_packed_chain`: the recompute, the bfloat16
activations and cotangents, the small gradients) and phase 2
(:func:`ops.fused_mlp_t.bwd_weight_grads` on :func:`packed_wgrad_entries`:
every large weight gradient through ``fused_nerf_wgrad_kernel``, counted in
``packed_wgrad.launches``), then one reduction. Their bfloat16 twins on the
card form each bfloat16 product in the kernels' 16-k runs
(:func:`ops.fused_mlp_t._tc_mm`) and read the same runs of the packed lanes;
on the CPU they multiply in float32, as the JAX package's reference does.
Accuracy is held by float64 witnesses that share no summation order with the
kernels (:func:`packed_fwd_witness`, :func:`packed_bwd_witness`).

``params`` is a mapping of :class:`~models.nerf_mlp.NeRFMLP` parameter names
to float32 tensors, as in :mod:`ops.fused_mlp_t`.
"""

from __future__ import annotations

import ctypes
from types import SimpleNamespace
from typing import Dict, List, Mapping, NamedTuple

import torch

from depth_lidar_nerf_tpu_torch.ops import _build
from depth_lidar_nerf_tpu_torch.ops import fused_mlp_t
from depth_lidar_nerf_tpu_torch.ops.embedding import positional_encoding
from depth_lidar_nerf_tpu_torch.utils.tracing import (count_split_call,
                                                     register_launches)

KERNEL = "fused_nerf_packed"
_PTR, _INT = ctypes.c_void_p, ctypes.c_int
ARGTYPES = {
    # (x, w, wp, b, off, out, P, depth, width, e_p, e_v, bf16, stream)
    "fused_nerf_packed_fwd_launch": [_PTR] * 6 + [_INT] * 6 + [_PTR],
    # (x, g, w, b, off, scratch, part, part_stride, G, P, depth, width, e_p,
    #  e_v, stream)
    "fused_nerf_packed_bwd_launch": [_PTR] * 7 + [ctypes.c_longlong]
    + [_INT] * 6 + [_PTR],
    # (x, g, w, wp, b, off, acts, cot, hv, part, part_stride, G, c0, count, P,
    #  depth, width, e_p, e_v, stream)
    "fused_nerf_packed_chain_launch": [_PTR] * 10 + [ctypes.c_longlong]
    + [_INT] * 8 + [_PTR],
}
# The JAX package's constants (ops/fused_mlp.py): points per TPU grid step,
# output columns and packed lanes.
TILE = 2048
OUT = 8
PACK = 128
_MAX_DEPTH = 4
_DTYPES = (torch.float32, torch.bfloat16)


def _enc_dims(multires: int, multires_views: int):
    return 3 + 6 * multires, 3 + 6 * multires_views


def view_runs(e_p: int, e_v: int):
    """The packed lanes ``[v0, v1)`` that the bfloat16 view layer reads: the
    16-lane runs from the one that holds lane ``e_p`` (the first view lane)
    to ``pad16(e_p + e_v)`` (csrc/fused_nerf_packed.cu ``view_run0``).
    ``pack_params``' view-layer rows of the other lanes in them are zero."""
    return e_p // 16 * 16, fused_mlp_t._pad16(e_p + e_v)


def supports(params: Mapping[str, torch.Tensor], use_viewdirs: bool,
             num_semantic: int, depth: int, width: int, S: int,
             multires: int, multires_views: int, skips=()) -> bool:
    """JAX ``fused_mlp.supports``: trunk depth 1-4 with no skip concat inside
    it (a skip at ``depth - 1`` feeds the heads, which no kernel covers),
    view directions on, no semantic head, width 128 or 256, the two
    encodings within the 128 packed lanes, and ``S`` dividing the 2,048-point
    TPU tile (``S = -1`` defers that check to the call)."""
    if not use_viewdirs or num_semantic > 0 or depth > _MAX_DEPTH or depth < 1:
        return False
    if any(0 <= s < depth for s in (skips or ())):
        return False
    if S != -1 and (S <= 0 or TILE % S != 0):
        return False
    e_p, e_v = _enc_dims(multires, multires_views)
    if e_p + e_v > PACK or "semantic_0.weight" in params:
        return False
    if params["trunk_0.weight"].shape[1] != e_p:
        return False
    if params["views_0.weight"].shape[1] != width + e_v:
        return False
    return params["trunk_0.weight"].shape[0] == width and width in (128, 256)


# ----------------------------------------------------------------- packing

def pack_params(params: Mapping[str, torch.Tensor], depth: int, e_p: int,
                e_v: int, dtype, device=None) -> List[torch.Tensor]:
    """JAX ``_pack_params``: ``[w1, b1, *tw, *tb, wfs, bfs, wv, bv, wr, br]``
    with weights ``[in, out]`` in ``dtype`` and biases ``[1, n]`` float32:
    ``w1 [128, W]`` zero past row ``e_p``; ``wfs [W, W + 8]`` with the
    sigma kernel in column ``W + 3`` (``bfs`` likewise); ``wv [W + 128, W /
    2]`` with the view rows at ``W + e_p``; ``wr [W / 2, 8]``."""
    def k(name):  # Flax kernel [in, out]
        return params[f"{name}.weight"].detach().to(device).t().to(dtype)

    def b(name):
        return params[f"{name}.bias"].detach().to(device).float()

    W = params["trunk_0.weight"].shape[0]
    dev = params["trunk_0.weight"].device if device is None else device
    w1 = torch.zeros((PACK, W), dtype=dtype, device=dev)
    w1[:e_p] = k("trunk_0")
    tw = [k(f"trunk_{i}") for i in range(1, depth)]
    tb = [b(f"trunk_{i}")[None] for i in range(1, depth)]
    wfs = torch.zeros((W, W + OUT), dtype=dtype, device=dev)
    wfs[:, :W] = k("feature")
    wfs[:, W + 3:W + 4] = k("sigma")
    bfs = torch.zeros((1, W + OUT), dtype=torch.float32, device=dev)
    bfs[0, :W] = b("feature")
    bfs[0, W + 3] = b("sigma")[0]
    wv_flax = k("views_0")  # [W + e_v, W / 2]
    wv = torch.zeros((W + PACK, W // 2), dtype=dtype, device=dev)
    wv[:W] = wv_flax[:W]
    wv[W + e_p:W + e_p + e_v] = wv_flax[W:]
    wr = torch.nn.functional.pad(k("rgb"), (0, OUT - 3))
    br = torch.zeros((1, OUT), dtype=torch.float32, device=dev)
    br[0, :3] = b("rgb")
    return [w1, b("trunk_0")[None], *tw, *tb, wfs, bfs, wv, b("views_0")[None],
            wr, br]


def _split(ws, depth):
    """JAX ``_unflatten``: (w1, b1, tw, tb, wfs, bfs, wv, bv, wr, br)."""
    w1, b1 = ws[0], ws[1]
    tw = list(ws[2:2 + depth - 1])
    tb = list(ws[2 + depth - 1:2 + 2 * (depth - 1)])
    wfs, bfs, wv, bv, wr, br = ws[2 + 2 * (depth - 1):]
    return w1, b1, tw, tb, wfs, bfs, wv, bv, wr, br


def unpack_grads(dws, params: Mapping[str, torch.Tensor], depth: int,
                 e_p: int, e_v: int) -> Dict[str, torch.Tensor]:
    """JAX ``_unpack_grads``: the packed float32 gradients -> the parameter
    mapping (weights ``[out, in]``); the rows and columns that
    :func:`pack_params` zero-filled are dropped."""
    W = params["trunk_0.weight"].shape[0]
    dw1, db1, dtw, dtb, dwfs, dbfs, dwv, dbv, dwr, dbr = _split(dws, depth)
    out = {"trunk_0.weight": dw1[:e_p].t(), "trunk_0.bias": db1[0]}
    for i in range(1, depth):
        out[f"trunk_{i}.weight"] = dtw[i - 1].t()
        out[f"trunk_{i}.bias"] = dtb[i - 1][0]
    out["feature.weight"] = dwfs[:, :W].t()
    out["feature.bias"] = dbfs[0, :W]
    out["sigma.weight"] = dwfs[:, W + 3:W + 4].t()
    out["sigma.bias"] = dbfs[0, W + 3:W + 4]
    out["views_0.weight"] = torch.cat([dwv[:W], dwv[W + e_p:W + e_p + e_v]]).t()
    out["views_0.bias"] = dbv[0]
    out["rgb.weight"] = dwr[:, :3].t()
    out["rgb.bias"] = dbr[0, :3]
    return {k: v.contiguous() for k, v in out.items()}


def pack_encoding(pts: torch.Tensor, viewdirs: torch.Tensor, multires: int,
                  multires_views: int, dtype) -> torch.Tensor:
    """The kernels' input (JAX ``fused_nerf_apply_raw``): the float32
    positional encodings of ``pts [N, S, 3]`` and of ``viewdirs [N, 3]``
    (broadcast over each ray's samples), cast to ``dtype`` and zero-padded to
    128 lanes, ``[N * S, 128]``."""
    N, S, _ = pts.shape
    e_p, e_v = _enc_dims(multires, multires_views)
    pe = positional_encoding(pts.float(), multires).to(dtype)
    ve = positional_encoding(viewdirs.float(), multires_views).to(dtype)
    return torch.cat([pe, ve[:, None, :].expand(N, S, e_v),
                      torch.zeros((N, S, PACK - e_p - e_v), dtype=dtype,
                                  device=pts.device)],
                     dim=-1).reshape(N * S, PACK)


# ------------------------------------------------------------ plain twins

def _dot(a, b):
    """A product of ``dtype`` operands accumulated in float32."""
    return a.float() @ b.float()


def _t_a(a, b):  # a^T @ b over the points, float32
    return a.float().T @ b.float()


def _b_t(a, b):  # a @ b^T, float32
    return a.float() @ b.float().T


def _tc_route(x: torch.Tensor, dtype) -> bool:
    """Whether the kernels form this call's products on the tensor cores
    (bfloat16 on the card), so that its twin takes their 16-k runs."""
    return x.is_cuda and dtype == torch.bfloat16


def _forward_tile(depth, dtype, x, ws):
    """JAX ``_forward_tile`` on all points at once: ``out [P, 8]`` float32
    and the activations ``(acts, feat, hv_in, hv)`` (``dtype`` values)."""
    w1, b1, tw, tb, wfs, bfs, wv, bv, wr, br = _split(ws, depth)
    W = wfs.shape[0]
    h = torch.relu(_dot(x, w1) + b1).to(dtype)
    acts = [h]
    for i in range(depth - 1):
        h = torch.relu(_dot(h, tw[i]) + tb[i]).to(dtype)
        acts.append(h)
    fs = _dot(h, wfs) + bfs  # [P, W + 8]
    feat = fs[:, :W].to(dtype)
    sig8 = fs[:, W:W + OUT]  # sigma in column 3
    hv_in = torch.cat([feat, x.to(dtype)], dim=-1)  # [P, W + 128]
    hv = torch.relu(_dot(hv_in, wv) + bv).to(dtype)
    out = _dot(hv, wr) + br + sig8
    return out, (acts, feat, hv_in, hv)


def _forward_tc(depth, x, ws, e_p, e_v):
    """:func:`_forward_tile` as kernel 12's bfloat16 tile forms it
    (csrc/fused_nerf_packed.cu ``packed_forward_tc``): every product by
    :func:`ops.fused_mlp_t._tc_mm` (each 16-k run summed on its own, the runs
    added in k order in float32), the first layer over the lanes below
    ``pad16(e_p)``, the feature and sigma columns as one product over ``W +
    8`` columns, the view layer over ``[feat | x[:, v0:v1]]``
    (:func:`view_runs`), the output ``(hv WR + br) + sig8``. ``hv_in`` is
    ``[feat | x]``, the a-operand of JAX's d(WV)."""
    w1, b1, tw, tb, wfs, bfs, wv, bv, wr, br = _split(ws, depth)
    W, mm, bf = wfs.shape[0], fused_mlp_t._tc_mm, torch.bfloat16
    ep16 = fused_mlp_t._pad16(e_p)
    v0, v1 = view_runs(e_p, e_v)
    h = torch.relu(mm(x[:, :ep16], w1[:ep16].t()) + b1).to(bf)
    acts = [h]
    for i in range(depth - 1):
        h = torch.relu(mm(h, tw[i].t()) + tb[i]).to(bf)
        acts.append(h)
    fs = mm(h, wfs.t()) + bfs
    feat, sig8 = fs[:, :W].to(bf), fs[:, W:W + OUT]
    wv_tc = torch.cat([wv[:W], wv[W + v0:W + v1]])
    hv = torch.relu(mm(torch.cat([feat, x[:, v0:v1]], -1), wv_tc.t()) + bv).to(bf)
    out = (mm(hv, wr.t()) + br) + sig8
    return out, (acts, feat, torch.cat([feat, x.to(bf)], -1), hv)


def _forward_acts(depth, dtype, x, ws, e_p, e_v):
    if _tc_route(x, dtype):
        return _forward_tc(depth, x, ws, e_p, e_v)
    return _forward_tile(depth, dtype, x, ws)


def fused_packed_fwd_plain(ws: List[torch.Tensor], x: torch.Tensor,
                           depth: int, dtype, *, e_p: int,
                           e_v: int) -> torch.Tensor:
    """Kernel 12's twin: ``x [P, 128]`` -> ``[P, 8]`` float32."""
    return _forward_acts(depth, dtype, x, ws, e_p, e_v)[0]


def _rgb_in(gb, wr):
    """``gb[:, :3] WR[:, :3]^T`` in the chain's FMA order (k = 0, 1, 2 from
    zero; each product of bfloat16 values exact in float32)."""
    g, w = gb.float(), wr.float()
    acc = g[:, 0:1] * w[:, 0]
    acc = acc + g[:, 1:2] * w[:, 1]
    return acc + g[:, 2:3] * w[:, 2]


def _backward_chain(ws, x, g, depth, dtype, e_p, e_v):
    """JAX ``_bwd_kernel``'s recompute and its chain of rounded cotangents:
    ``(acts, feat, hv_in, hv, gb, dhv, dfeat, dhs)`` (``dhs[l]`` the masked
    cotangent of ``h_l``). On the tensor-core route the input products are
    :func:`ops.fused_mlp_t._tc_mm`'s, dhv's :func:`_rgb_in` and the sigma
    term an exact product added in float32, as the chain forms them."""
    w1, b1, tw, tb, wfs, bfs, wv, bv, wr, br = _split(ws, depth)
    W = wfs.shape[0]
    tc = _tc_route(x, dtype)
    _, (acts, feat, hv_in, hv) = _forward_acts(depth, dtype, x, ws, e_p, e_v)
    ip = fused_mlp_t._tc_mm if tc else _b_t
    gb = g.to(dtype)
    dhv = torch.where(hv.float() > 0, _rgb_in(gb, wr) if tc else _b_t(gb, wr),
                      0.0).to(dtype)
    dfeat = ip(dhv, wv[:W]).to(dtype)
    if tc:
        dh = ip(dfeat, wfs[:, :W]) + gb[:, 3:4].float() * wfs[:, W + 3].float()
    else:
        dh = _b_t(dfeat, wfs[:, :W]) + _b_t(gb, wfs[:, W:])
    dhs = [None] * depth
    for li in range(depth - 1, 0, -1):
        dh = torch.where(acts[li].float() > 0, dh, 0.0).to(dtype)
        dhs[li] = dh
        dh = ip(dh, tw[li - 1])
    dhs[0] = torch.where(acts[0].float() > 0, dh, 0.0).to(dtype)
    return acts, feat, hv_in, hv, gb, dhv, dfeat, dhs


def fused_packed_bwd_plain(ws: List[torch.Tensor], x: torch.Tensor,
                           g: torch.Tensor, depth: int, dtype, *, e_p: int,
                           e_v: int) -> List[torch.Tensor]:
    """Kernel 13's twin (JAX ``_bwd_kernel`` over all points at once): the
    float32 gradients of every packed weight, in :func:`pack_params`'s
    order, for the cotangent ``g [P, 8]``."""
    g = g.float()
    acts, feat, hv_in, hv, gb, dhv, dfeat, dhs = _backward_chain(
        ws, x, g, depth, dtype, e_p, e_v)
    dwr = _t_a(hv, gb)
    dbr = g.sum(0, keepdim=True)
    dwv = _t_a(hv_in, dhv)
    dbv = dhv.float().sum(0, keepdim=True)
    h_last = acts[-1]
    dwfs = torch.cat([_t_a(h_last, dfeat), _t_a(h_last, gb)], dim=1)
    dbfs = torch.cat([dfeat.float().sum(0, keepdim=True),
                      g.sum(0, keepdim=True)], dim=1)
    dtw = [_t_a(acts[li - 1], dhs[li]) for li in range(1, depth)]
    dtb = [dhs[li].float().sum(0, keepdim=True) for li in range(1, depth)]
    dw1 = _t_a(x, dhs[0])
    db1 = dhs[0].float().sum(0, keepdim=True)
    return [dw1, db1, *dtw, *dtb, dwfs, dbfs, dwv, dbv, dwr, dbr]


def chunk_numel(count: int, depth: int, width: int):
    """Elements of phase 1's two buffers of ``count`` points: the
    activations h_0 .. h_{D-1}, feat (D + 1 layers of ``[count, W]``) and
    the cotangents dh_0 .. dh_{D-1}, dfeat, then dhv ``[count, W / 2]``
    (:func:`ops.fused_mlp_t.split_acts`' layout). Phase 2 reads no hv."""
    acts = count * (depth + 1) * width
    return acts, acts + count * (width // 2)


def grad_offsets(ws: List[torch.Tensor]) -> List[int]:
    """Each packed tensor's offset in a flat gradient row."""
    out, o = [], 0
    for t in ws:
        out.append(o)
        o += t.numel()
    return out


def fused_packed_chain_plain(ws: List[torch.Tensor], x: torch.Tensor,
                             g: torch.Tensor, start: int, count: int, *,
                             depth: int, e_p: int, e_v: int, dtype):
    """Phase 1's twin over the points ``[start, start + count)``: the
    activation buffer (``h_0 .. h_{D-1}, feat``) and the cotangent buffer
    (``dh_0 .. dh_{D-1}, dfeat, dhv``) in ``dtype``, :func:`chunk_numel`
    long; the small gradients flat in the packed list's order (zero where
    phase 2 adds): d(WR)'s rgb columns, d(br), the sigma column of d(WFS)
    and its bias, every other bias; and hv ``[count W / 2]`` in ``dtype``."""
    sl = slice(start, start + count)
    g = g[sl].float()
    acts, feat, _, hv, gb, dhv, dfeat, dhs = _backward_chain(
        ws, x[sl], g, depth, dtype, e_p, e_v)
    W = ws[0].shape[1]
    small = [torch.zeros(t.shape, device=x.device) for t in ws]
    n = 2 * (depth - 1)
    small[1] = dhs[0].float().sum(0, keepdim=True)
    for li in range(1, depth):
        small[1 + depth + li - 1] = dhs[li].float().sum(0, keepdim=True)
    small[n + 2][:, W + 3] = _t_a(acts[-1], gb[:, 3:4])[:, 0]
    small[n + 3][0, :W] = dfeat.float().sum(0)
    small[n + 3][0, W + 3] = g[:, 3].sum()
    small[n + 5] = dhv.float().sum(0, keepdim=True)
    small[n + 6][:, :3] = _t_a(hv, gb[:, :3])
    small[n + 7][0, :3] = g[:, :3].sum(0)
    flat = lambda ts: torch.cat([t.to(dtype).reshape(-1) for t in ts])  # noqa: E731
    return (flat(acts + [feat]), flat(dhs + [dfeat, dhv]),
            torch.cat([t.reshape(-1) for t in small]), flat([hv]))


def packed_wgrad_entries(x: torch.Tensor, acts: torch.Tensor,
                         cot: torch.Tensor, start: int, count: int,
                         depth: int, width: int, e_p: int, e_v: int,
                         g_at: List[int]):
    """Phase 2's table for the points ``[start, start + count)``
    (:func:`ops.fused_mlp_t.bwd_weight_grads`' entries ``(a, b, m_keep,
    out, ldo)``, adding ``a[:, :m_keep]^T b`` at flat offset ``out`` with
    row stride ``ldo``): d(W1)'s first ``e_p`` rows from the packed input's
    lanes below ``pad16(e_p)``, each d(TW_l), d(WFS)'s feature columns (row
    stride W + 8), d(WV)'s feature rows, and its rows of the lanes ``[v0,
    v1)`` (:func:`view_runs`; a-operands start on lanes that are multiples
    of 8, so 16-byte aligned). ``acts`` and ``cot`` are phase 1's buffers of
    the chunk, ``g_at`` :func:`grad_offsets`."""
    hs = acts[:(depth + 1) * count * width].view(depth + 1, count, width)
    cs = fused_mlp_t.split_acts(cot, count, depth, width)
    xc = x[start:start + count]
    v0, v1 = view_runs(e_p, e_v)
    n = 2 * (depth - 1)
    out = [(xc[:, :fused_mlp_t._pad16(e_p)], cs[0], e_p, g_at[0], width)]
    for li in range(1, depth):
        out.append((hs[li - 1], cs[li], width, g_at[1 + li], width))
    out.append((hs[depth - 1], cs[depth], width, g_at[n + 2], width + OUT))
    out.append((hs[depth], cs[depth + 1], width, g_at[n + 4], width // 2))
    out.append((xc[:, v0:v1], cs[depth + 1], v1 - v0,
                g_at[n + 4] + (width + v0) * (width // 2), width // 2))
    return out


def _witness_share(layers):
    """Per layer ``(a, w, extra, gate, relu, got)``, ``got`` the kernel's
    ``round(gate(relu(a w^T + extra)))`` (``extra`` and ``gate`` may be
    None): the share of ``got`` off the layer recomputed with float64
    products of the same bfloat16 operands and rounded once, and the same
    share for float32 products."""
    def rounded(a, w, extra, gate, relu, dt):
        z = a.to(dt) @ w.to(dt).T
        if extra is not None:
            z = z + extra.to(dt)
        if relu:
            z = torch.relu(z)
        if gate is not None:
            z = torch.where(gate > 0, z, 0.0)
        return z.float().to(torch.bfloat16).float()

    kernel, f32 = [], []
    for a, w, extra, gate, relu, got in layers:
        exact = rounded(a, w, extra, gate, relu, torch.float64)
        kernel.append((got.float() != exact).float().mean().item())
        f32.append((rounded(a, w, extra, gate, relu, torch.float32) != exact)
                   .float().mean().item())
    return {"kernel": kernel, "float32": f32}


def packed_fwd_witness(ws: List[torch.Tensor], x: torch.Tensor,
                       acts: torch.Tensor, hv: torch.Tensor, depth: int,
                       e_p: int, e_v: int):
    """How often kernel 12's bfloat16 tile rounds an activation the wrong
    way, as :func:`ops.fused_mlp_t.bf16_product_witness` for kernel 4: each
    layer (h_0 .. h_{D-1}, feat in ``acts``, then ``hv``) recomputed from its
    own inputs there (phase 1's buffers of all ``x``'s points, the tile that
    kernel 12 runs) with float64 products of the same bfloat16 operands, the
    bias added, rounded once; per layer the share off it, and the share for
    float32 products."""
    w1, b1, tw, tb, wfs, bfs, wv, bv, wr, br = _split(ws, depth)
    P, W = x.shape[0], wfs.shape[0]
    got = [a.float() for a in fused_mlp_t.split_acts(torch.cat([acts, hv]), P,
                                                     depth, W)]
    xf = x.float()
    layers = []
    for i in range(depth):
        a = xf if i == 0 else got[i - 1]
        w = (w1 if i == 0 else tw[i - 1]).float().T
        b = (b1 if i == 0 else tb[i - 1]).float()
        layers.append((a, w, b, None, True, got[i]))
    layers.append((got[depth - 1], wfs[:, :W].float().T, bfs[:, :W], None, False,
                   got[depth]))
    layers.append((torch.cat([got[depth], xf], 1), wv.float().T, bv, None, True,
                   got[depth + 1]))
    return _witness_share(layers)


def packed_bwd_witness(ws: List[torch.Tensor], g: torch.Tensor,
                       acts: torch.Tensor, hv: torch.Tensor, cot: torch.Tensor,
                       depth: int):
    """The bfloat16 chain of kernel 13 against a float64 witness, as
    :func:`ops.fused_mlp_t.bwd_product_witness` for kernel 5: per cotangent
    layer of phase 1's buffer ``cot`` (dhv, dfeat, dh_{D-1} .. dh_0) of all
    ``g``'s points, the share that rounds otherwise than the layer
    recomputed with float64 products from the chain's own bfloat16 inputs
    (the next layer's cotangent in ``cot``, the weights, ``g``, the gates in
    ``acts`` and ``hv``), and the same share for float32 products."""
    w1, b1, tw, tb, wfs, bfs, wv, bv, wr, br = _split(ws, depth)
    P, W = g.shape[0], wfs.shape[0]
    hs = [a.float() for a in fused_mlp_t.split_acts(torch.cat([acts, hv]), P,
                                                    depth, W)]
    cs = [c.float() for c in fused_mlp_t.split_acts(cot, P, depth, W)]
    gb = g.float().to(torch.bfloat16).float()
    layers = [(gb[:, :3], wr[:, :3].float(), None, hs[depth + 1], False,
               cs[depth + 1]),
              (cs[depth + 1], wv[:W].float(), None, None, False, cs[depth])]
    x = cs[depth]
    for li in range(depth - 1, -1, -1):
        if li == depth - 1:  # the sigma term: exact in float32 and 64
            wl, extra = wfs[:, :W], gb[:, 3:4] * wfs[:, W + 3].float()
        else:
            wl, extra = tw[li], None
        layers.append((x, wl.float(), extra, hs[li], False, cs[li]))
        x = cs[li]
    return _witness_share(layers)


# --------------------------------------------------------------- launches

class KernelWeights(NamedTuple):
    """:func:`pack_params`' list in the kernels' buffers: every weight
    ``[in, out]`` then the transposes of those the backward multiplies by,
    in ``dtype``; the biases float32; the 46 offsets of
    ``csrc/fused_nerf_packed.cu`` (weights, transposes, biases, gradient
    blocks, tensor-core rows); in bfloat16 the tensor-core rows
    (:func:`tc_weights`)."""
    weights: torch.Tensor
    biases: torch.Tensor
    offsets: ctypes.Array
    grad_numel: int  # floats in one gradient row (the packed list, flat)
    shapes: tuple  # each packed tensor's shape, for the gradient list
    weights_p: torch.Tensor | None = None


def tc_weights(ws: List[torch.Tensor], depth: int, e_p: int, e_v: int):
    """The bfloat16 kernels' B operands, flat, and their 12 offsets: the
    forward's rows ``[out][K]`` (:func:`ops.fused_mlp_t._tc_rows`, each run
    of 16 k permuted for ``tc_mac``) of W1 over its first ``pad16(e_p)``
    rows, each TW_i, WFS (``W + 8`` rows: the feature and sigma columns),
    WV over its feature rows and the rows of the lanes :func:`view_runs`,
    and WR (8 rows); then the backward's input-product rows ``[in][out]``
    (:func:`ops.fused_mlp_t._tc_in_rows`, for ``tc_mac_in``) of each TW_i,
    of WFS's feature columns and of WV's feature rows. Offsets of layers
    past the depth are 0."""
    w1, _, tw, _, wfs, _, wv, _, wr, _ = _split(ws, depth)
    W, rows = wfs.shape[0], fused_mlp_t._tc_rows
    ep16 = fused_mlp_t._pad16(e_p)
    v0, v1 = view_runs(e_p, e_v)
    pad = [None] * (_MAX_DEPTH - depth)
    fwd = ([rows(w1[:ep16].t(), [ep16])] + [rows(t.t(), [W]) for t in tw] + pad
           + [rows(wfs.t(), [W]),
              rows(torch.cat([wv[:W], wv[W + v0:W + v1]]).t(), [W, v1 - v0]),
              rows(wr.t(), [W // 2])])
    back = ([fused_mlp_t._tc_in_rows(t.t()) for t in tw] + pad
            + [fused_mlp_t._tc_in_rows(wfs[:, :W].t()),
               fused_mlp_t._tc_in_rows(wv[:W].t())])
    offs, parts, o = [], [], 0
    for t in fwd + back:
        offs.append(o if t is not None else 0)
        if t is not None:
            parts.append(t)
            o += t.numel()
    return torch.cat(parts), offs


def kernel_weights(ws: List[torch.Tensor], depth: int, e_p: int,
                   e_v: int) -> KernelWeights:
    w1, b1, tw, tb, wfs, bfs, wv, bv, wr, br = _split(ws, depth)
    mats = [w1, *tw] + [None] * (_MAX_DEPTH - depth) + [wfs, wv, wr]
    trans = [t.t() for t in tw] + [None] * (_MAX_DEPTH - depth) \
        + [wfs.t(), wv.t(), wr.t()]
    vecs = [b1, *tb] + [None] * (_MAX_DEPTH - depth) + [bfs, bv, br]

    def flat(parts, o=0):
        offs, out = [], []
        for t in parts:
            offs.append(o if t is not None else 0)
            if t is not None:
                out.append(t.reshape(-1))
                o += t.numel()
        return offs, out, o

    w_offs, w_flat, n = flat(mats)
    t_offs, t_flat, _ = flat(trans, n)
    b_offs, b_flat, _ = flat(vecs)
    # The gradient row is the packed list flattened in its order.
    g_at = grad_offsets(ws)
    o = g_at[-1] + ws[-1].numel()
    d1 = depth - 1
    pad = [0] * (_MAX_DEPTH - depth)
    g_w = [g_at[0], *g_at[2:2 + d1]] + pad + [g_at[2 + 2 * d1],
                                              g_at[4 + 2 * d1],
                                              g_at[6 + 2 * d1]]
    g_b = [g_at[1], *g_at[2 + d1:2 + 2 * d1]] + pad + [g_at[3 + 2 * d1],
                                                       g_at[5 + 2 * d1],
                                                       g_at[7 + 2 * d1]]
    wp, p_offs = None, [0] * 12
    if w1.dtype == torch.bfloat16:
        wp, p_offs = tc_weights(ws, depth, e_p, e_v)
    offs = w_offs + t_offs + b_offs + g_w + g_b + p_offs
    return KernelWeights(
        torch.cat(w_flat + t_flat),
        torch.cat(b_flat).contiguous(), (ctypes.c_int * len(offs))(*offs), o,
        tuple(t.shape for t in ws), wp)


def _check(x: torch.Tensor, depth: int, dtype, kw: KernelWeights | None):
    if dtype not in _DTYPES or x.dtype != dtype:
        raise ValueError(f"packed input must be {dtype} (one of {_DTYPES}), "
                         f"got {x.dtype}")
    if x.dim() != 2 or x.shape[1] != PACK or not 1 <= depth <= _MAX_DEPTH:
        raise ValueError(f"bad packed input {tuple(x.shape)} or depth {depth}")
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {x.device}")
    if kw is not None and (kw.weights.device != x.device
                           or kw.weights.dtype != dtype):
        raise ValueError(f"kernel weights are {kw.weights.dtype} on "
                         f"{kw.weights.device}, want {dtype} on {x.device}")


def _ptr(t: torch.Tensor | None):
    return None if t is None else t.data_ptr()


def fused_packed_fwd(ws: List[torch.Tensor], x: torch.Tensor, *, depth: int,
                     e_p: int, e_v: int, dtype,
                     kw: KernelWeights | None = None) -> torch.Tensor:
    """Kernel 12: the packed input ``x [P, 128]`` (``dtype``) and the packed
    weights ``ws`` (:func:`pack_params`) -> ``[P, 8]`` float32. ``kw`` is
    ``kernel_weights(ws, depth, e_p, e_v)`` made once by a caller that
    launches more than once with the same weights."""
    _check(x, depth, dtype, kw)
    if x.device.type == "cpu":
        return fused_packed_fwd_plain(ws, x, depth, dtype, e_p=e_p, e_v=e_v)
    kw = kernel_weights(ws, depth, e_p, e_v) if kw is None else kw
    x = x.contiguous()
    P = x.shape[0]
    out = torch.empty((P, OUT), dtype=torch.float32, device=x.device)
    lib = _build.load(KERNEL, ARGTYPES)
    err = lib.fused_nerf_packed_fwd_launch(
        x.data_ptr(), kw.weights.data_ptr(), _ptr(kw.weights_p),
        kw.biases.data_ptr(), ctypes.addressof(kw.offsets), out.data_ptr(), P,
        depth, ws[0].shape[1], e_p, e_v, int(dtype == torch.bfloat16),
        torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(lib, KERNEL, err)
    fused_packed_fwd.launches += 1
    return out


register_launches("fused_nerf_packed_fwd", fused_packed_fwd)


def _grad_list(flat: torch.Tensor, shapes) -> List[torch.Tensor]:
    out, o = [], 0
    for shape in shapes:
        n = shape.numel()
        out.append(flat[o:o + n].view(shape))
        o += n
    return out


def fused_packed_bwd(ws: List[torch.Tensor], x: torch.Tensor, g: torch.Tensor,
                     *, depth: int, e_p: int, e_v: int, dtype,
                     kw: KernelWeights | None = None) -> List[torch.Tensor]:
    """Kernel 13: the float32 gradients of the packed weights (in
    :func:`pack_params`' order and shapes) for the cotangent ``g [P, 8]``
    of :func:`fused_packed_fwd`'s output; the entries that
    :func:`unpack_grads` drops are zero on the card, but for bfloat16's
    rows of d(WV) of the position lanes in the view runs. In bfloat16 on the
    card it is the split backward (:func:`_packed_bwd_split`), whose
    :func:`fused_packed_chain` counts its launches; in float32 on the card
    one launch of ``fused_nerf_packed_bwd_kernel``."""
    _check(x, depth, dtype, kw)
    if g.shape != (x.shape[0], OUT) or g.device != x.device:
        raise ValueError(f"bad cotangent {tuple(g.shape)} on {g.device}")
    if x.device.type == "cpu":
        return fused_packed_bwd_plain(ws, x, g, depth, dtype, e_p=e_p, e_v=e_v)
    kw = kernel_weights(ws, depth, e_p, e_v) if kw is None else kw
    x, g = x.contiguous(), g.float().contiguous()
    if dtype == torch.bfloat16:
        return _packed_bwd_split(ws, x, g, depth=depth, e_p=e_p, e_v=e_v,
                                 dtype=dtype, kw=kw)
    dev, P = x.device, x.shape[0]
    W = ws[0].shape[1]
    G = fused_mlp_t._grid(dev, -(-P // fused_mlp_t.TILE))
    stride = -(-kw.grad_numel // 4) * 4
    part = torch.zeros((G, stride), dtype=torch.float32, device=dev)
    tile = fused_mlp_t.TILE
    scratch = torch.empty((G * ((depth + 1) * tile * W + tile * (W // 2)),),
                          dtype=dtype, device=dev)
    lib = _build.load(KERNEL, ARGTYPES)
    err = lib.fused_nerf_packed_bwd_launch(
        x.data_ptr(), g.data_ptr(), kw.weights.data_ptr(),
        kw.biases.data_ptr(), ctypes.addressof(kw.offsets), scratch.data_ptr(),
        part.data_ptr(), stride, G, P, depth, W, e_p, e_v,
        torch.cuda.current_stream(dev).cuda_stream)
    _build.check(lib, KERNEL, err)
    fused_packed_bwd.launches += 1
    return _grad_list(fused_mlp_t.grad_reduce(part, kw.grad_numel), kw.shapes)


register_launches("fused_nerf_packed_bwd", fused_packed_bwd)


def fused_packed_chain(ws: List[torch.Tensor], x: torch.Tensor,
                       g: torch.Tensor, start: int, count: int,
                       part: torch.Tensor, *, depth: int, e_p: int, e_v: int,
                       dtype, kw: KernelWeights | None = None,
                       acts: torch.Tensor | None = None,
                       cot: torch.Tensor | None = None,
                       hv: torch.Tensor | None = None):
    """Phase 1 of kernel 13's split (``fused_nerf_packed_chain_kernel``)
    over the points ``[start, start + count)`` (``start`` a multiple of the
    64-point tile): adds the small gradients into ``part`` (in place; one
    row a block) and returns the chunk's activation and cotangent buffers
    (:func:`chunk_numel`; written into ``acts`` and ``cot`` if given). With
    ``hv`` (``count W / 2`` elements), also writes the view activation
    there, which no phase reads: it is for the checks. Bfloat16 only on the
    card; CPU tensors run :func:`fused_packed_chain_plain` into row 0. The
    launch of a call's first chunk (``start == 0``) also counts as one of
    kernel 13 (:func:`fused_packed_bwd`)."""
    P, W = x.shape[0], ws[0].shape[1]
    if start % fused_mlp_t.TILE or count < 1 or start + count > P:
        raise ValueError(f"bad chunk [{start}, {start + count})")
    sizes = chunk_numel(count, depth, W) + (count * (W // 2),)
    for buf, n in zip((acts, cot, hv), sizes):
        if buf is not None and (buf.dtype != dtype or buf.numel() < n
                                or not buf.is_contiguous()
                                or buf.device != x.device):
            raise ValueError(f"bad chunk buffer {buf.dtype} {buf.numel()}")
    if x.device.type == "cpu":
        a, c, small, h = fused_packed_chain_plain(ws, x, g, start, count,
                                                  depth=depth, e_p=e_p,
                                                  e_v=e_v, dtype=dtype)
        part[0, :small.numel()] += small
        if hv is not None:
            hv[:h.numel()] = h
        return a, c
    if dtype != torch.bfloat16:
        raise ValueError("the split backward is bfloat16 on the card")
    _check(x, depth, dtype, kw)
    for t, dt, shape in ((x, dtype, (P, PACK)), (g, torch.float32, (P, OUT)),
                         (part, torch.float32, part.shape)):
        if t.dtype != dt or t.shape != shape or not t.is_contiguous() \
                or t.device != x.device:
            raise ValueError(f"bad input {t.dtype} {tuple(t.shape)} on "
                             f"{t.device}")
    kw = kernel_weights(ws, depth, e_p, e_v) if kw is None else kw
    if part.shape[1] < kw.grad_numel or part.shape[1] % 4:
        raise ValueError(f"bad partial rows {tuple(part.shape)}")
    acts, cot = (torch.empty((n,), dtype=dtype, device=x.device)
                 if buf is None else buf for buf, n in zip((acts, cot), sizes))
    G = min(part.shape[0], fused_mlp_t._grid(x.device, -(-count // fused_mlp_t.TILE)))
    lib = _build.load(KERNEL, ARGTYPES)
    err = lib.fused_nerf_packed_chain_launch(
        x.data_ptr(), g.data_ptr(), kw.weights.data_ptr(), kw.weights_p.data_ptr(),
        kw.biases.data_ptr(), ctypes.addressof(kw.offsets), acts.data_ptr(),
        cot.data_ptr(), _ptr(hv), part.data_ptr(), part.shape[1], G, start,
        count, P, depth, W, e_p, e_v,
        torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(lib, KERNEL, err)
    fused_packed_chain.launches += 1
    if start == 0:
        count_split_call(fused_packed_bwd)
    return acts[:sizes[0]], cot[:sizes[1]]


register_launches("fused_nerf_packed_chain", fused_packed_chain)
# Kernel 13's phase 2: fused_mlp_t.bwd_weight_grads adds its launches on
# :func:`packed_wgrad_entries`' tables here (``counter=packed_wgrad``), and
# those on kernels 5 and 8's tables to its own count.
packed_wgrad = register_launches("fused_nerf_packed_weight_grads",
                                 SimpleNamespace())


def _packed_bwd_split(ws, x, g, *, depth, e_p, e_v, dtype, kw=None):
    """Kernel 13 as the split backward: phases 1 and 2 over chunks of
    ``fused_mlp_t.BWD_CHUNK`` points (a multiple of the tile), then
    ``fused_nerf_grad_reduce``; the gradients in :func:`pack_params`' list.
    On the CPU the phases' twins and one partial row."""
    chunk = fused_mlp_t.BWD_CHUNK
    if chunk % fused_mlp_t.TILE:
        raise ValueError(f"chunk {chunk} is not a multiple of {fused_mlp_t.TILE}")
    dev, P, W = x.device, x.shape[0], ws[0].shape[1]
    g_at = grad_offsets(ws)
    n = g_at[-1] + ws[-1].numel()
    stride = -(-n // 4) * 4
    Pc = min(P, chunk)
    acts = cot = None
    rows = 1
    if dev.type == "cuda":
        kw = kernel_weights(ws, depth, e_p, e_v) if kw is None else kw
        acts, cot = (torch.empty((m,), dtype=dtype, device=dev)
                     for m in chunk_numel(Pc, depth, W))
        ents = packed_wgrad_entries(x, acts, cot, 0, Pc, depth, W, e_p, e_v,
                                    g_at)
        rows = max(fused_mlp_t._grid(dev, -(-Pc // fused_mlp_t.TILE)),
                   fused_mlp_t._wgrad_splits(ents, Pc, dev))
    part = torch.zeros((rows, stride), dtype=torch.float32, device=dev)
    for start in range(0, P, chunk):
        count = min(chunk, P - start)
        a, c = fused_packed_chain(ws, x, g, start, count, part, depth=depth,
                                  e_p=e_p, e_v=e_v, dtype=dtype, kw=kw,
                                  acts=acts, cot=cot)
        fused_mlp_t.bwd_weight_grads(
            packed_wgrad_entries(x, a, c, start, count, depth, W, e_p, e_v,
                                 g_at), part, count, counter=packed_wgrad)
    return _grad_list(fused_mlp_t.grad_reduce(part, n),
                      tuple(t.shape for t in ws))


class FusedPacked(torch.autograd.Function):
    """Kernel 12 forward, kernel 13 backward (JAX ``_fused_packed``). The
    packed input gets a zero cotangent (it is training data: the points are
    not differentiated, as in JAX)."""

    @staticmethod
    def forward(ctx, spec, names, x, *weights):
        depth, e_p, e_v, dtype = spec
        params = dict(zip(names, weights))
        ws = pack_params(params, depth, e_p, e_v, dtype, x.device)
        kw = kernel_weights(ws, depth, e_p, e_v) if x.device.type == "cuda" \
            else None
        ctx.spec, ctx.names, ctx.ws, ctx.kw = spec, names, ws, kw
        ctx.save_for_backward(x, *weights)
        return fused_packed_fwd(ws, x, depth=depth, e_p=e_p, e_v=e_v,
                                dtype=dtype, kw=kw)

    @staticmethod
    def backward(ctx, g):
        x, *weights = ctx.saved_tensors
        depth, e_p, e_v, dtype = ctx.spec
        params = dict(zip(ctx.names, weights))
        dws = fused_packed_bwd(ctx.ws, x, g.float().contiguous(), depth=depth,
                               e_p=e_p, e_v=e_v, dtype=dtype, kw=ctx.kw)
        grads = unpack_grads(dws, params, depth, e_p, e_v)
        dx = torch.zeros_like(x) if ctx.needs_input_grad[2] else None
        return (None, None, dx, *[grads[n] for n in ctx.names])


def fused_nerf_apply_raw(params: Mapping[str, torch.Tensor], pts: torch.Tensor,
                         viewdirs: torch.Tensor, *, depth: int, width: int,
                         multires: int, multires_views: int,
                         dtype=torch.bfloat16) -> torch.Tensor:
    """Raw queries (JAX ``fused_nerf_apply_raw``): ``pts [N, S, 3]`` and
    unit ``viewdirs [N, 3]`` -> raw ``[N, S, 4]`` float32. Rays are padded
    with zeros to a whole number of ``2048 // S`` (the TPU grid's rays per
    step) and sliced back. Under autograd, with a parameter that requires a
    gradient, :class:`FusedPacked` (kernels 12 and 13); else kernel 12."""
    N, S, _ = pts.shape
    if S < 1 or TILE % S:
        raise ValueError(f"S={S} does not divide the {TILE}-point tile")
    e_p, e_v = _enc_dims(multires, multires_views)
    n_pad = (-N) % (TILE // S)
    if n_pad:
        pts = torch.nn.functional.pad(pts, (0, 0, 0, 0, 0, n_pad))
        viewdirs = torch.nn.functional.pad(viewdirs, (0, 0, 0, n_pad))
    x = pack_encoding(pts, viewdirs, multires, multires_views, dtype)
    names = fused_mlp_t.param_names(depth)
    if torch.is_grad_enabled() and any(params[n].requires_grad for n in names):
        raw = FusedPacked.apply((depth, e_p, e_v, dtype), names, x,
                                *[params[n] for n in names])
    else:
        ws = pack_params(params, depth, e_p, e_v, dtype, x.device)
        raw = fused_packed_fwd(ws, x, depth=depth, e_p=e_p, e_v=e_v,
                               dtype=dtype)
    return raw.reshape(N + n_pad, S, OUT)[:N, :, :4]
