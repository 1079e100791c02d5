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

``params`` is a mapping of :class:`~models.nerf_mlp.NeRFMLP` parameter names
to float32 tensors, as in :mod:`ops.fused_mlp_t`.
"""

from __future__ import annotations

import ctypes
from typing import Dict, List, Mapping, NamedTuple

import torch

from depth_lidar_nerf_tpu_torch.ops import _build
from depth_lidar_nerf_tpu_torch.ops import fused_mlp_t
from depth_lidar_nerf_tpu_torch.ops.embedding import positional_encoding

KERNEL = "fused_nerf_packed"
_PTR, _INT = ctypes.c_void_p, ctypes.c_int
ARGTYPES = {
    # (x, w, b, off, out, P, depth, width, e_p, e_v, bf16, stream)
    "fused_nerf_packed_fwd_launch": [_PTR] * 5 + [_INT] * 6 + [_PTR],
    # (x, g, w, b, off, scratch, part, part_stride, G, P, depth, width, e_p,
    #  e_v, bf16, stream)
    "fused_nerf_packed_bwd_launch": [_PTR] * 7 + [ctypes.c_longlong]
    + [_INT] * 7 + [_PTR],
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


def fused_packed_fwd_plain(ws: List[torch.Tensor], x: torch.Tensor,
                           depth: int, dtype) -> torch.Tensor:
    """Kernel 12's twin: ``x [P, 128]`` -> ``[P, 8]`` float32."""
    return _forward_tile(depth, dtype, x, ws)[0]


def fused_packed_bwd_plain(ws: List[torch.Tensor], x: torch.Tensor,
                           g: torch.Tensor, depth: int,
                           dtype) -> List[torch.Tensor]:
    """Kernel 13's twin (JAX ``_bwd_kernel`` over all points at once): the
    float32 gradients of every packed weight, in :func:`pack_params`'s
    order, for the cotangent ``g [P, 8]``."""
    w1, b1, tw, tb, wfs, bfs, wv, bv, wr, br = _split(ws, depth)
    W = wfs.shape[0]
    g = g.float()
    _, (acts, feat, hv_in, hv) = _forward_tile(depth, dtype, x, ws)

    def t_a(a, b):  # a^T @ b over the points, float32
        return a.float().T @ b.float()

    def b_t(a, b):  # a @ b^T, float32
        return a.float() @ b.float().T

    gb = g.to(dtype)
    dwr = t_a(hv, gb)
    dbr = g.sum(0, keepdim=True)
    dhv = torch.where(hv.float() > 0, b_t(gb, wr), 0.0).to(dtype)
    dwv = t_a(hv_in, dhv)
    dbv = dhv.float().sum(0, keepdim=True)
    dfeat = b_t(dhv, wv[:W]).to(dtype)
    h_last = acts[-1]
    dwfs = torch.cat([t_a(h_last, dfeat), t_a(h_last, gb)], dim=1)
    dbfs = torch.cat([dfeat.float().sum(0, keepdim=True),
                      g.sum(0, keepdim=True)], dim=1)
    dh = b_t(dfeat, wfs[:, :W]) + b_t(gb, wfs[:, W:])
    dtw, dtb = [None] * (depth - 1), [None] * (depth - 1)
    for li in range(depth - 1, 0, -1):
        dh = torch.where(acts[li].float() > 0, dh, 0.0).to(dtype)
        dtw[li - 1] = t_a(acts[li - 1], dh)
        dtb[li - 1] = dh.float().sum(0, keepdim=True)
        dh = b_t(dh, tw[li - 1])
    dh = torch.where(acts[0].float() > 0, dh, 0.0).to(dtype)
    dw1 = t_a(x, dh)
    db1 = dh.float().sum(0, keepdim=True)
    return [dw1, db1, *dtw, *dtb, dwfs, dbfs, dwv, dbv, dwr, dbr]


# --------------------------------------------------------------- launches

class KernelWeights(NamedTuple):
    """:func:`pack_params`'s list in the kernels' buffers: every weight
    ``[in, out]`` then the transposes of those the backward multiplies by,
    in ``dtype``; the biases float32; the 34 offsets of
    ``csrc/fused_nerf_packed.cu`` (weights, transposes, biases, gradient
    blocks)."""
    weights: torch.Tensor
    biases: torch.Tensor
    offsets: ctypes.Array
    grad_numel: int  # floats in one gradient row (the packed list, flat)
    shapes: tuple  # each packed tensor's shape, for the gradient list


def kernel_weights(ws: List[torch.Tensor], depth: int) -> KernelWeights:
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
    g_at, o = [], 0
    for t in ws:
        g_at.append(o)
        o += t.numel()
    d1 = depth - 1
    pad = [0] * (_MAX_DEPTH - depth)
    g_w = [g_at[0], *g_at[2:2 + d1]] + pad + [g_at[2 + 2 * d1],
                                              g_at[4 + 2 * d1],
                                              g_at[6 + 2 * d1]]
    g_b = [g_at[1], *g_at[2 + d1:2 + 2 * d1]] + pad + [g_at[3 + 2 * d1],
                                                       g_at[5 + 2 * d1],
                                                       g_at[7 + 2 * d1]]
    offs = w_offs + t_offs + b_offs + g_w + g_b
    return KernelWeights(
        torch.cat(w_flat + t_flat),
        torch.cat(b_flat).contiguous(), (ctypes.c_int * len(offs))(*offs), o,
        tuple(t.shape for t in ws))


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


def _launch_tail(ws, depth, e_p, e_v, dtype, dev):
    W = ws[0].shape[1]
    return (depth, W, e_p, e_v, int(dtype == torch.bfloat16),
            torch.cuda.current_stream(dev).cuda_stream)


def fused_packed_fwd(ws: List[torch.Tensor], x: torch.Tensor, *, depth: int,
                     e_p: int, e_v: int, dtype,
                     kw: KernelWeights | None = None) -> torch.Tensor:
    """Kernel 12: the packed input ``x [P, 128]`` (``dtype``) and the packed
    weights ``ws`` (:func:`pack_params`) -> ``[P, 8]`` float32. ``kw`` is
    ``kernel_weights(ws, depth)`` made once by a caller that launches more
    than once with the same weights."""
    _check(x, depth, dtype, kw)
    if x.device.type == "cpu":
        return fused_packed_fwd_plain(ws, x, depth, dtype)
    kw = kernel_weights(ws, depth) if kw is None else kw
    x = x.contiguous()
    P = x.shape[0]
    out = torch.empty((P, OUT), dtype=torch.float32, device=x.device)
    lib = _build.load(KERNEL, ARGTYPES)
    err = lib.fused_nerf_packed_fwd_launch(
        x.data_ptr(), kw.weights.data_ptr(), kw.biases.data_ptr(),
        ctypes.addressof(kw.offsets), out.data_ptr(), P,
        *_launch_tail(ws, depth, e_p, e_v, dtype, x.device))
    _build.check(lib, KERNEL, err)
    fused_packed_fwd.launches += 1
    return out


fused_packed_fwd.launches = 0


def fused_packed_bwd(ws: List[torch.Tensor], x: torch.Tensor, g: torch.Tensor,
                     *, depth: int, e_p: int, e_v: int, dtype,
                     kw: KernelWeights | None = None) -> List[torch.Tensor]:
    """Kernel 13: the float32 gradients of the packed weights (in
    :func:`pack_params`'s order and shapes) for the cotangent ``g [P, 8]``
    of :func:`fused_packed_fwd`'s output; the entries that
    :func:`unpack_grads` drops are zero on the card."""
    _check(x, depth, dtype, kw)
    if g.shape != (x.shape[0], OUT) or g.device != x.device:
        raise ValueError(f"bad cotangent {tuple(g.shape)} on {g.device}")
    if x.device.type == "cpu":
        return fused_packed_bwd_plain(ws, x, g, depth, dtype)
    kw = kernel_weights(ws, depth) if kw is None else kw
    x, g = x.contiguous(), g.float().contiguous()
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
        part.data_ptr(), stride, G, P,
        *_launch_tail(ws, depth, e_p, e_v, dtype, dev))
    _build.check(lib, KERNEL, err)
    fused_packed_bwd.launches += 1
    flat = fused_mlp_t.grad_reduce(part, kw.grad_numel)
    out, o = [], 0
    for shape in kw.shapes:
        n = shape.numel()
        out.append(flat[o:o + n].view(shape))
        o += n
    return out


fused_packed_bwd.launches = 0


class FusedPacked(torch.autograd.Function):
    """Kernel 12 forward, kernel 13 backward (JAX ``_fused_packed``). The
    packed input gets a zero cotangent (it is training data: the points are
    not differentiated, as in JAX)."""

    @staticmethod
    def forward(ctx, spec, names, x, *weights):
        depth, e_p, e_v, dtype = spec
        params = dict(zip(names, weights))
        ws = pack_params(params, depth, e_p, e_v, dtype, x.device)
        kw = kernel_weights(ws, depth) if x.device.type == "cuda" else None
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
