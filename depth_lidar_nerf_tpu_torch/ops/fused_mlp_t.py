"""Fused NeRF MLP forward and backward through hand-written CUDA kernels
(port of ``ops/fused_mlp_t.py``).

The Pallas kernels it replaces evaluate the whole radiance MLP for a tile of
points with the positional encoding computed in-kernel, the skip concat as a
second product on the encoding rows, and the view layer's per-ray half
computed once per ray; they write channel-major raw ``[4, P]``. Their
backwards return float32 weight gradients and zero input cotangents. Here:

====  ==========================  ============================  ===============================
 #    Pallas kernel               CUDA kernel (csrc/)            wrapper
====  ==========================  ============================  ===============================
 1    ``_fwd_kernel``             ``fused_nerf_fwd.cu``          :func:`fused_nerf_fwd`
 2    ``_bwd_kernel``             ``fused_nerf_bwd.cu`` dense    :func:`fused_nerf_bwd`
 3    ``_bwd_kernel_culled``      ``fused_nerf_bwd.cu`` culled   :func:`fused_nerf_bwd_culled`
 4    ``_fwd_kernel_acts``        ``fused_nerf_fwd.cu`` acts     :func:`fused_nerf_fwd_acts`
 5    ``_bwd_kernel_acts``        ``fused_nerf_bwd.cu`` acts     :func:`fused_nerf_bwd_acts`
 6    ``_fwd_kernel_sem_only``    ``fused_nerf_fwd.cu`` sem      :func:`fused_nerf_fwd_sem`
 7    ``_fwd_kernel_acts_sem``    ``fused_nerf_fwd.cu`` sem acts :func:`fused_nerf_fwd_acts_sem`
 8    ``_bwd_kernel_acts_sem``    ``fused_nerf_bwd.cu`` sem      :func:`fused_nerf_bwd_acts_sem`
 9    ``_fwd_kernel_cf``          ``fused_nerf_fwd.cu`` cf       :func:`fused_nerf_fwd_cf`
10    ``_fwd_kernel_q8``          ``fused_nerf_q8.cu``           :func:`fused_nerf_fwd_q8`
11    ``_fwd_kernel_q8_sem``      ``fused_nerf_q8.cu`` + head    :func:`fused_nerf_fwd_q8_sem`
====  ==========================  ============================  ===============================

Each wrapper launches its kernel for CUDA tensors and runs its plain PyTorch
twin (``*_plain``, the kernel's arithmetic step by step) for CPU tensors; it
never falls back from one to the other. ``<wrapper>.launches`` counts kernel
launches; the backward wrappers also launch ``fused_nerf_grad_reduce``, which
sums the blocks' partial gradients (counted in ``grad_reduce.launches``).
Kernels 6 and 7 write per-tile partial sums of the feature activation that
the semantic head kernel (:func:`sem_head`) turns into per-ray logits;
kernel 8 first runs the head's backward (:func:`sem_head_bwd`), whose
per-ray feature cotangent then enters kernel 5's body.

:func:`fused_nerf_apply_rays` takes the route the JAX dispatcher
(``_apply_rays_core``) would take: with ``fwd_cull`` under
``DLNERF_CULL_FWD=1`` the early-terminating forward (kernel 9, on the
regrouped layout of :func:`cf_layout`; :class:`FusedCullFwd` under
autograd, with kernel 3's or kernel 2's backward); else without a gradient
the plain forward; under autograd :class:`FusedActs` (kernels 4 and 5) for a
pass that saves its activations within the byte cap, else
:class:`FusedRecompute` with the culled (kernel 3) or dense (kernel 2)
backward. The route is kept in
``fused_nerf_apply_rays.last_route``. :func:`fused_nerf_apply_rays_semantic`
is the semantic variant (JAX ``_fused_t_sem``): kernel 6 without a gradient,
:class:`FusedSem` (kernels 7 and 8) under autograd.

On the card in bfloat16, kernels 5 and 8 run as the split backward
(:func:`_bwd_split`): phase 1, :func:`fused_nerf_bwd_chain`, backpropagates
each tile and writes its cotangents; phase 2, :func:`bwd_weight_grads`, forms
the large weight gradients from them as one split-K GEMM on the tensor
cores, a chunk of ``BWD_CHUNK`` points at a time; each phase has its own
launch counter and plain twin, and :func:`bwd_product_witness` holds its
bfloat16 products against float64 ones.

Kernels 10 and 11 are the W8A8 serving forwards (JAX ``render_int8``), with
no backward: :func:`pack_params_q8` quantizes the wide weights per output
column (:func:`quant_cols`), the kernels quantize each point's activation
row (:func:`qdot_plain` is the arithmetic), and
:func:`fused_nerf_apply_rays_q8` / :func:`fused_nerf_apply_rays_semantic_q8`
raise under autograd.

``params`` everywhere is a mapping of the :class:`~models.nerf_mlp.NeRFMLP`
parameter names (``trunk_0.weight`` ``[out, in]``, ``trunk_0.bias``, ...) to
float32 tensors, e.g. ``dict(module.named_parameters())``. Gradients come
back in the same mapping.
"""

from __future__ import annotations

import ctypes
import math
import os
from typing import Dict, Mapping, NamedTuple

import torch

from depth_lidar_nerf_tpu_torch.ops import _build
from depth_lidar_nerf_tpu_torch.ops.embedding import positional_encoding

KERNEL = "fused_nerf_fwd"
BWD_KERNEL = "fused_nerf_bwd"
_PTR, _INT = ctypes.c_void_p, ctypes.c_int
ARGTYPES = {
    # (pts, vd, w, wp, b, out, P, S, depth, width, multires, multires_views,
    #  skip_mask, bf16, w_off, b_off, p_off, stream)
    "fused_nerf_fwd_launch": [_PTR] * 6 + [_INT] * 8 + [_PTR] * 4,
    # (pts, vd, w, wp, b, out, acts, P, S, depth, ..., stream)
    "fused_nerf_fwd_acts_launch": [_PTR] * 7 + [_INT] * 8 + [_PTR] * 4,
    # (pts, vd, w, wp, b, out, acts, fpart, MR, P, S, depth, ..., stream)
    "fused_nerf_fwd_sem_launch": [_PTR] * 8 + [_INT] * 9 + [_PTR] * 4,
    # (fpart, ws0, bs0, ws1, bs1, sem, sem_acts, MR, N, S, width, C, bf16,
    #  stream)
    "fused_nerf_sem_head_launch": [_PTR] * 7 + [_INT] * 6 + [_PTR],
    # (pts, vd, aux, w, wp, b, out, P, nSB, eps, depth, width, multires,
    #  multires_views, bf16, w_off, b_off, p_off, stream)
    "fused_nerf_fwd_cf_launch": [_PTR] * 7 + [_INT] * 2 + [ctypes.c_float]
    + [_INT] * 5 + [_PTR] * 4,
}
BWD_ARGTYPES = {
    # (mode, pts, vd, g, flags, acts, dfeat_ray, w, wt, wp, wi, b, scratch,
    #  part, part_stride, G, n_w, P, S, depth, width, multires,
    #  multires_views, skip_mask, bf16, w_off, b_off, p_off, stream)
    "fused_nerf_bwd_launch": [_INT] + [_PTR] * 13 + [ctypes.c_longlong]
    + [_INT] * 10 + [_PTR] * 4,
    # (gsem, sem_acts, ws0t, ws1t, dfeat_ray, part, part_stride, G, N, S,
    #  width, C, bf16, stream)
    "fused_nerf_sem_head_bwd_launch": [_PTR] * 6 + [ctypes.c_longlong]
    + [_INT] * 6 + [_PTR],
    # (part, part_stride, G, n, out, stream)
    "fused_nerf_grad_reduce_launch": [_PTR, ctypes.c_longlong, _INT, _INT,
                                      _PTR, _PTR],
    # (pts, vd, g, acts, dfeat_ray, w, wt, wi, b, cot, part, part_stride, G,
    #  n_w, P, S, c0, n_pts, depth, width, multires, multires_views,
    #  skip_mask, w_off, b_off, stream)
    "fused_nerf_bwd_chain_launch": [_PTR] * 11 + [ctypes.c_longlong]
    + [_INT] * 11 + [_PTR] * 3,
    # (entries, n_entries, P, part, part_stride, n_split, stream)
    "fused_nerf_wgrad_launch": [_PTR, _INT, _INT, _PTR, ctypes.c_longlong,
                                _INT, _PTR],
}
Q8_KERNEL = "fused_nerf_q8"
Q8_ARGTYPES = {
    # (pts, vd, w, wp, b, wq, sc, out, fpart, MR, P, S, depth, width, multires,
    #  multires_views, skip_mask, bf16, w_off, b_off, p_off, q_off, stream)
    "fused_nerf_q8_launch": [_PTR] * 9 + [_INT] * 9 + [_PTR] * 5,
}
_DTYPES = (torch.float32, torch.bfloat16)
TILE = 64  # points per CUDA block tile (kTP in csrc/fused_nerf.cuh)

# The JAX package's dispatch constants (ops/fused_mlp.py, ops/fused_mlp_t.py
# defaults), kept so that both packages choose the same route for a pass.
_JAX_TILE = 2048
SAMPLE_BLOCK = 16
_JAX_TILE_FWD = 8192
_ACTS_TILE = 4096
_ACTS_TILE_FWD = 8192
_ACTS_VMEM_MB = 96
# JAX's ``_ACTS_MAX_POINTS`` knob, read at import as JAX reads it: the
# saved-activation cap in D=4/W=256 bfloat16 points (see acts_points_cap).
_ACTS_MAX_POINTS = int(os.environ.get("DLNERF_BWD_ACTS_MAX_POINTS",
                                      4 * 1024 * 1024))


def live_skips(depth: int, skips) -> tuple:
    """Skip layers whose concat feeds a TRUNK layer (reference
    run_nerf_helpers.py:101-105: a skip after layer s is live iff
    s < depth - 1; netdepth=4 with skips=(4,) has none)."""
    return tuple(sorted(s for s in (skips or ()) if 0 <= s < depth - 1))


def supports_rays(params: Mapping[str, torch.Tensor], use_viewdirs: bool,
                  num_semantic: int, depth: int, width: int, multires: int,
                  multires_views: int, skips=()) -> bool:
    """Whether the kernels cover this model: the predicate of the JAX
    ``fused_mlp_t.supports_rays``. Depth 1-8, width 128 or 256, view
    directions on, no semantic head, no skip at the last trunk layer, and
    encodings of at most 128 rows together (which also bounds the kernels'
    shared memory)."""
    if not use_viewdirs or num_semantic > 0 or depth > 8 or depth < 1:
        return False
    if any(s >= depth - 1 for s in (skips or ()) if s < depth):
        return False
    e_p, e_v = 3 + 6 * multires, 3 + 6 * multires_views
    if e_p + e_v > 128 or "semantic_0.weight" in params:
        return False
    if "trunk_0.weight" not in params or params["trunk_0.weight"].shape[1] != e_p:
        return False
    ls = live_skips(depth, skips)
    for i in range(1, depth):
        key = f"trunk_{i}.weight"
        want = width + (e_p if (i - 1) in ls else 0)
        if key not in params or params[key].shape[1] != want:
            return False
    if params["views_0.weight"].shape[1] != width + e_v:
        return False
    return params["trunk_0.weight"].shape[0] == width and width in (128, 256)


def supports_semantic(params: Mapping[str, torch.Tensor], use_viewdirs: bool,
                      depth: int, width: int, multires: int,
                      multires_views: int, skips=()) -> bool:
    """Whether kernels 6-8 cover this model: the predicate of the JAX
    ``fused_mlp_t.supports_semantic``, the topology of :func:`supports_rays`
    plus the semantic head ``semantic_0``/``semantic_1``."""
    if "semantic_0.weight" not in params or "semantic_1.weight" not in params:
        return False
    trunk = {k: v for k, v in params.items()
             if not k.startswith("semantic_")}
    return supports_rays(trunk, use_viewdirs, 0, depth, width, multires,
                         multires_views, skips)


def supports_rays_shape(S: int) -> bool:
    """JAX ``supports_rays_shape``: S divides the 2,048-point JAX tile into
    at most 128 rays (the TPU kernels' view-direction block). The port's
    kernels take any S; the semantic route checks it so that both packages
    choose the same route."""
    return S > 0 and _JAX_TILE % S == 0 and _JAX_TILE // S <= 128


# ------------------------------------------------------------ route choice

def _acts_point_bytes(depth: int, width: int, dtype) -> int:
    """JAX ``_acts_point_bytes``: (D + 1) [W] + one [W/2] activation rows in
    the compute dtype, plus the [4] float32 raw row."""
    b = 2 if dtype == torch.bfloat16 else 4
    return ((depth + 1) * width + width // 2) * b + 16


def acts_points_cap(depth: int, width: int, dtype=torch.bfloat16) -> int:
    """JAX ``acts_points_cap``: the point cap of the saved-activation route,
    the byte budget of 4 Mi points at D=4/W=256 in bfloat16 (2,816 B a
    point). Kept at JAX's value so that both packages choose the same
    route; the card's 80 GB would admit more."""
    return (_ACTS_MAX_POINTS * 2816) // (_acts_point_bytes(depth, width, dtype)
                                         - 16)


def _jax_tile(cap: int) -> int:
    return max(_JAX_TILE, (cap // _JAX_TILE) * _JAX_TILE)


def jax_fwd_tile(S: int) -> int:
    """JAX ``_fwd_tile_size``: the forward kernels' points per tile."""
    return _jax_tile(min(_JAX_TILE_FWD, 128 * S))


def _jax_tiles(S: int, depth: int, width: int, dtype):
    """JAX's forward, saved-activation forward and saved-activation
    backward tiles (``_fwd_tile_size``, ``_acts_tile_fwd``, ``_acts_tile``)."""
    vmem = (_ACTS_VMEM_MB * 1024 * 1024) // (
        2 * _acts_point_bytes(depth, width, dtype))
    return (jax_fwd_tile(S), _jax_tile(min(_ACTS_TILE_FWD, 128 * S, vmem)),
            _jax_tile(min(_ACTS_TILE, 128 * S, vmem)))


def semantic_padded_rays(n_rays: int, S: int, depth: int, width: int,
                         dtype=torch.bfloat16) -> int:
    """JAX ``semantic_padded_rays``: the ray count after JAX pads a
    saved-activation pass to the LCM of its three tiles' rays per tile
    (``_acts_pad_rays_per_tile``). The port's kernels need no padding; the
    count only decides the route."""
    rpt = math.lcm(*(t // S for t in _jax_tiles(S, depth, width, dtype)))
    return n_rays + (-n_rays) % rpt


def bwd_acts_enabled() -> bool:
    """JAX ``bwd_acts_enabled``: a differentiated pass that asks to save its
    activations does so unless ``DLNERF_BWD_ACTS`` is other than "1", read
    at call time; then it takes the recompute backward."""
    return os.environ.get("DLNERF_BWD_ACTS", "1") == "1"


def acts_route_ok(n_rays: int, S: int, depth: int, width: int, dtype) -> bool:
    """The JAX predicate of the saved-activation route (``_apply_rays_core``):
    the point count after JAX's ray padding within :func:`acts_points_cap`.
    The semantic route applies the same cap (JAX
    ``FusedMLP.supports_raw_semantic``), to its no-grad renders too."""
    n_full = semantic_padded_rays(n_rays, S, depth, width, dtype)
    return n_full * S <= acts_points_cap(depth, width, dtype)


def cull_blocks_ok(S: int) -> bool:
    """JAX's ``blocks_ok``: the culled backward needs S a multiple of the
    16-sample block (and at least one block)."""
    sb = min(SAMPLE_BLOCK, S)
    return S % sb == 0 and _JAX_TILE // sb <= 128


CF_RAYS = 128  # rays per group of the early-terminating forward (JAX RB)


def cull_fwd_enabled() -> bool:
    """JAX ``cull_fwd_enabled``: the early-terminating forward (kernel 9)
    runs where its route applies only under ``DLNERF_CULL_FWD=1``, read at
    call time. Off by default, as in JAX."""
    return os.environ.get("DLNERF_CULL_FWD", "0") == "1"


def cull_bwd_cf_enabled() -> bool:
    """JAX ``spec_bwd_cull``: the early-terminating forward's backward is the
    culled one (kernel 3) unless ``DLNERF_CULL_BWD_CF=0`` asks for the dense
    one (kernel 2)."""
    return os.environ.get("DLNERF_CULL_BWD_CF", "1") == "1"


def cf_route_ok(S: int, eps: float, depth: int, skips=()) -> bool:
    """JAX ``_apply_rays_core``'s ``use_cf`` (given a sort key): a positive
    ``cull_eps``, whole 16-sample blocks of exactly 128 rays a block, the
    knob set, and no live skip (kernel 9 has no skip variant)."""
    sb = min(SAMPLE_BLOCK, S)
    return (eps > 0.0 and cull_blocks_ok(S) and _JAX_TILE // sb == CF_RAYS
            and cull_fwd_enabled() and not live_skips(depth, skips))


# ----------------------------------------------------------------- packing

def _layer_names(depth: int):
    return [f"trunk_{i}" for i in range(depth)] + ["sigma", "feature",
                                                   "views_0", "rgb"]


SEM_NAMES = ("semantic_0.weight", "semantic_0.bias", "semantic_1.weight",
             "semantic_1.bias")


def param_names(depth: int, semantic: bool = False):
    """Parameter names in packing order, each layer's weight then bias; the
    semantic head's last when ``semantic``."""
    names = [f"{n}.{k}" for n in _layer_names(depth) for k in ("weight", "bias")]
    return names + list(SEM_NAMES) if semantic else names


class SemPacked(NamedTuple):
    """The semantic head in the kernels' layout (JAX ``_pack_sem``: weights
    in the compute dtype, biases float32), each weight as ``[in, out]`` for
    the forward and ``[out, in]`` for the backward's input products."""
    ws0: torch.Tensor  # [W, W/2]
    bs0: torch.Tensor  # [W/2] float32
    ws1: torch.Tensor  # [W/2, C]
    bs1: torch.Tensor  # [C] float32
    ws0t: torch.Tensor  # [W/2, W] (semantic_0.weight)
    ws1t: torch.Tensor  # [C, W/2] (semantic_1.weight)


def pack_sem(params: Mapping[str, torch.Tensor], dtype, device=None) -> SemPacked:
    w0 = params["semantic_0.weight"].detach().to(device)
    w1 = params["semantic_1.weight"].detach().to(device)
    return SemPacked(w0.t().to(dtype).contiguous(),
                     params["semantic_0.bias"].detach().float().to(device),
                     w1.t().to(dtype).contiguous(),
                     params["semantic_1.bias"].detach().float().to(device),
                     w0.to(dtype).contiguous(), w1.to(dtype).contiguous())


class PackedParams(NamedTuple):
    """The weights in the kernels' layout, made by :func:`pack_params`."""
    weights: torch.Tensor  # every layer's [in, out], row-major, in dtype
    biases: torch.Tensor  # every bias, float32
    w_offsets: ctypes.Array  # element offset of each layer in ``weights``
    b_offsets: ctypes.Array  # and in ``biases``
    dtype: torch.dtype
    weights_t: torch.Tensor  # every layer's [out, in] (Linear.weight), dtype
    sem: SemPacked | None = None  # the semantic head, where the model has one
    # bfloat16 only: the tensor-core rows (:func:`_tc_rows`) and their
    # offsets, indexed as ``w_offsets`` (sigma's and rgb's unused)
    weights_p: torch.Tensor | None = None
    p_offsets: ctypes.Array | None = None
    # bfloat16 only: the backward's tensor-core rows (:func:`_tc_in_rows`),
    # at ``w_offsets``
    weights_ip: torch.Tensor | None = None


# Order of the 16 k of each k-step in ``weights_p`` and ``weights_ip``: lane
# t of an mma quad loads k = 2t, 2t + 1, 2t + 8, 2t + 9 (its two B
# registers) as one word.
TC_KPERM = (0, 1, 8, 9, 2, 3, 10, 11, 4, 5, 12, 13, 6, 7, 14, 15)


def _pad16(k: int) -> int:
    return -(-k // 16) * 16


def _tc_segments(name: str, w: torch.Tensor, width: int):
    """The input segments (column counts of ``Linear.weight`` ``w``, in
    order) whose products the bfloat16 forward runs on the tensor cores:
    a trunk layer's encoding rows and/or previous activation, the feature
    layer's activation, views_0's W feature rows (its view-encoding rows
    stay on FMA); None for the sigma and rgb heads."""
    n_in = w.shape[1]
    if name == "trunk_0":
        return [n_in]
    if name.startswith("trunk_"):
        return [n_in - width, width] if n_in > width else [n_in]
    if name in ("feature", "views_0"):
        return [width]
    return None


def _tc_rows(w: torch.Tensor, segs) -> torch.Tensor:
    """``Linear.weight`` ``[out, in]`` -> its tensor-core rows ``[out, K]``
    flat: each segment zero-padded to a multiple of 16 columns, each run of
    16 columns in :data:`TC_KPERM` order."""
    parts, o = [], 0
    for k in segs:
        parts.append(torch.nn.functional.pad(w[:, o:o + k], (0, _pad16(k) - k)))
        o += k
    rows = torch.cat(parts, 1)
    return rows.reshape(rows.shape[0], -1, 16)[..., list(TC_KPERM)].reshape(-1)


def _tc_in_rows(w: torch.Tensor) -> torch.Tensor:
    """``Linear.weight`` ``[out, in]`` -> the B rows of the backward's
    input product ``dX = dY W`` on the tensor cores, flat: ``[in, out]``
    (the layout of ``weights``) with each run of 16 outputs in
    :data:`TC_KPERM` order where ``out`` is a multiple of 16 (trunk,
    feature, views_0; sigma and rgb as they are)."""
    rows = w.t()
    if w.shape[0] % 16:
        return rows.reshape(-1)
    return rows.reshape(rows.shape[0], -1, 16)[..., list(TC_KPERM)].reshape(-1)


def _offsets(parts):
    out, o = [], 0
    for t in parts:
        out.append(o)
        o += t.numel()
    return (ctypes.c_int * len(out))(*out)


def pack_params(params: Mapping[str, torch.Tensor], depth: int, dtype,
                device=None) -> PackedParams:
    """One buffer of every weight as ``[in, out]`` row-major in ``dtype``
    (the Flax kernel layout: a skip layer's encoding rows come first), the
    same weights as ``[out, in]`` (for the backward's input products), one
    float32 buffer of every bias, and the element offset of each layer in
    both, in the order trunk_0..trunk_{D-1}, sigma, feature, views_0, rgb;
    with a semantic head, also :func:`pack_sem`. In bfloat16 also the
    tensor-core rows of the forward's trunk, feature and views_0 products
    (``weights_p``, :func:`_tc_rows`; csrc/fused_nerf.cuh) and of the
    backward's input products (``weights_ip``, :func:`_tc_in_rows`;
    csrc/fused_nerf_bwd.cu)."""
    names = _layer_names(depth)
    lin = [params[f"{n}.weight"].detach() for n in names]
    ws = [w.t().to(dtype).reshape(-1) for w in lin]
    wts = [w.to(dtype).reshape(-1) for w in lin]
    bs = [params[f"{n}.bias"].detach().float().reshape(-1) for n in names]
    sem = pack_sem(params, dtype, device) if SEM_NAMES[0] in params else None
    wp = p_off = wip = None
    if dtype == torch.bfloat16:
        width = lin[0].shape[0]
        segs = [_tc_segments(n, w, width) for n, w in zip(names, lin)]
        tc = [_tc_rows(w.to(dtype), sg) if sg else w.new_empty(0, dtype=dtype)
              for w, sg in zip(lin, segs)]
        wp, p_off = torch.cat(tc).to(device), _offsets(tc)
        wip = torch.cat([_tc_in_rows(w.to(dtype)) for w in lin]).to(device)
    return PackedParams(torch.cat(ws).to(device), torch.cat(bs).to(device),
                        _offsets(ws), _offsets(bs), dtype,
                        torch.cat(wts).to(device), sem, wp, p_off, wip)


def unpack_grads(flat: torch.Tensor, params: Mapping[str, torch.Tensor],
                 packed: PackedParams, depth: int) -> Dict[str, torch.Tensor]:
    """The kernels' float32 gradients (packed ``[in, out]`` weights, then
    biases) -> the parameter mapping, weights back as ``[out, in]``."""
    n_w = packed.weights.numel()
    out = {}
    for i, n in enumerate(_layer_names(depth)):
        w = params[f"{n}.weight"]
        o, b = packed.w_offsets[i], packed.b_offsets[i]
        out[f"{n}.weight"] = flat[o:o + w.numel()].view(
            w.shape[1], w.shape[0]).t().contiguous()
        nb = params[f"{n}.bias"].numel()
        out[f"{n}.bias"] = flat[n_w + b:n_w + b + nb].clone()
    return out


def grad_blocks(grads: Mapping[str, torch.Tensor], depth: int, width: int,
                multires: int, skips=()) -> Dict[str, torch.Tensor]:
    """Gradients split into the JAX kernels' tensors (``_pack_params``):
    the view layer's feature rows and encoding rows apart, and a skip
    layer's encoding rows apart from its trunk rows; each block has its
    own scale, so an error is measured per block."""
    out = dict(grads)
    w = out.pop("views_0.weight")
    out["views_0.weight[feat]"], out["views_0.weight[enc]"] = \
        w[:, :width], w[:, width:]
    e_p = 3 + 6 * multires
    for s in live_skips(depth, skips):
        w = out.pop(f"trunk_{s + 1}.weight")
        out[f"trunk_{s + 1}.weight[enc]"] = w[:, :e_p]
        out[f"trunk_{s + 1}.weight[trunk]"] = w[:, e_p:]
    return out


# ------------------------------------------------------------ plain twins

def _plain_weights(params, dtype):
    """``w(name)``: a layer's weight ``[out, in]`` rounded to ``dtype`` (as
    float32); ``b(name)``: its float32 bias."""
    def w(name):
        return params[f"{name}.weight"].detach().float().to(dtype).float()

    def b(name):
        return params[f"{name}.bias"].detach().float()

    return w, b


def _plain_encodings(pts_t, viewdirs_t, multires, multires_views, dtype):
    """The kernels' encodings rounded to ``dtype``: per point ``[P, e_p]``
    and per ray ``[N, e_v]``."""
    return (positional_encoding(pts_t.float().T, multires).to(dtype).float(),
            positional_encoding(viewdirs_t.float().T,
                                multires_views).to(dtype).float())


def _tc_mm(x, w):
    """``x @ w.T`` of bfloat16 values (``x`` ``[P, K]``, K a multiple of 16)
    as the bfloat16 forward tile forms it (csrc/fused_nerf.cuh:mma_bf16):
    on the card, each run of 16 k summed from zero on the tensor cores
    (cuBLAS, a 16-deep product), the runs added in k order in float32; on
    the CPU in float32, as the JAX package's reference multiplies there. The
    twin built on it checks the kernels' layout: with the order pinned here
    and no longer cuBLAS's, it rounds every bfloat16 activation as they do
    (measured at each shape of the card tests and the smoke). Their accuracy
    is held to :func:`bf16_product_witness`, which depends on no summation
    order."""
    if not x.is_cuda:
        return x @ w.T
    x, w = x.to(torch.bfloat16), w.to(torch.bfloat16)
    acc = torch.mm(x[:, :16], w[:, :16].T, out_dtype=torch.float32)
    for k in range(16, x.shape[1], 16):
        acc += torch.mm(x[:, k:k + 16], w[:, k:k + 16].T, out_dtype=torch.float32)
    return acc


def _forward_plain(params, pts_t, viewdirs_t, S, depth, width, multires,
                   multires_views, dtype, skips):
    """The forward kernel's arithmetic: operands rounded to ``dtype``,
    products accumulated in float32, each activation rounded to ``dtype``.
    In bfloat16 the trunk, feature and view-layer products are
    :func:`_tc_mm`'s, a skip layer's over ``[enc, 0 .. , h]`` with the
    encoding zero-padded to a multiple of 16 columns, as the kernel's.
    Returns raw ``[4, P]``, the activations ``[h_0 .. h_{D-1}, feat, hv]``
    (each ``[P, C]`` float32 holding ``dtype`` values), and the point and
    ray encodings."""
    ls = live_skips(depth, skips)
    e_p = 3 + 6 * multires
    tc = dtype == torch.bfloat16

    def rnd(x):
        return x.to(dtype).float()

    def pad(x):  # the encoding's columns up to a multiple of 16, zero
        return torch.nn.functional.pad(x, (0, _pad16(e_p) - e_p))

    w, b = _plain_weights(params, dtype)
    enc, encv = _plain_encodings(pts_t, viewdirs_t, multires, multires_views,
                                 dtype)
    hs, h = [], enc
    for i in range(depth):
        wi = w(f"trunk_{i}")
        if tc and i == 0:
            acc = _tc_mm(pad(enc), pad(wi))
        elif tc and (i - 1) in ls:
            acc = _tc_mm(torch.cat([pad(enc), h], 1),
                         torch.cat([pad(wi[:, :e_p]), wi[:, e_p:]], 1))
        elif tc:
            acc = _tc_mm(h, wi)
        elif i == 0:
            acc = enc @ wi.T
        elif (i - 1) in ls:
            acc = enc @ wi[:, :e_p].T + h @ wi[:, e_p:].T
        else:
            acc = h @ wi.T
        h = rnd(torch.relu(acc + b(f"trunk_{i}")))
        hs.append(h)
    mm = _tc_mm if tc else (lambda x, wt: x @ wt.T)
    sigma = h @ w("sigma").T + b("sigma")  # [P, 1]
    feat = rnd(mm(h, w("feature")) + b("feature"))
    wv = w("views_0")
    hv_ray = rnd(encv @ wv[:, width:].T)  # [N, W/2], once per ray
    hv = rnd(torch.relu(mm(feat, wv[:, :width])
                        + hv_ray.repeat_interleave(S, dim=0) + b("views_0")))
    rgb = hv @ w("rgb").T + b("rgb")
    raw = torch.cat([rgb, sigma], dim=-1).T.contiguous()
    return raw, hs + [feat, hv], enc, encv


def fused_nerf_fwd_plain(params: Mapping[str, torch.Tensor], pts_t: torch.Tensor,
                         viewdirs_t: torch.Tensor, S: int, *, depth: int,
                         width: int, multires: int, multires_views: int,
                         dtype=torch.float32, skips=()) -> torch.Tensor:
    """Kernel 1's twin: ``pts_t [3, P]``, ``viewdirs_t [3, P // S]`` ->
    raw ``[4, P]``."""
    return _forward_plain(params, pts_t, viewdirs_t, S, depth, width,
                          multires, multires_views, dtype, skips)[0]


def bf16_product_witness(params, pts_t, viewdirs_t, acts, S: int, *,
                         depth: int, width: int, multires: int,
                         multires_views: int, skips=()):
    """How often the bfloat16 forward's products round an activation the
    wrong way, against a witness independent of the kernels and of any
    float32 summation order: each trunk layer, the feature layer and the
    view layer recomputed from ``acts``' own inputs (kernel 4's saved
    activations, :func:`split_acts`) with float64 products of the same
    bfloat16 operands, rounded once. Returns, per layer, the share of
    ``acts`` off that exact rounding, and the same share for float32
    products on the same inputs (the float32 twin's arithmetic, and the
    float32-FMA tile's before the tensor cores)."""
    P = pts_t.shape[1]
    e_p = 3 + 6 * multires
    ls = live_skips(depth, skips)
    w, b = _plain_weights(params, torch.bfloat16)
    enc, encv = _plain_encodings(pts_t, viewdirs_t, multires, multires_views,
                                 torch.bfloat16)
    got = [a.float() for a in split_acts(acts, P, depth, width)]
    # per layer: (input, weight [out, in], bias, ReLU, per-ray term or None)
    layers = []
    for i in range(depth):
        x = enc if i == 0 else got[i - 1]
        if (i - 1) in ls:
            x = torch.cat([enc, x], 1)
        layers.append((x, w(f"trunk_{i}"), b(f"trunk_{i}"), True, None))
    layers.append((got[depth - 1], w("feature"), b("feature"), False, None))
    wv = w("views_0")
    hv_ray = {dt: (encv.to(dt) @ wv[:, width:].T.to(dt)).float()
              .to(torch.bfloat16).float().repeat_interleave(S, dim=0)
              for dt in (torch.float32, torch.float64)}
    layers.append((got[depth], wv[:, :width], b("views_0"), True, hv_ray))

    def rounded(x, wl, bl, relu, hv, dt):
        z = x.to(dt) @ wl.T.to(dt)
        if hv is not None:
            z = z + hv[dt].to(dt)
        z = z + bl.to(dt)
        return (torch.relu(z) if relu else z).float().to(torch.bfloat16).float()

    kernel, f32 = [], []
    for (x, wl, bl, relu, hv), a in zip(layers, got):
        exact = rounded(x, wl, bl, relu, hv, torch.float64)
        kernel.append((a != exact).float().mean().item())
        f32.append((rounded(x, wl, bl, relu, hv, torch.float32) != exact)
                   .float().mean().item())
    return {"kernel": kernel, "float32": f32}


def split_acts(acts: torch.Tensor, P: int, depth: int, width: int):
    """Views of a saved-activation buffer (kernel 4's layout): D trunk and
    one feature ``[P, W]`` array, then the view activation ``[P, W/2]``."""
    n = P * width
    return ([acts[l * n:(l + 1) * n].view(P, width) for l in range(depth + 1)]
            + [acts[(depth + 1) * n:].view(P, width // 2)])


def fused_nerf_fwd_acts_plain(params, pts_t, viewdirs_t, S: int, *,
                              depth: int, width: int, multires: int,
                              multires_views: int, dtype=torch.float32,
                              skips=()):
    """Kernel 4's twin: raw ``[4, P]`` and the saved activations as one
    ``dtype`` buffer (:func:`split_acts` gives the arrays)."""
    raw, acts, _, _ = _forward_plain(params, pts_t, viewdirs_t, S, depth,
                                     width, multires, multires_views, dtype,
                                     skips)
    return raw, torch.cat([a.to(dtype).reshape(-1) for a in acts])


def _segments(P: int, S: int, device, start: int = 0):
    """Segment of each of the points ``start .. start + P - 1`` (``start``
    a multiple of the tile; a segment is a maximal run of one ray inside one
    kernel tile) and the ray of each segment: the kernel sums the view-layer
    gradient of a ray over its points in one tile, then rounds."""
    p = torch.arange(start, start + P, device=device)
    first = (p % TILE == 0) | (p % S == 0)
    seg = torch.cumsum(first.long(), 0) - 1
    return seg, p[first] // S


def _bwd_from_acts(params, enc, encv, acts, g, S, depth, width, dtype, skips,
                   dfeat_ray=None):
    """The backward tile body (``_bwd_tile_body``) over all points at once:
    gradients of every parameter, as the kernels compute them. With
    ``dfeat_ray [N, W]`` (the semantic head's feature cotangent, kernel 8),
    each point's ray row is added to the feature cotangent in float32
    before it is rounded."""
    ls = live_skips(depth, skips)
    e_p = enc.shape[1]

    def rnd(x):
        return x.to(dtype).float()

    w, _ = _plain_weights(params, dtype)
    g = g.float()
    gb = rnd(g)  # [4, P]
    hs, feat, hv = acts[:depth], acts[depth], acts[depth + 1]
    out = {"rgb.weight": gb[:3] @ hv, "rgb.bias": g[:3].sum(1),
           "sigma.bias": g[3:].sum(1)}
    dhv = rnd(torch.where(hv > 0, gb[:3].T @ w("rgb"), 0.0))  # [P, W/2]
    seg, ray = _segments(g.shape[1], S, g.device)
    seg_sum = rnd(torch.zeros((ray.numel(), width // 2), device=g.device)
                  .index_add_(0, seg, dhv))
    out["views_0.weight"] = torch.cat([dhv.T @ feat, seg_sum.T @ encv[ray]],
                                      dim=1)
    out["views_0.bias"] = dhv.sum(0)
    dfeat = dhv @ w("views_0")[:, :width]
    if dfeat_ray is not None:
        dfeat = dfeat + dfeat_ray.float().repeat_interleave(S, dim=0)
    dfeat = rnd(dfeat)
    h = hs[-1]
    out["feature.weight"] = dfeat.T @ h
    out["feature.bias"] = dfeat.sum(0)
    out["sigma.weight"] = gb[3:] @ h
    dh = dfeat @ w("feature") + gb[3][:, None] * w("sigma")
    for l in range(depth - 1, -1, -1):
        dh = rnd(torch.where(hs[l] > 0, dh, 0.0))
        out[f"trunk_{l}.bias"] = dh.sum(0)
        if l == 0:
            out["trunk_0.weight"] = dh.T @ enc
            break
        dw = dh.T @ hs[l - 1]
        wl = w(f"trunk_{l}")
        if (l - 1) in ls:
            dw = torch.cat([dh.T @ enc, dw], dim=1)
            wl = wl[:, e_p:]
        out[f"trunk_{l}.weight"] = dw
        dh = dh @ wl
    return out


def fused_nerf_bwd_acts_plain(params, pts_t, viewdirs_t, g, acts, S: int, *,
                              depth: int, width: int, multires: int,
                              multires_views: int, dtype=torch.float32,
                              skips=(), dfeat_ray=None
                              ) -> Dict[str, torch.Tensor]:
    """Kernel 5's twin: parameter gradients for the cotangent ``g [4, P]``
    of raw, from the saved activations ``acts`` of kernel 4 (``dfeat_ray``:
    see :func:`_bwd_from_acts`)."""
    P = pts_t.shape[1]
    enc, encv = _plain_encodings(pts_t, viewdirs_t, multires, multires_views,
                                 dtype)
    arrays = [a.float() for a in split_acts(acts, P, depth, width)]
    return _bwd_from_acts(params, enc, encv, arrays, g, S, depth, width,
                          dtype, skips, dfeat_ray)


def fused_nerf_bwd_plain(params, pts_t, viewdirs_t, g, S: int, *, depth: int,
                         width: int, multires: int, multires_views: int,
                         dtype=torch.float32, skips=(),
                         flags: torch.Tensor | None = None
                         ) -> Dict[str, torch.Tensor]:
    """Kernels 2 and 3's twin: recompute the forward, then backpropagate.
    With ``flags`` (one per 64-point tile) a tile whose flag is 0 adds
    nothing, as kernel 3 skips it."""
    if flags is not None:
        keep = flags.to(torch.bool).repeat_interleave(TILE)[:g.shape[1]]
        g = torch.where(keep, g.float(), 0.0)
    _, acts, enc, encv = _forward_plain(params, pts_t, viewdirs_t, S, depth,
                                        width, multires, multires_views,
                                        dtype, skips)
    return _bwd_from_acts(params, enc, encv, acts, g, S, depth, width, dtype,
                          skips)


# ------------------------------------------- semantic twins (kernels 6-8)

HEAD_RAYS_BWD = 16  # rays per step of the head's backward (kHeadRays, bwd.cu)


def _check_sem_samples(S: int):
    """The semantic kernels take S that divides the 64-point tile or that
    the tile divides (``sem_aligned`` in ``csrc/fused_nerf.cuh``), so no ray
    straddles a tile unaligned; :func:`supports_semantic` admits no other."""
    if S < 1 or (TILE % S and S % TILE):
        raise ValueError(f"semantic kernels need S dividing {TILE} or a "
                         f"multiple of it, got S={S}")


def sem_tile_slots(S: int) -> int:
    """Partial-sum slots per 64-point tile (``sem_tile_slots`` in
    ``csrc/fused_nerf.cuh``): the rays that touch one tile."""
    return max(1, TILE // S)


def sem_tile_partials_plain(feat: torch.Tensor, S: int) -> torch.Tensor:
    """Kernels 6 and 7's partial sums: the feature activation ``feat [P,
    W]`` summed in float32 over each ray's points in each 64-point tile, in
    point order, as ``[tiles, sem_tile_slots(S), W]``; slot r of tile t holds
    ray ``64 t // S + r`` (slots past the last ray are zero here and
    unwritten by the kernels)."""
    _check_sem_samples(S)
    P, W = feat.shape
    seg, ray = _segments(P, S, feat.device)
    part = torch.zeros((ray.numel(), W), device=feat.device).index_add_(
        0, seg, feat.float())
    p = torch.arange(P, device=feat.device)
    tile = p[(p % TILE == 0) | (p % S == 0)] // TILE  # tile of each segment
    out = torch.zeros((-(-P // TILE), sem_tile_slots(S), W),
                      device=feat.device)
    out[tile, ray - (tile * TILE) // S] = part
    return out


def sem_head_plain(fpart: torch.Tensor, sem: SemPacked, n_rays: int, S: int):
    """The semantic head kernel's twin (JAX ``_sem_head_tile``): a ray's
    partials added in tile order and rounded (``fsum``), ``s0r = fsum W_s0 +
    S b_s0`` rounded, logits ``s0r W_s1 + S b_s1`` in float32. Returns the
    logits ``[N, C]`` and ``sem_acts`` (fsum then s0r, ``[N, W + W/2]`` in the
    compute dtype) that kernel 7 saves."""
    _check_sem_samples(S)
    dt = sem.ws0.dtype
    W = fpart.shape[2]
    R = torch.arange(n_rays, device=fpart.device)
    total = torch.zeros((n_rays, W), device=fpart.device)
    for k in range(-(-S // TILE)):  # the tiles a ray spans
        t = (R * S) // TILE + k
        total = total + fpart[t, R - (t * TILE) // S]
    fsum = total.to(dt).float()
    s0r = (fsum @ sem.ws0.float() + S * sem.bs0).to(dt).float()
    logits = s0r @ sem.ws1.float() + S * sem.bs1
    return logits, torch.cat([fsum, s0r], dim=1).to(dt)


def sem_head_bwd_plain(gsem: torch.Tensor, sem_acts: torch.Tensor,
                       sem: SemPacked, S: int):
    """The head backward kernel's twin (the head part of JAX
    ``_bwd_kernel_acts_sem``), on per-ray operands: returns the head's
    float32 gradients flat in the kernels' ``[in, out]`` layout (d W_s0
    ``[W, W/2]``, d b_s0, d W_s1 ``[W/2, C]``, d b_s1) and the feature
    cotangent ``dfeat_ray [N, W]`` in the compute dtype."""
    dt = sem.ws0.dtype
    W = sem.ws0.shape[0]
    gs = gsem.float()
    gsb = gs.to(dt).float()
    fsum, s0r = sem_acts.float().split([W, W // 2], dim=1)
    ds = gsb @ sem.ws1t.float()  # [N, W/2]; no activation between layers
    dsb = ds.to(dt).float()
    dfeat_ray = (dsb @ sem.ws0t.float()).to(dt)
    flat = torch.cat([(fsum.T @ dsb).reshape(-1), S * ds.sum(0),
                      (s0r.T @ gsb).reshape(-1), S * gs.sum(0)])
    return flat, dfeat_ray


def unpack_sem_grads(flat: torch.Tensor, width: int,
                     n_classes: int) -> Dict[str, torch.Tensor]:
    """The head's flat gradients -> ``semantic_0/1`` weights (``[out,
    in]``) and biases."""
    wh = width // 2
    dw0, db0, dw1, db1 = flat.split([width * wh, wh, wh * n_classes,
                                     n_classes])
    return {"semantic_0.weight": dw0.view(width, wh).t().contiguous(),
            "semantic_0.bias": db0.clone(),
            "semantic_1.weight": dw1.view(wh, n_classes).t().contiguous(),
            "semantic_1.bias": db1.clone()}


def fused_nerf_fwd_sem_plain(params, pts_t, viewdirs_t, S: int, *, depth: int,
                             width: int, multires: int, multires_views: int,
                             dtype=torch.float32, skips=()):
    """Kernel 6's twin: raw ``[4, P]`` and the ray-summed semantic logits
    ``[P // S, C]``."""
    raw, acts, _, _ = _forward_plain(params, pts_t, viewdirs_t, S, depth,
                                     width, multires, multires_views, dtype,
                                     skips)
    logits, _ = sem_head_plain(sem_tile_partials_plain(acts[depth], S),
                               pack_sem(params, dtype, pts_t.device),
                               pts_t.shape[1] // S, S)
    return raw, logits


def fused_nerf_fwd_acts_sem_plain(params, pts_t, viewdirs_t, S: int, *,
                                  depth: int, width: int, multires: int,
                                  multires_views: int, dtype=torch.float32,
                                  skips=()):
    """Kernel 7's twin: raw, the saved activations (kernel 4's buffer), the
    logits and ``sem_acts`` (:func:`sem_head_plain`)."""
    raw, acts, _, _ = _forward_plain(params, pts_t, viewdirs_t, S, depth,
                                     width, multires, multires_views, dtype,
                                     skips)
    logits, sem_acts = sem_head_plain(
        sem_tile_partials_plain(acts[depth], S),
        pack_sem(params, dtype, pts_t.device), pts_t.shape[1] // S, S)
    return (raw, torch.cat([a.to(dtype).reshape(-1) for a in acts]), logits,
            sem_acts)


def fused_nerf_bwd_acts_sem_plain(params, pts_t, viewdirs_t, g, gsem, acts,
                                  sem_acts, S: int, *, depth: int, width: int,
                                  multires: int, multires_views: int,
                                  dtype=torch.float32, skips=()
                                  ) -> Dict[str, torch.Tensor]:
    """Kernel 8's twin: gradients of every parameter, the head's included,
    for the raw cotangent ``g [4, P]`` and the logit cotangent ``gsem [N,
    C]``, from kernel 7's ``acts`` and ``sem_acts``."""
    sem = pack_sem(params, dtype, pts_t.device)
    flat, dfeat_ray = sem_head_bwd_plain(gsem, sem_acts, sem, S)
    out = fused_nerf_bwd_acts_plain(
        params, pts_t, viewdirs_t, g, acts, S, depth=depth, width=width,
        multires=multires, multires_views=multires_views, dtype=dtype,
        skips=skips, dfeat_ray=dfeat_ray)
    out.update(unpack_sem_grads(flat, width, sem.bs1.numel()))
    return out

# --------------------------------------------------------------- launches

def _check(pts_t, viewdirs_t, S, dtype):
    if dtype not in _DTYPES:
        raise ValueError(f"dtype must be one of {_DTYPES}, got {dtype}")
    P = pts_t.shape[1]
    if pts_t.shape[0] != 3 or viewdirs_t.shape[0] != 3 or S < 1 or P % S \
            or viewdirs_t.shape[1] != P // S:
        raise ValueError(f"bad shapes pts {tuple(pts_t.shape)} viewdirs "
                         f"{tuple(viewdirs_t.shape)} S={S}")
    if pts_t.device.type not in ("cpu", "cuda") \
            or viewdirs_t.device != pts_t.device:
        raise ValueError(f"unsupported devices {pts_t.device}, "
                         f"{viewdirs_t.device}")


def _packed_for(params, depth, dtype, device, packed):
    if packed is None:
        packed = pack_params(params, depth, dtype, device)
    if packed.dtype != dtype or packed.weights.device != device:
        raise ValueError(f"packed weights are {packed.dtype} on "
                         f"{packed.weights.device}, want {dtype} on {device}")
    return packed


def _tc_ptr(packed):
    return None if packed.weights_p is None else packed.weights_p.data_ptr()


def _offset_ptrs(packed):
    """``w_offsets``, ``b_offsets`` and ``p_offsets`` (None in float32) as
    the launches take them."""
    return (ctypes.addressof(packed.w_offsets),
            ctypes.addressof(packed.b_offsets),
            None if packed.p_offsets is None
            else ctypes.addressof(packed.p_offsets))


def _fwd_launch(fn, packed, pts_t, viewdirs_t, S, depth, width, multires,
                multires_views, skips, acts=None, fpart=None):
    P = pts_t.shape[1]
    out = torch.empty((4, P), dtype=torch.float32, device=pts_t.device)
    skip_mask = sum(1 << s for s in live_skips(depth, skips))
    lib = _build.load(KERNEL, ARGTYPES)
    tail = (P, S, depth, width, multires, multires_views, skip_mask,
            int(packed.dtype == torch.bfloat16), *_offset_ptrs(packed),
            torch.cuda.current_stream(pts_t.device).cuda_stream)
    head = (pts_t.data_ptr(), viewdirs_t.data_ptr(), packed.weights.data_ptr(),
            _tc_ptr(packed), packed.biases.data_ptr(), out.data_ptr())
    if fpart is not None:
        err = lib.fused_nerf_fwd_sem_launch(
            *head, None if acts is None else acts.data_ptr(),
            fpart.data_ptr(), fpart.shape[1], *tail)
    elif acts is None:
        err = lib.fused_nerf_fwd_launch(*head, *tail)
    else:
        err = lib.fused_nerf_fwd_acts_launch(*head, acts.data_ptr(), *tail)
    _build.check(lib, KERNEL, err)
    fn.launches += 1
    return out


def fused_nerf_fwd(params: Mapping[str, torch.Tensor], pts_t: torch.Tensor,
                   viewdirs_t: torch.Tensor, S: int, *, depth: int, width: int,
                   multires: int, multires_views: int, dtype=torch.float32,
                   skips=(), packed: PackedParams | None = None) -> torch.Tensor:
    """Kernel 1: raw ``[4, P]`` for points ``pts_t [3, P]`` (point p on ray
    p // S) and unit view directions ``viewdirs_t [3, P // S]``, float32.

    Under autograd, with any parameter requiring a gradient, the call goes
    through :class:`FusedRecompute` (dense backward, kernel 2). ``packed``
    is ``pack_params(params, depth, dtype)`` made once by a caller that
    launches many times with unchanged weights; without it every launch
    packs the weights anew."""
    _check(pts_t, viewdirs_t, S, dtype)
    kw = dict(depth=depth, width=width, multires=multires,
              multires_views=multires_views, dtype=dtype, skips=skips)
    if torch.is_grad_enabled() and any(p.requires_grad
                                       for p in params.values()):
        return FusedRecompute.run(params, pts_t, viewdirs_t, S, culled=False,
                                  **kw)
    if pts_t.device.type == "cpu":
        return fused_nerf_fwd_plain(params, pts_t, viewdirs_t, S, **kw)
    packed = _packed_for(params, depth, dtype, pts_t.device, packed)
    return _fwd_launch(fused_nerf_fwd, packed, pts_t.float().contiguous(),
                       viewdirs_t.float().contiguous(), S, depth, width,
                       multires, multires_views, skips)


fused_nerf_fwd.launches = 0


def fused_nerf_fwd_acts(params: Mapping[str, torch.Tensor], pts_t, viewdirs_t,
                        S: int, *, depth: int, width: int, multires: int,
                        multires_views: int, dtype=torch.float32, skips=(),
                        packed: PackedParams | None = None):
    """Kernel 4: raw ``[4, P]`` and the saved activations (one ``dtype``
    buffer, :func:`split_acts`), for :func:`fused_nerf_bwd_acts`."""
    _check(pts_t, viewdirs_t, S, dtype)
    kw = dict(depth=depth, width=width, multires=multires,
              multires_views=multires_views, dtype=dtype, skips=skips)
    if pts_t.device.type == "cpu":
        return fused_nerf_fwd_acts_plain(params, pts_t, viewdirs_t, S, **kw)
    packed = _packed_for(params, depth, dtype, pts_t.device, packed)
    P = pts_t.shape[1]
    acts = torch.empty(((depth + 1) * P * width + P * (width // 2),),
                       dtype=dtype, device=pts_t.device)
    raw = _fwd_launch(fused_nerf_fwd_acts, packed, pts_t.float().contiguous(),
                      viewdirs_t.float().contiguous(), S, depth, width,
                      multires, multires_views, skips, acts=acts)
    return raw, acts


fused_nerf_fwd_acts.launches = 0


def _sem_packed_for(params, depth, dtype, device, packed):
    packed = _packed_for(params, depth, dtype, device, packed)
    if packed.sem is None:
        raise ValueError("the packed weights hold no semantic head")
    return packed


def sem_head(fpart: torch.Tensor, sem: SemPacked, n_rays: int, S: int,
             save: bool = False):
    """The semantic head of kernels 6 and 7 (``fused_nerf_sem_head`` in
    ``csrc/fused_nerf_fwd.cu``): logits ``[N, C]`` float32 from the tile
    partials ``fpart``, and with ``save`` the ``sem_acts`` that kernel 8
    reads (else None). CPU tensors run :func:`sem_head_plain`."""
    _check_sem_samples(S)
    if fpart.device.type == "cpu":
        logits, sem_acts = sem_head_plain(fpart, sem, n_rays, S)
        return logits, (sem_acts if save else None)
    W, C = fpart.shape[2], sem.bs1.numel()
    dev = fpart.device
    logits = torch.empty((n_rays, C), dtype=torch.float32, device=dev)
    sem_acts = (torch.empty((n_rays, W + W // 2), dtype=sem.ws0.dtype,
                            device=dev) if save else None)
    lib = _build.load(KERNEL, ARGTYPES)
    err = lib.fused_nerf_sem_head_launch(
        fpart.data_ptr(), sem.ws0.data_ptr(), sem.bs0.data_ptr(),
        sem.ws1.data_ptr(), sem.bs1.data_ptr(), logits.data_ptr(),
        None if sem_acts is None else sem_acts.data_ptr(), fpart.shape[1],
        n_rays, S, W, C, int(sem.ws0.dtype == torch.bfloat16),
        torch.cuda.current_stream(dev).cuda_stream)
    _build.check(lib, KERNEL, err)
    sem_head.launches += 1
    return logits, sem_acts


sem_head.launches = 0


def _fwd_sem(fn, params, pts_t, viewdirs_t, S, kw, packed, save):
    packed = _sem_packed_for(params, kw["depth"], kw["dtype"], pts_t.device,
                             packed)
    P, width, depth = pts_t.shape[1], kw["width"], kw["depth"]
    fpart = torch.empty((-(-P // TILE), sem_tile_slots(S), width),
                        dtype=torch.float32, device=pts_t.device)
    acts = (torch.empty(((depth + 1) * P * width + P * (width // 2),),
                        dtype=kw["dtype"], device=pts_t.device)
            if save else None)
    raw = _fwd_launch(fn, packed, pts_t.float().contiguous(),
                      viewdirs_t.float().contiguous(), S, depth, width,
                      kw["multires"], kw["multires_views"], kw["skips"],
                      acts=acts, fpart=fpart)
    logits, sem_acts = sem_head(fpart, packed.sem, P // S, S, save=save)
    return raw, acts, logits, sem_acts


def fused_nerf_fwd_sem(params: Mapping[str, torch.Tensor], pts_t, viewdirs_t,
                       S: int, *, depth: int, width: int, multires: int,
                       multires_views: int, dtype=torch.float32, skips=(),
                       packed: PackedParams | None = None):
    """Kernel 6: raw ``[4, P]`` and the ray-summed semantic logits ``[P // S,
    C]`` float32 of a model with a semantic head (then :func:`sem_head`).
    It computes no gradient: :func:`fused_nerf_apply_rays_semantic` takes
    :class:`FusedSem` (kernels 7 and 8) under autograd. ``packed`` as for
    :func:`fused_nerf_fwd`."""
    _check(pts_t, viewdirs_t, S, dtype)
    _check_sem_samples(S)
    kw = dict(depth=depth, width=width, multires=multires,
              multires_views=multires_views, dtype=dtype, skips=skips)
    if pts_t.device.type == "cpu":
        return fused_nerf_fwd_sem_plain(params, pts_t, viewdirs_t, S, **kw)
    raw, _, logits, _ = _fwd_sem(fused_nerf_fwd_sem, params, pts_t,
                                 viewdirs_t, S, kw, packed, save=False)
    return raw, logits


fused_nerf_fwd_sem.launches = 0


def fused_nerf_fwd_acts_sem(params: Mapping[str, torch.Tensor], pts_t,
                            viewdirs_t, S: int, *, depth: int, width: int,
                            multires: int, multires_views: int,
                            dtype=torch.float32, skips=(),
                            packed: PackedParams | None = None):
    """Kernel 7: raw, the saved activations (kernel 4's buffer), the logits
    and ``sem_acts`` (each ray's feature sum and first head layer, ``[N, W +
    W/2]`` in ``dtype``), for :func:`fused_nerf_bwd_acts_sem`."""
    _check(pts_t, viewdirs_t, S, dtype)
    _check_sem_samples(S)
    kw = dict(depth=depth, width=width, multires=multires,
              multires_views=multires_views, dtype=dtype, skips=skips)
    if pts_t.device.type == "cpu":
        return fused_nerf_fwd_acts_sem_plain(params, pts_t, viewdirs_t, S,
                                             **kw)
    return _fwd_sem(fused_nerf_fwd_acts_sem, params, pts_t, viewdirs_t, S,
                    kw, packed, save=True)


fused_nerf_fwd_acts_sem.launches = 0

_SM_COUNT: Dict[int, int] = {}


def _grid(device, n_tiles: int) -> int:
    """One block per SM (or per tile, if fewer)."""
    idx = device.index if device.index is not None else \
        torch.cuda.current_device()
    if idx not in _SM_COUNT:
        _SM_COUNT[idx] = torch.cuda.get_device_properties(
            idx).multi_processor_count
    return max(1, min(n_tiles, _SM_COUNT[idx]))


def grad_reduce(part: torch.Tensor, n: int) -> torch.Tensor:
    """``part [G, stride]`` -> the float32 sum over G of its first ``n``
    columns, by ``fused_nerf_grad_reduce`` in a fixed order (on the CPU,
    the twin of the split backward, by ``torch.sum``)."""
    if part.device.type == "cpu":
        return part[:, :n].sum(0)
    out = torch.empty((n,), dtype=torch.float32, device=part.device)
    lib = _build.load(BWD_KERNEL, BWD_ARGTYPES)
    err = lib.fused_nerf_grad_reduce_launch(
        part.data_ptr(), part.shape[1], part.shape[0], n, out.data_ptr(),
        torch.cuda.current_stream(part.device).cuda_stream)
    _build.check(lib, BWD_KERNEL, err)
    grad_reduce.launches += 1
    return out


grad_reduce.launches = 0


def _bwd_launch(fn, mode, params, packed, pts_t, viewdirs_t, g, S, depth,
                width, multires, multires_views, skips, flags=None,
                acts=None, dfeat_ray=None):
    dev = pts_t.device
    P = pts_t.shape[1]
    n_tiles = -(-P // TILE)
    G = _grid(dev, n_tiles)
    n_w, n_b = packed.weights.numel(), packed.biases.numel()
    stride = -(-(n_w + n_b) // 4) * 4
    part = torch.zeros((G, stride), dtype=torch.float32, device=dev)
    scratch = None
    if mode != 2:
        scratch = torch.empty(
            (G * ((depth + 1) * TILE * width + TILE * (width // 2)),),
            dtype=packed.dtype, device=dev)
    lib = _build.load(BWD_KERNEL, BWD_ARGTYPES)
    err = lib.fused_nerf_bwd_launch(
        mode, pts_t.data_ptr(), viewdirs_t.data_ptr(), g.data_ptr(),
        None if flags is None else flags.data_ptr(),
        None if acts is None else acts.data_ptr(),
        None if dfeat_ray is None else dfeat_ray.data_ptr(),
        packed.weights.data_ptr(), packed.weights_t.data_ptr(),
        _tc_ptr(packed), None if packed.weights_ip is None
        else packed.weights_ip.data_ptr(), packed.biases.data_ptr(),
        None if scratch is None else scratch.data_ptr(), part.data_ptr(),
        stride, G, n_w, P, S, depth, width, multires, multires_views,
        sum(1 << s for s in live_skips(depth, skips)),
        int(packed.dtype == torch.bfloat16), *_offset_ptrs(packed),
        torch.cuda.current_stream(dev).cuda_stream)
    _build.check(lib, BWD_KERNEL, err)
    fn.launches += 1
    return unpack_grads(grad_reduce(part, n_w + n_b), params, packed, depth)


def _check_acts(acts, P, depth, width, dtype, device):
    if acts.dtype != dtype or acts.numel() != (depth + 1) * P * width \
            + P * (width // 2) or acts.device != device:
        raise ValueError(f"bad activations {acts.dtype} "
                         f"{tuple(acts.shape)} on {acts.device}")


def _bwd_inputs(pts_t, viewdirs_t, g, S, dtype):
    _check(pts_t, viewdirs_t, S, dtype)
    if g.shape != (4, pts_t.shape[1]) or g.device != pts_t.device:
        raise ValueError(f"bad cotangent {tuple(g.shape)} on {g.device}")
    return (pts_t.float().contiguous(), viewdirs_t.float().contiguous(),
            g.float().contiguous())


def fused_nerf_bwd(params, pts_t, viewdirs_t, g, S: int, *, depth: int,
                   width: int, multires: int, multires_views: int,
                   dtype=torch.float32, skips=(),
                   packed: PackedParams | None = None
                   ) -> Dict[str, torch.Tensor]:
    """Kernel 2, the dense recompute backward: parameter gradients
    (float32, in the ``params`` mapping) for the cotangent ``g [4, P]`` of
    :func:`fused_nerf_fwd`'s raw output."""
    pts_t, viewdirs_t, g = _bwd_inputs(pts_t, viewdirs_t, g, S, dtype)
    kw = dict(depth=depth, width=width, multires=multires,
              multires_views=multires_views, skips=skips)
    if pts_t.device.type == "cpu":
        return fused_nerf_bwd_plain(params, pts_t, viewdirs_t, g, S,
                                    dtype=dtype, **kw)
    packed = _packed_for(params, depth, dtype, pts_t.device, packed)
    return _bwd_launch(fused_nerf_bwd, 0, params, packed, pts_t, viewdirs_t,
                       g, S, **kw)


fused_nerf_bwd.launches = 0


def fused_nerf_bwd_culled(params, pts_t, viewdirs_t, g, S: int,
                          flags: torch.Tensor, *, depth: int, width: int,
                          multires: int, multires_views: int,
                          dtype=torch.float32, skips=(),
                          packed: PackedParams | None = None
                          ) -> Dict[str, torch.Tensor]:
    """Kernel 3: :func:`fused_nerf_bwd` that skips every 64-point tile whose
    ``flags`` entry (int32, one per tile) is 0; exact when those tiles'
    cotangents are all zero. :func:`culled_layout` makes such inputs."""
    pts_t, viewdirs_t, g = _bwd_inputs(pts_t, viewdirs_t, g, S, dtype)
    if flags.shape != (-(-pts_t.shape[1] // TILE),) \
            or flags.device != pts_t.device:
        raise ValueError(f"bad flags {tuple(flags.shape)} on {flags.device}")
    kw = dict(depth=depth, width=width, multires=multires,
              multires_views=multires_views, skips=skips)
    if pts_t.device.type == "cpu":
        return fused_nerf_bwd_plain(params, pts_t, viewdirs_t, g, S,
                                    dtype=dtype, flags=flags, **kw)
    packed = _packed_for(params, depth, dtype, pts_t.device, packed)
    return _bwd_launch(fused_nerf_bwd_culled, 1, params, packed, pts_t,
                       viewdirs_t, g, S, flags=flags.int().contiguous(), **kw)


fused_nerf_bwd_culled.launches = 0


def fused_nerf_bwd_acts(params, pts_t, viewdirs_t, g, acts, S: int, *,
                        depth: int, width: int, multires: int,
                        multires_views: int, dtype=torch.float32, skips=(),
                        packed: PackedParams | None = None
                        ) -> Dict[str, torch.Tensor]:
    """Kernel 5: the backward from the activations kernel 4 saved. On the
    card in bfloat16 it is the split backward (:func:`_bwd_split`: phases 1
    and 2 a chunk, one reduction), and :func:`fused_nerf_bwd_chain` counts
    its launches."""
    pts_t, viewdirs_t, g = _bwd_inputs(pts_t, viewdirs_t, g, S, dtype)
    _check_acts(acts, pts_t.shape[1], depth, width, dtype, pts_t.device)
    kw = dict(depth=depth, width=width, multires=multires,
              multires_views=multires_views, skips=skips)
    if pts_t.device.type == "cpu":
        return fused_nerf_bwd_acts_plain(params, pts_t, viewdirs_t, g, acts,
                                         S, dtype=dtype, **kw)
    packed = _packed_for(params, depth, dtype, pts_t.device, packed)
    if dtype == torch.bfloat16:
        return _bwd_split(params, packed, pts_t, viewdirs_t, g,
                          acts.contiguous(), S, dtype=dtype, **kw)
    return _bwd_launch(fused_nerf_bwd_acts, 2, params, packed, pts_t,
                       viewdirs_t, g, S, acts=acts.contiguous(), **kw)


fused_nerf_bwd_acts.launches = 0


def sem_head_bwd(gsem: torch.Tensor, sem_acts: torch.Tensor, sem: SemPacked,
                 S: int):
    """The semantic head's backward of kernel 8
    (``fused_nerf_sem_head_bwd`` in ``csrc/fused_nerf_bwd.cu``, then
    :func:`grad_reduce`): the head's flat float32 gradients and the feature
    cotangent ``dfeat_ray [N, W]``, as :func:`sem_head_bwd_plain`, which
    CPU tensors run."""
    if gsem.device.type == "cpu":
        return sem_head_bwd_plain(gsem, sem_acts, sem, S)
    dev = gsem.device
    N, C = gsem.shape
    W = sem.ws0.shape[0]
    n_sem = W * (W // 2) + W // 2 + (W // 2) * C + C
    G = _grid(dev, -(-N // HEAD_RAYS_BWD))
    stride = -(-n_sem // 4) * 4
    part = torch.zeros((G, stride), dtype=torch.float32, device=dev)
    dfeat_ray = torch.empty((N, W), dtype=sem.ws0.dtype, device=dev)
    lib = _build.load(BWD_KERNEL, BWD_ARGTYPES)
    err = lib.fused_nerf_sem_head_bwd_launch(
        gsem.data_ptr(), sem_acts.data_ptr(), sem.ws0t.data_ptr(),
        sem.ws1t.data_ptr(), dfeat_ray.data_ptr(), part.data_ptr(), stride,
        G, N, S, W, C, int(sem.ws0.dtype == torch.bfloat16),
        torch.cuda.current_stream(dev).cuda_stream)
    _build.check(lib, BWD_KERNEL, err)
    sem_head_bwd.launches += 1
    return grad_reduce(part, n_sem), dfeat_ray


sem_head_bwd.launches = 0


def fused_nerf_bwd_acts_sem(params, pts_t, viewdirs_t, g, gsem, acts,
                            sem_acts, S: int, *, depth: int, width: int,
                            multires: int, multires_views: int,
                            dtype=torch.float32, skips=(),
                            packed: PackedParams | None = None
                            ) -> Dict[str, torch.Tensor]:
    """Kernel 8: gradients of every parameter (the semantic head's
    included) for the raw cotangent ``g [4, P]`` and the logit cotangent
    ``gsem [P // S, C]``, from what kernel 7 saved: :func:`sem_head_bwd`,
    then kernel 5's body with the head's feature cotangent (in bfloat16 on
    the card, kernel 5's split backward, whose :func:`fused_nerf_bwd_chain`
    counts its launches)."""
    pts_t, viewdirs_t, g = _bwd_inputs(pts_t, viewdirs_t, g, S, dtype)
    N = pts_t.shape[1] // S
    _check_acts(acts, pts_t.shape[1], depth, width, dtype, pts_t.device)
    if sem_acts.dtype != dtype or sem_acts.shape != (N, width + width // 2) \
            or gsem.dim() != 2 or gsem.shape[0] != N \
            or gsem.device != pts_t.device \
            or sem_acts.device != pts_t.device:
        raise ValueError(f"bad semantic inputs {tuple(gsem.shape)}, "
                         f"{sem_acts.dtype} {tuple(sem_acts.shape)}")
    gsem = gsem.float().contiguous()
    kw = dict(depth=depth, width=width, multires=multires,
              multires_views=multires_views, skips=skips)
    if pts_t.device.type == "cpu":
        return fused_nerf_bwd_acts_sem_plain(params, pts_t, viewdirs_t, g,
                                             gsem, acts, sem_acts, S,
                                             dtype=dtype, **kw)
    packed = _sem_packed_for(params, depth, dtype, pts_t.device, packed)
    flat, dfeat_ray = sem_head_bwd(gsem, sem_acts.contiguous(), packed.sem, S)
    if dtype == torch.bfloat16:
        grads = _bwd_split(params, packed, pts_t, viewdirs_t, g,
                           acts.contiguous(), S, dtype=dtype,
                           dfeat_ray=dfeat_ray, **kw)
    else:
        grads = _bwd_launch(fused_nerf_bwd_acts_sem, 2, params, packed, pts_t,
                            viewdirs_t, g, S, acts=acts.contiguous(),
                            dfeat_ray=dfeat_ray, **kw)
    grads.update(unpack_sem_grads(flat, width, gsem.shape[1]))
    return grads


fused_nerf_bwd_acts_sem.launches = 0


# ------------------- the split backward of kernels 5 and 8 (bf16, card)
#
# (The module note.) Composed on the CPU, the phases' twins give
# :func:`_bwd_from_acts` up to the order of float32 sums.

BWD_CHUNK = 1 << 18  # points a chunk of the split backward (4,096 tiles)


def cot_numel(P: int, depth: int, width: int, multires: int) -> int:
    """Elements of the cotangent buffer of ``P`` points (:func:`split_cot`)."""
    return P * ((depth + 1) * width + width // 2 + _pad16(3 + 6 * multires))


def split_cot(cot: torch.Tensor, P: int, depth: int, width: int,
              multires: int):
    """Views of a cotangent buffer of ``P`` points (phase 1's layout, that of
    :func:`split_acts` plus the encoding): ``dh_0 .. dh_{D-1}`` and ``dfeat``
    ``[P, W]``, ``dhv`` ``[P, W/2]``, then the point encoding ``[P, pad16(e_p)]``
    (the columns past ``e_p`` zero)."""
    n, ep16 = P * width, _pad16(3 + 6 * multires)
    hv0 = (depth + 1) * n
    return ([cot[l * n:(l + 1) * n].view(P, width) for l in range(depth + 1)]
            + [cot[hv0:hv0 + P * (width // 2)].view(P, width // 2),
               cot[hv0 + P * (width // 2):hv0 + P * (width // 2) + P * ep16]
               .view(P, ep16)])


def pack_grads(grads: Mapping[str, torch.Tensor], params, depth: int
               ) -> torch.Tensor:
    """:func:`unpack_grads` inverted: the gradients flat in the kernels'
    layout (weights ``[in, out]`` in layer order, then biases), zero for a
    tensor ``grads`` lacks."""
    names = _layer_names(depth)

    def get(k):
        return grads[k].float() if k in grads else \
            torch.zeros(params[k].shape, device=params[k].device)

    return torch.cat([get(f"{n}.weight").t().reshape(-1) for n in names]
                     + [get(f"{n}.bias").reshape(-1) for n in names])


def fused_nerf_bwd_chain_plain(params, pts_t, viewdirs_t, g, acts, S: int,
                               start: int, count: int, *, depth: int,
                               width: int, multires: int, multires_views: int,
                               dtype=torch.float32, skips=(), dfeat_ray=None):
    """Phase 1's twin over the points ``[start, start + count)`` (``start`` a
    multiple of the tile) of :func:`_bwd_from_acts`' arithmetic: the
    cotangent buffer (:func:`split_cot`, in ``dtype``) and the small
    gradients flat in the kernels' layout (:func:`pack_grads`; zero where
    phase 2 adds)."""
    ls = live_skips(depth, skips)
    e_p = 3 + 6 * multires
    sl = slice(start, start + count)

    def rnd(x):
        return x.to(dtype).float()

    w, _ = _plain_weights(params, dtype)
    enc, encv = _plain_encodings(pts_t[:, sl], viewdirs_t, multires,
                                 multires_views, dtype)
    arrays = split_acts(acts, pts_t.shape[1], depth, width)
    hs = [a[sl].float() for a in arrays[:depth]]
    hv = arrays[depth + 1][sl].float()
    g = g[:, sl].float()
    gb = rnd(g)
    dhv = rnd(torch.where(hv > 0, gb[:3].T @ w("rgb"), 0.0))
    seg, ray = _segments(count, S, g.device, start)
    seg_sum = rnd(torch.zeros((ray.numel(), width // 2), device=g.device)
                  .index_add_(0, seg, dhv))
    small = {"rgb.weight": gb[:3] @ hv, "rgb.bias": g[:3].sum(1),
             "sigma.bias": g[3:].sum(1),
             "views_0.weight": torch.cat([
                 torch.zeros((width // 2, width), device=g.device),
                 seg_sum.T @ encv[ray]], dim=1),
             "views_0.bias": dhv.sum(0)}
    dfeat = dhv @ w("views_0")[:, :width]
    if dfeat_ray is not None:
        rays = torch.arange(start, start + count, device=g.device) // S
        dfeat = dfeat + dfeat_ray.float()[rays]
    dfeat = rnd(dfeat)
    small["feature.bias"] = dfeat.sum(0)
    small["sigma.weight"] = gb[3:] @ hs[-1]
    dh = dfeat @ w("feature") + gb[3][:, None] * w("sigma")
    dhs = [None] * depth
    for l in range(depth - 1, -1, -1):
        dh = rnd(torch.where(hs[l] > 0, dh, 0.0))
        dhs[l] = dh
        small[f"trunk_{l}.bias"] = dh.sum(0)
        if l == 0:
            break
        wl = w(f"trunk_{l}")
        dh = dh @ (wl[:, e_p:] if (l - 1) in ls else wl)
    enc16 = torch.nn.functional.pad(enc, (0, _pad16(e_p) - e_p))
    cot = torch.cat([x.to(dtype).reshape(-1)
                     for x in dhs + [dfeat, dhv, enc16]])
    return cot, pack_grads(small, params, depth)


def wgrad_entries(acts, cot, P: int, start: int, count: int, depth: int,
                  width: int, multires: int, skips, w_offsets):
    """Phase 2's table for the points ``[start, start + count)``: per
    product ``(a [count, lda], b [count, ldb], m_keep, out, ldo)``, adding
    ``a[:, :m_keep]^T b`` at flat offset ``out`` with row stride ``ldo``:
    the encoding's rows of trunk_0 and of each skip layer (``m_keep = e_p``
    drops the encoding's padded columns), every trunk layer's rows of the
    previous activation, the feature layer, and views_0's feature rows.
    ``acts`` is kernel 4's buffer of ``P`` points, ``cot`` phase 1's of
    ``count``; ``w_offsets`` the packed weights' offsets."""
    e_p = 3 + 6 * multires
    ls = live_skips(depth, skips)
    hs = [a[start:start + count] for a in split_acts(acts, P, depth, width)]
    c = split_cot(cot, count, depth, width, multires)
    dh, dfeat, dhv, enc = c[:depth], c[depth], c[depth + 1], c[depth + 2]
    wo = list(w_offsets)
    out = [(enc, dh[0], e_p, wo[0], width)]
    for l in range(1, depth):
        skip = (l - 1) in ls
        if skip:
            out.append((enc, dh[l], e_p, wo[l], width))
        out.append((hs[l - 1], dh[l], width, wo[l] + (e_p * width if skip
                                                       else 0), width))
    out.append((hs[depth - 1], dfeat, width, wo[depth + 1], width))
    out.append((hs[depth], dhv, width, wo[depth + 2], width // 2))
    return out


def bwd_weight_grads_plain(entries, part: torch.Tensor) -> None:
    """Phase 2's twin: each product of :func:`wgrad_entries` in float32,
    added into row 0 of ``part`` (in place)."""
    for a, b, m_keep, out, ldo in entries:
        blk = part[0, out:out + m_keep * ldo].view(m_keep, ldo)
        blk[:, :b.shape[1]] += a[:, :m_keep].float().T @ b.float()


_WG_TILE, _WG_K = 128, 32  # kWgM = kWgN and kWgK in csrc/fused_nerf_bwd.cu


def _wgrad_splits(entries, count: int, device) -> int:
    """Splits of the points (blocks a product's output tile) that fill the
    card about twice, at most one a stage of 32 points."""
    tiles = sum(-(-m_keep // _WG_TILE) * -(-b.shape[1] // _WG_TILE)
                for _, b, m_keep, _, _ in entries)
    return max(1, min(-(-count // _WG_K), -(-2 * _grid(device, 1 << 30)
                                           // tiles)))


def bwd_weight_grads(entries, part: torch.Tensor, count: int, *,
                     counter=None) -> None:
    """Phase 2 (``fused_nerf_wgrad_kernel``): the products of
    :func:`wgrad_entries` over ``count`` points, each split of the points
    added into its own row of ``part`` (in place; :func:`_wgrad_splits`
    rows). The launch adds one to ``counter.launches`` (by default this
    function's; the packed-lane kernel 13 passes its own). CPU tensors run
    :func:`bwd_weight_grads_plain`."""
    if part.device.type == "cpu":
        return bwd_weight_grads_plain(entries, part)
    splits = _wgrad_splits(entries, count, part.device)
    if splits > part.shape[0]:
        raise ValueError(f"phase 2 takes {splits} partial rows, got "
                         f"{part.shape[0]}")
    table = []
    for a, b, m_keep, out, ldo in entries:
        if a.dtype != torch.bfloat16 or b.dtype != torch.bfloat16 \
                or a.shape[0] != count or b.shape[0] != count \
                or a.stride(1) != 1 or b.stride(1) != 1:
            raise ValueError("phase 2 takes bfloat16 [count, C] rows")
        table += [a.data_ptr(), b.data_ptr(), a.stride(0), b.stride(0),
                  a.shape[1], b.shape[1], m_keep, out, ldo]
    arr = (ctypes.c_longlong * len(table))(*table)
    lib = _build.load(BWD_KERNEL, BWD_ARGTYPES)
    err = lib.fused_nerf_wgrad_launch(
        ctypes.addressof(arr), len(entries), count, part.data_ptr(),
        part.shape[1], splits,
        torch.cuda.current_stream(part.device).cuda_stream)
    _build.check(lib, BWD_KERNEL, err)
    (bwd_weight_grads if counter is None else counter).launches += 1


bwd_weight_grads.launches = 0


def fused_nerf_bwd_chain(params, pts_t, viewdirs_t, g, acts, S: int,
                         start: int, count: int, part: torch.Tensor, *,
                         depth: int, width: int, multires: int,
                         multires_views: int, dtype=torch.float32, skips=(),
                         packed: PackedParams | None = None, dfeat_ray=None,
                         cot: torch.Tensor | None = None) -> torch.Tensor:
    """Phase 1 (``fused_nerf_bwd_acts_kernel`` in bfloat16) over the points
    ``[start, start + count)``: adds the small gradients into ``part`` (in
    place; one row a block) and returns the cotangent buffer
    (:func:`split_cot`; written into ``cot`` if given). On the card it is
    bfloat16 only (float32's backward is one kernel); CPU tensors run
    :func:`fused_nerf_bwd_chain_plain`. Its input products run on the
    tensor cores, except with ``dfeat_ray`` (kernel 8), whose chain keeps
    its twin's float32 FMA order (csrc/fused_nerf_bwd.cu, ``backward_tile``'s
    note). The launch of a call's first chunk (``start == 0``) also counts
    as one of kernel 5 (:func:`fused_nerf_bwd_acts`), or of kernel 8's
    trunk (:func:`fused_nerf_bwd_acts_sem`) with ``dfeat_ray``."""
    kw = dict(depth=depth, width=width, multires=multires,
              multires_views=multires_views, skips=skips)
    if start % TILE or count < 1 or start + count > pts_t.shape[1]:
        raise ValueError(f"bad chunk [{start}, {start + count})")
    if pts_t.device.type == "cpu":
        out, small = fused_nerf_bwd_chain_plain(
            params, pts_t, viewdirs_t, g, acts, S, start, count, dtype=dtype,
            dfeat_ray=dfeat_ray, **kw)
        part[0, :small.numel()] += small
        return out
    if dtype != torch.bfloat16:
        raise ValueError("the split backward is bfloat16 on the card")
    P = pts_t.shape[1]
    for x, dt, shape in ((pts_t, torch.float32, (3, P)),
                         (viewdirs_t, torch.float32, (3, P // S)),
                         (g, torch.float32, (4, P)), (acts, dtype, acts.shape),
                         (part, torch.float32, part.shape)):
        if x.dtype != dt or x.shape != shape or not x.is_contiguous() \
                or x.device != pts_t.device:
            raise ValueError(f"bad input {x.dtype} {tuple(x.shape)} on "
                             f"{x.device}")
    _check_acts(acts, P, depth, width, dtype, pts_t.device)
    if dfeat_ray is not None and (dfeat_ray.dtype != dtype
                                  or dfeat_ray.shape != (P // S, width)
                                  or not dfeat_ray.is_contiguous()):
        raise ValueError(f"bad dfeat_ray {tuple(dfeat_ray.shape)}")
    packed = _packed_for(params, depth, dtype, pts_t.device, packed)
    n = cot_numel(count, depth, width, multires)
    if cot is None:
        cot = torch.empty((n,), dtype=dtype, device=pts_t.device)
    elif cot.dtype != dtype or cot.numel() < n or not cot.is_contiguous():
        raise ValueError(f"bad cotangent buffer {cot.dtype} {cot.numel()}")
    G = min(part.shape[0], _grid(pts_t.device, -(-count // TILE)))
    lib = _build.load(BWD_KERNEL, BWD_ARGTYPES)
    err = lib.fused_nerf_bwd_chain_launch(
        pts_t.data_ptr(), viewdirs_t.data_ptr(), g.data_ptr(), acts.data_ptr(),
        None if dfeat_ray is None else dfeat_ray.data_ptr(),
        packed.weights.data_ptr(), packed.weights_t.data_ptr(),
        packed.weights_ip.data_ptr(), packed.biases.data_ptr(),
        cot.data_ptr(), part.data_ptr(),
        part.shape[1], G, packed.weights.numel(), P, S, start,
        count, depth, width, multires, multires_views,
        sum(1 << k for k in live_skips(depth, skips)),
        ctypes.addressof(packed.w_offsets), ctypes.addressof(packed.b_offsets),
        torch.cuda.current_stream(pts_t.device).cuda_stream)
    _build.check(lib, BWD_KERNEL, err)
    fused_nerf_bwd_chain.launches += 1
    if start == 0:
        (fused_nerf_bwd_acts if dfeat_ray is None
         else fused_nerf_bwd_acts_sem).launches += 1
    return cot[:n]


fused_nerf_bwd_chain.launches = 0


def _bwd_split(params, packed, pts_t, viewdirs_t, g, acts, S, *, depth,
               width, multires, multires_views, dtype, skips, dfeat_ray=None):
    """Kernels 5 and 8's trunk as the split backward: phases 1 and 2 over
    chunks of ``BWD_CHUNK`` points (a multiple of the tile), then
    ``fused_nerf_grad_reduce``. On the CPU the phases' twins and one
    partial row. Returns the gradients in the ``params`` mapping."""
    chunk = BWD_CHUNK
    if chunk % TILE:
        raise ValueError(f"chunk {chunk} is not a multiple of {TILE}")
    dev = pts_t.device
    P = pts_t.shape[1]
    kw = dict(depth=depth, width=width, multires=multires,
              multires_views=multires_views, dtype=dtype, skips=skips)
    n_w, n_b = packed.weights.numel(), packed.biases.numel()
    stride = -(-(n_w + n_b) // 4) * 4
    Pc = min(P, chunk)
    cot = torch.empty((cot_numel(Pc, depth, width, multires),), dtype=dtype,
                      device=dev)
    rows = 1
    if dev.type == "cuda":
        ents = wgrad_entries(acts, cot, P, 0, Pc, depth, width, multires,
                             skips, packed.w_offsets)
        rows = max(_grid(dev, -(-Pc // TILE)), _wgrad_splits(ents, Pc, dev))
    part = torch.zeros((rows, stride), dtype=torch.float32, device=dev)
    for start in range(0, P, chunk):
        count = min(chunk, P - start)
        c = fused_nerf_bwd_chain(params, pts_t, viewdirs_t, g, acts, S, start,
                                 count, part, packed=packed,
                                 dfeat_ray=dfeat_ray, cot=cot, **kw)
        bwd_weight_grads(wgrad_entries(acts, c, P, start, count, depth,
                                       width, multires, skips,
                                       packed.w_offsets), part, count)
    return unpack_grads(grad_reduce(part, n_w + n_b), params, packed, depth)


def bwd_product_witness(params, g, acts, cot, grads, S: int, *, depth: int,
                        width: int, multires: int, skips=(), dfeat_ray=None):
    """The bfloat16 split backward against a witness independent of any
    float32 summation order, as :func:`bf16_product_witness` for the
    forward. ``cot`` is phase 1's buffer for all P points (one chunk) and
    ``grads`` the backward's gradients, from kernel 4's ``acts`` and the
    cotangent ``g``. Per cotangent layer (dhv, dfeat, dh_{D-1} .. dh_0): the
    share of ``cot`` that rounds otherwise than the layer recomputed with
    float64 products from the kernel's own bfloat16 inputs (the next
    layer's cotangent in ``cot``, the weights, ``g``, the gates in ``acts``),
    and the same share for float32 products. Per large weight gradient
    (:func:`wgrad_entries`' products, blocks as :func:`grad_blocks`): the
    max abs error over the mean abs of float64 products of the same
    bfloat16 operands, for ``grads`` and for float32 products."""
    P = g.shape[1]
    e_p = 3 + 6 * multires
    ls = live_skips(depth, skips)
    bf = torch.bfloat16
    w, _ = _plain_weights(params, bf)
    hs = [a.float() for a in split_acts(acts, P, depth, width)]
    c = [x.float() for x in split_cot(cot, P, depth, width, multires)]
    dh, dfeat, dhv, enc = c[:depth], c[depth], c[depth + 1], c[depth + 2]
    gb = g.float().to(bf).float()
    ray_rows = None if dfeat_ray is None else \
        dfeat_ray.float()[torch.arange(P, device=g.device) // S]
    # per layer: (input, the Linear weight [out, in] it multiplies, the term
    # added in float32 or None, the ReLU gate or None, the kernel's output)
    layers = [(gb[:3].T, w("rgb"), None, hs[depth + 1], dhv),
              (dhv, w("views_0")[:, :width], ray_rows, None, dfeat)]
    x = dfeat
    for l in range(depth - 1, -1, -1):
        if l == depth - 1:
            extra = gb[3][:, None] * w("sigma")  # exact in float32 and 64
            wl = w("feature")
        else:
            extra = None
            wl = w(f"trunk_{l + 1}")
            wl = wl[:, e_p:] if l in ls else wl
        layers.append((x, wl, extra, hs[l], dh[l]))
        x = dh[l]

    def rounded(x, wl, extra, gate, dt):
        z = x.to(dt) @ wl.to(dt)
        if extra is not None:
            z = z + extra.to(dt)
        if gate is not None:
            z = torch.where(gate > 0, z, 0.0)
        return z.float().to(bf).float()

    kernel, f32 = [], []
    for x, wl, extra, gate, got in layers:
        exact = rounded(x, wl, extra, gate, torch.float64)
        kernel.append((got != exact).float().mean().item())
        f32.append((rounded(x, wl, extra, gate, torch.float32) != exact)
                   .float().mean().item())

    blocks = grad_blocks(grads, depth, width, multires, skips)
    ref = {"trunk_0.weight": (dh[0], enc[:, :e_p])}
    for l in range(1, depth):
        if (l - 1) in ls:
            ref[f"trunk_{l}.weight[enc]"] = (dh[l], enc[:, :e_p])
            ref[f"trunk_{l}.weight[trunk]"] = (dh[l], hs[l - 1])
        else:
            ref[f"trunk_{l}.weight"] = (dh[l], hs[l - 1])
    ref["feature.weight"] = (dfeat, hs[depth - 1])
    ref["views_0.weight[feat]"] = (dhv, hs[depth])
    wk, w32 = {}, {}
    for k, (d, a) in ref.items():
        exact = d.double().T @ a.double()
        scale = exact.abs().mean().item() + 1e-30
        wk[k] = (blocks[k].double() - exact).abs().max().item() / scale
        w32[k] = ((d.T @ a).double() - exact).abs().max().item() / scale
    return {"kernel": kernel, "float32": f32, "wgrad_kernel": wk,
            "wgrad_float32": w32}


# ----------------------------------------------- culling glue (kernel 3)

def culled_layout(pts_t, viewdirs_t, g, S: int):
    """``_bwd_culled_dparams``' regrouping for kernel 3.

    A ray's live length is 1 + its last sample with a nonzero cotangent.
    Rays are sorted by it (weight gradients are sums over points, so rays
    may move as long as points, view directions and cotangents move
    together) and regrouped into 64-point tiles of 4 rays x 16 samples; a
    tile is live iff the longest of its 4 rays reaches its sample block.
    Returns the regrouped points ``[3, P']``, one view direction per
    (ray, sample block) ``[3, P' / 16]``, cotangents ``[4, P']``, and the
    int32 tile flags; pass ``S = 16`` to the kernel."""
    SB = SAMPLE_BLOCK
    RB = TILE // SB
    N = pts_t.shape[1] // S
    nSB = S // SB
    n_pad = (-N) % RB
    Nf = N + n_pad
    gch = g.reshape(4, N, S)
    xch = pts_t.reshape(3, N, S)
    vr = viewdirs_t
    if n_pad:
        gch = torch.nn.functional.pad(gch, (0, 0, 0, n_pad))
        xch = torch.nn.functional.pad(xch, (0, 0, 0, n_pad))
        vr = torch.nn.functional.pad(vr, (0, n_pad))
    live = (gch != 0).any(0)  # [Nf, S]
    idx1 = torch.arange(1, S + 1, device=g.device, dtype=torch.int32)
    lengths = torch.where(live, idx1, 0).amax(1)
    order = torch.argsort(lengths, stable=True)
    lens = lengths[order]
    nRB = Nf // RB

    def regroup(a):
        c = a.shape[0]
        return (a[:, order].reshape(c, nRB, RB, nSB, SB)
                .permute(0, 1, 3, 2, 4).reshape(c, -1).contiguous())

    vb = (vr[:, order].reshape(3, nRB, 1, RB).expand(3, nRB, nSB, RB)
          .reshape(3, -1).contiguous())
    lmax = lens.reshape(nRB, RB)[:, -1]
    start = torch.arange(nSB, device=g.device, dtype=torch.int32) * SB
    flags = (lmax[:, None] > start[None, :]).int().reshape(-1)
    return regroup(xch), vb, regroup(gch), flags


# -------------------------------- the early-terminating forward (kernel 9)

def cf_layout(pts_t, vd_t, key, deltas, noise, S: int):
    """JAX ``_fwd_impl_cf``'s regrouping for kernel 9.

    Rays (``pts_t [3, N * S]``, ``vd_t [3, N]``, and per sample the
    compositor's distance terms ``deltas [N, S]`` and sigma noise ``noise [N,
    S]``) are padded to a multiple of 128 with key ``+inf``, delta 0 and
    noise 0 (JAX ``_apply_rays_core``: a padded ray sorts last and never
    terminates), sorted by ``key [N]`` (a stable argsort, as
    ``jnp.argsort``; any order is exact, the key only makes groups terminate
    together), and cut into groups of 128 rays, each group into blocks of 128
    rays x 16 samples in sample order. Returns the regrouped points ``[3,
    P']``, one view direction per (ray, block) ``[3, P' / 16]`` (the
    convention of :func:`culled_layout`), ``aux [2, P']`` (deltas, noise) and
    the sort order, for :func:`cf_unlayout`."""
    SB, RB = SAMPLE_BLOCK, CF_RAYS
    N = vd_t.shape[1]
    nSB = S // SB
    n_pad = (-N) % RB
    pad = torch.nn.functional.pad
    x = pts_t.float().reshape(3, N, S)
    aux = torch.stack([deltas.float(), noise.float()])
    key = key.float()
    if n_pad:
        x = pad(x, (0, 0, 0, n_pad))
        vd_t = pad(vd_t, (0, n_pad))
        aux = pad(aux, (0, 0, 0, n_pad))
        key = pad(key, (0, n_pad), value=float("inf"))
    order = torch.argsort(key, stable=True)
    nRB = (N + n_pad) // RB

    def regroup(a):
        c = a.shape[0]
        return (a[:, order].reshape(c, nRB, RB, nSB, SB)
                .permute(0, 1, 3, 2, 4).reshape(c, -1).contiguous())

    vb = (vd_t.float()[:, order].reshape(3, nRB, 1, RB)
          .expand(3, nRB, nSB, RB).reshape(3, -1).contiguous())
    return regroup(x), vb, regroup(aux), order


def cf_unlayout(out_b, order, N: int, S: int):
    """Kernel 9's regrouped output ``[4, P']`` -> ``[4, N * S]`` in the rays'
    own order (JAX's inverse permutation), the padded rays dropped."""
    SB, RB = SAMPLE_BLOCK, CF_RAYS
    Nf = order.numel()
    o = (out_b.reshape(4, Nf // RB, S // SB, RB, SB).permute(0, 1, 3, 2, 4)
         .reshape(4, Nf, S))
    out = torch.empty_like(o)
    out[:, order] = o
    return out[:, :N].reshape(4, N * S)


_CF_DEAD = (0.0, 0.0, 0.0, -1e10)  # raw written for a skipped block


def fused_nerf_fwd_cf_plain(params, xb, vb, aux, S: int, eps: float, *,
                            depth: int, width: int, multires: int,
                            multires_views: int, dtype=torch.float32,
                            skips=()) -> torch.Tensor:
    """Kernel 9's twin (JAX ``_fwd_kernel_cf``) on :func:`cf_layout`'s
    arrays: per group of 128 rays, blocks in sample order; a block runs
    kernel 1's forward (:func:`fused_nerf_fwd_plain`, 16 samples a ray)
    while the largest transmittance of its group is at least ``eps``, else
    it is ``(0, 0, 0, -1e10)``; after a live block each ray's transmittance
    is multiplied by ``exp(sum log(exp(-max(sigma + noise, 0) delta) +
    1e-10))`` over its 16 samples. Returns raw ``[4, P']``, regrouped."""
    SB, RB = SAMPLE_BLOCK, CF_RAYS
    nSB = S // SB
    B = RB * SB
    G = xb.shape[1] // (nSB * B)
    dev = xb.device
    x = xb.reshape(3, G, nSB, B)
    v = vb.reshape(3, G, nSB, RB)
    a = aux.reshape(2, G, nSB, B)
    out = torch.empty((4, G, nSB, B), dtype=torch.float32, device=dev)
    out[:] = torch.tensor(_CF_DEAD, device=dev)[:, None, None, None]
    T = torch.ones((G, RB), dtype=torch.float32, device=dev)
    kw = dict(depth=depth, width=width, multires=multires,
              multires_views=multires_views, dtype=dtype, skips=skips)
    for sb in range(nSB):
        idx = (T.amax(1) >= eps).nonzero()[:, 0]
        if idx.numel() == 0:
            continue
        raw = fused_nerf_fwd_plain(params, x[:, idx, sb].reshape(3, -1),
                                   v[:, idx, sb].reshape(3, -1), SB,
                                   **kw).reshape(4, -1, B)
        out[:, idx, sb] = raw
        sg = torch.relu(raw[3] + a[1, idx, sb]) * a[0, idx, sb]
        logt = torch.log(torch.exp(-sg) + 1e-10).reshape(-1, RB, SB).sum(-1)
        T[idx] = T[idx] * torch.exp(logt)
    return out.reshape(4, -1)


def fused_nerf_fwd_cf(params: Mapping[str, torch.Tensor], xb, vb, aux, S: int,
                      eps: float, *, depth: int, width: int, multires: int,
                      multires_views: int, dtype=torch.float32, skips=(),
                      packed: PackedParams | None = None) -> torch.Tensor:
    """Kernel 9: the early-terminating forward on :func:`cf_layout`'s
    regrouped points ``xb [3, P']``, view directions ``vb [3, P' / 16]`` and
    ``aux [2, P']``, for rays of ``S`` samples and the skip threshold
    ``eps`` (half the compositor's ``cull_eps``). Raw ``[4, P']``, regrouped;
    a skipped block reads ``(0, 0, 0, -1e10)``. No gradient of its own
    (:class:`FusedCullFwd` pairs it with a backward)."""
    if live_skips(depth, skips):
        raise ValueError("kernel 9 has no skip-concat variant")
    nSB = S // SAMPLE_BLOCK
    P = xb.shape[1]
    if S % SAMPLE_BLOCK or nSB < 1 or P % (nSB * CF_RAYS * SAMPLE_BLOCK) \
            or aux.shape != (2, P):
        raise ValueError(f"bad regrouped shapes {tuple(xb.shape)}, "
                         f"{tuple(aux.shape)} for S={S}")
    _check(xb, vb, SAMPLE_BLOCK, dtype)
    kw = dict(depth=depth, width=width, multires=multires,
              multires_views=multires_views, dtype=dtype, skips=skips)
    if xb.device.type == "cpu":
        return fused_nerf_fwd_cf_plain(params, xb, vb, aux, S, eps, **kw)
    packed = _packed_for(params, depth, dtype, xb.device, packed)
    out = torch.empty((4, P), dtype=torch.float32, device=xb.device)
    xb, vb, aux = (t.float().contiguous() for t in (xb, vb, aux))
    lib = _build.load(KERNEL, ARGTYPES)
    err = lib.fused_nerf_fwd_cf_launch(
        xb.data_ptr(), vb.data_ptr(), aux.data_ptr(), packed.weights.data_ptr(),
        _tc_ptr(packed), packed.biases.data_ptr(), out.data_ptr(), P, nSB,
        float(eps), depth, width, multires, multires_views,
        int(packed.dtype == torch.bfloat16), *_offset_ptrs(packed),
        torch.cuda.current_stream(xb.device).cuda_stream)
    _build.check(lib, KERNEL, err)
    fused_nerf_fwd_cf.launches += 1
    return out


fused_nerf_fwd_cf.launches = 0


def _fwd_cf(params, pts_t, vd_t, key, deltas, noise, spec, eps, packed=None):
    """JAX ``_fwd_impl_cf``: :func:`cf_layout`, kernel 9 at ``eps / 2`` (a
    2x margin over the compositor's hard-zero threshold, so float
    reassociation of the transmittance product never skips a sample the
    compositor keeps), :func:`cf_unlayout`. Raw ``[4, N * S]``."""
    xb, vb, aux, order = cf_layout(pts_t, vd_t, key, deltas, noise, spec.S)
    out_b = fused_nerf_fwd_cf(params, xb, vb, aux, spec.S, 0.5 * float(eps),
                              packed=packed, **spec.kw())
    return cf_unlayout(out_b, order, vd_t.shape[1], spec.S)


# ------------------------------------------------------- backward routes

class _Spec(NamedTuple):
    S: int
    depth: int
    width: int
    multires: int
    multires_views: int
    dtype: torch.dtype
    skips: tuple

    def kw(self):
        return dict(depth=self.depth, width=self.width,
                    multires=self.multires,
                    multires_views=self.multires_views, dtype=self.dtype,
                    skips=self.skips)


def _bwd_dense_dparams(params, pts_t, vd_t, g, spec: _Spec, packed=None):
    """Dense recompute backward (kernel 2)."""
    return fused_nerf_bwd(params, pts_t, vd_t, g, spec.S, packed=packed,
                          **spec.kw())


def _bwd_culled_dparams(params, pts_t, vd_t, g, spec: _Spec, packed=None):
    """Cotangent-culled recompute backward (:func:`culled_layout`, then
    kernel 3)."""
    xb, vb, gb, flags = culled_layout(pts_t, vd_t, g, spec.S)
    return fused_nerf_bwd_culled(params, xb, vb, gb, SAMPLE_BLOCK, flags,
                                 packed=packed, **spec.kw())


def _bwd_acts_dparams(params, pts_t, vd_t, acts, g, spec: _Spec, packed=None):
    """Saved-activation backward (kernel 5)."""
    return fused_nerf_bwd_acts(params, pts_t, vd_t, g, acts, spec.S,
                               packed=packed, **spec.kw())


def _bwd_acts_sem_dparams(params, pts_t, vd_t, acts, sem_acts, g, gsem,
                          spec: _Spec, packed=None):
    """Saved-activation backward of the semantic variant (kernel 8)."""
    return fused_nerf_bwd_acts_sem(params, pts_t, vd_t, g, gsem, acts,
                                   sem_acts, spec.S, packed=packed,
                                   **spec.kw())


def _live_pack(params, spec, device):
    # Packed from the live parameters at every differentiated call, so an
    # optimizer step can never leave the kernels a stale copy.
    return (pack_params(params, spec.depth, spec.dtype, device)
            if device.type == "cuda" else None)


class FusedRecompute(torch.autograd.Function):
    """Kernel 1 forward; recompute backward, culled (kernel 3) or dense
    (kernel 2). Points and view directions get no gradient."""

    @staticmethod
    def forward(ctx, spec, culled, names, pts_t, vd_t, *weights):
        params = dict(zip(names, weights))
        packed = _live_pack(params, spec, pts_t.device)
        ctx.spec, ctx.culled, ctx.names, ctx.packed = spec, culled, names, packed
        ctx.save_for_backward(pts_t, vd_t, *weights)
        return fused_nerf_fwd(params, pts_t, vd_t, spec.S, packed=packed,
                              **spec.kw())

    @staticmethod
    def backward(ctx, g):
        pts_t, vd_t, *weights = ctx.saved_tensors
        params = dict(zip(ctx.names, weights))
        fn = _bwd_culled_dparams if ctx.culled else _bwd_dense_dparams
        grads = fn(params, pts_t, vd_t, g.float().contiguous(), ctx.spec,
                   ctx.packed)
        return (None, None, None, None, None,
                *[grads[n] for n in ctx.names])

    @staticmethod
    def run(params, pts_t, vd_t, S, *, culled, depth, width, multires,
            multires_views, dtype, skips):
        spec = _Spec(S, depth, width, multires, multires_views, dtype,
                     live_skips(depth, skips))
        names = param_names(depth)
        return FusedRecompute.apply(spec, culled, names, pts_t.float(),
                                    vd_t.float(), *[params[n] for n in names])


class FusedActs(torch.autograd.Function):
    """Kernel 4 forward (saves activations); kernel 5 backward."""

    @staticmethod
    def forward(ctx, spec, names, pts_t, vd_t, *weights):
        params = dict(zip(names, weights))
        packed = _live_pack(params, spec, pts_t.device)
        ctx.spec, ctx.names, ctx.packed = spec, names, packed
        raw, acts = fused_nerf_fwd_acts(params, pts_t, vd_t, spec.S,
                                        packed=packed, **spec.kw())
        ctx.save_for_backward(pts_t, vd_t, acts, *weights)
        return raw

    @staticmethod
    def backward(ctx, g):
        pts_t, vd_t, acts, *weights = ctx.saved_tensors
        params = dict(zip(ctx.names, weights))
        grads = _bwd_acts_dparams(params, pts_t, vd_t, acts,
                                  g.float().contiguous(), ctx.spec,
                                  ctx.packed)
        return (None, None, None, None, *[grads[n] for n in ctx.names])

    @staticmethod
    def run(params, pts_t, vd_t, S, *, depth, width, multires,
            multires_views, dtype, skips):
        spec = _Spec(S, depth, width, multires, multires_views, dtype,
                     live_skips(depth, skips))
        names = param_names(depth)
        return FusedActs.apply(spec, names, pts_t.float(), vd_t.float(),
                               *[params[n] for n in names])


class FusedSem(torch.autograd.Function):
    """The semantic variant (JAX ``_fused_t_sem`` under a gradient): kernel
    7 forward, which saves the activations and the head's ray sums; kernel
    8 backward. Returns raw ``[4, P]`` and the logits ``[P // S, C]``."""

    @staticmethod
    def forward(ctx, spec, names, pts_t, vd_t, *weights):
        params = dict(zip(names, weights))
        packed = _live_pack(params, spec, pts_t.device)
        ctx.spec, ctx.names, ctx.packed = spec, names, packed
        raw, acts, logits, sem_acts = fused_nerf_fwd_acts_sem(
            params, pts_t, vd_t, spec.S, packed=packed, **spec.kw())
        ctx.save_for_backward(pts_t, vd_t, acts, sem_acts, *weights)
        return raw, logits

    @staticmethod
    def backward(ctx, g, gsem):
        pts_t, vd_t, acts, sem_acts, *weights = ctx.saved_tensors
        params = dict(zip(ctx.names, weights))
        grads = _bwd_acts_sem_dparams(params, pts_t, vd_t, acts, sem_acts,
                                      g.float().contiguous(),
                                      gsem.float().contiguous(), ctx.spec,
                                      ctx.packed)
        return (None, None, None, None, *[grads[n] for n in ctx.names])

    @staticmethod
    def run(params, pts_t, vd_t, S, *, depth, width, multires,
            multires_views, dtype, skips):
        spec = _Spec(S, depth, width, multires, multires_views, dtype,
                     live_skips(depth, skips))
        names = param_names(depth, semantic=True)
        return FusedSem.apply(spec, names, pts_t.float(), vd_t.float(),
                              *[params[n] for n in names])


class FusedCullFwd(torch.autograd.Function):
    """The early-terminating forward under autograd (JAX ``_fused_t_cf``):
    kernel 9 forward; the backward of the un-permuted points (JAX
    ``_vjp_bwd_cf``), culled (kernel 3) unless ``DLNERF_CULL_BWD_CF=0``,
    then dense (kernel 2). A skipped block's samples get an exactly zero
    cotangent from the compositor, so either backward is exact. Points,
    view directions, the key, deltas and noise get no gradient."""

    @staticmethod
    def forward(ctx, spec, names, eps, pts_t, vd_t, key, deltas, noise,
                *weights):
        params = dict(zip(names, weights))
        packed = _live_pack(params, spec, pts_t.device)
        ctx.spec, ctx.names, ctx.packed = spec, names, packed
        ctx.save_for_backward(pts_t, vd_t, *weights)
        return _fwd_cf(params, pts_t, vd_t, key, deltas, noise, spec, eps,
                       packed)

    @staticmethod
    def backward(ctx, g):
        pts_t, vd_t, *weights = ctx.saved_tensors
        params = dict(zip(ctx.names, weights))
        fn = _bwd_culled_dparams if cull_bwd_cf_enabled() \
            else _bwd_dense_dparams
        grads = fn(params, pts_t, vd_t, g.float().contiguous(), ctx.spec,
                   ctx.packed)
        return (None,) * 8 + tuple(grads[n] for n in ctx.names)

    @staticmethod
    def run(params, pts_t, vd_t, S, key, deltas, noise, eps, *, depth, width,
            multires, multires_views, dtype, skips):
        spec = _Spec(S, depth, width, multires, multires_views, dtype,
                     live_skips(depth, skips))
        names = param_names(depth)
        return FusedCullFwd.apply(spec, names, eps, pts_t.float(),
                                  vd_t.float(), key, deltas, noise,
                                  *[params[n] for n in names])


def _points_t(rays_o, rays_d, z_vals):
    """``o + d z`` as ``[3, N * S]``."""
    N, S = z_vals.shape
    ot = rays_o.float().T[:, :, None]
    dt = rays_d.float().T[:, :, None]
    return (ot + dt * z_vals.float()[None]).reshape(3, N * S)


def fused_nerf_apply_rays(params: Mapping[str, torch.Tensor], rays_o, rays_d,
                          viewdirs, z_vals, *, depth: int, width: int,
                          multires: int, multires_views: int,
                          dtype=torch.bfloat16, skips=(),
                          cull_bwd: bool = False, save_acts: bool = False,
                          fwd_cull=None,
                          packed: PackedParams | None = None) -> torch.Tensor:
    """Rays ``[N, 3]`` + depths ``z_vals [N, S]`` -> channel-major raw
    ``[4, N, S]`` (rgb 0-2, sigma 3), as the JAX ``fused_nerf_apply_rays``.

    Points are formed transposed, ``o + d z`` as ``[3, N, S]``; ``viewdirs``
    are the unit pre-NDC directions, one per ray. ``fwd_cull = (key [N],
    deltas [N, S], noise [N, S], cull_eps)`` (the sort key, the
    compositor's distance terms and the exact sigma noise it adds) takes
    the early-terminating forward ("cf", kernel 9, with or without a
    gradient) where :func:`cf_route_ok` holds, as JAX does. Otherwise,
    without a gradient the plain forward runs (``packed`` as for
    :func:`fused_nerf_fwd`); under autograd the route is JAX's:
    ``save_acts`` with :func:`bwd_acts_enabled` and within
    :func:`acts_route_ok` saves activations ("acts");
    otherwise the recompute backward, culled when ``cull_bwd`` and the
    samples divide into 16-sample blocks ("culled"), else dense ("dense").
    """
    N, S = z_vals.shape
    pts_t = _points_t(rays_o, rays_d, z_vals)
    vd_t = viewdirs.float().T
    kw = dict(depth=depth, width=width, multires=multires,
              multires_views=multires_views, dtype=dtype, skips=skips)
    grad = torch.is_grad_enabled() and any(p.requires_grad
                                           for p in params.values())
    if fwd_cull is not None and cf_route_ok(S, fwd_cull[3], depth, skips):
        route = "cf"
        key, deltas, noise, eps = fwd_cull
        if grad:
            raw = FusedCullFwd.run(params, pts_t, vd_t, S, key.detach(),
                                   deltas.detach(), noise.detach(), eps, **kw)
        else:
            raw = _fwd_cf(params, pts_t, vd_t, key, deltas, noise,
                          _Spec(S, depth, width, multires, multires_views,
                                dtype, live_skips(depth, skips)), eps, packed)
    elif not grad:
        route = "forward"
        raw = fused_nerf_fwd(params, pts_t, vd_t, S, packed=packed, **kw)
    elif save_acts and bwd_acts_enabled() \
            and acts_route_ok(N, S, depth, width, dtype):
        route = "acts"
        raw = FusedActs.run(params, pts_t, vd_t, S, **kw)
    else:
        culled = bool(cull_bwd) and cull_blocks_ok(S)
        route = "culled" if culled else "dense"
        raw = FusedRecompute.run(params, pts_t, vd_t, S, culled=culled, **kw)
    fused_nerf_apply_rays.last_route = route
    return raw.reshape(4, N, S)


fused_nerf_apply_rays.last_route = None


def fused_nerf_apply_rays_semantic(params: Mapping[str, torch.Tensor], rays_o,
                                   rays_d, viewdirs, z_vals, *, depth: int,
                                   width: int, multires: int,
                                   multires_views: int, dtype=torch.bfloat16,
                                   skips=(),
                                   packed: PackedParams | None = None):
    """The semantic variant of :func:`fused_nerf_apply_rays` (JAX
    ``fused_nerf_apply_rays_semantic``): raw ``[4, N, S]`` and the
    reference's unweighted sum over samples of the semantic head's logits,
    ``[N, C]`` float32. Without a gradient kernel 6 ("forward"); under
    autograd :class:`FusedSem` ("acts"), as JAX has no other backward for a
    semantic pass (its cotangent is never zero, so nothing culls). Route
    choice by point count is the caller's (``supports_raw_semantic`` of
    ``train.state.FusedMLP``); the route is kept in
    ``fused_nerf_apply_rays_semantic.last_route``."""
    N, S = z_vals.shape
    pts_t = _points_t(rays_o, rays_d, z_vals)
    vd_t = viewdirs.float().T
    kw = dict(depth=depth, width=width, multires=multires,
              multires_views=multires_views, dtype=dtype, skips=skips)
    if torch.is_grad_enabled() and any(p.requires_grad
                                       for p in params.values()):
        route = "acts"
        raw, logits = FusedSem.run(params, pts_t, vd_t, S, **kw)
    else:
        route = "forward"
        raw, logits = fused_nerf_fwd_sem(params, pts_t, vd_t, S,
                                         packed=packed, **kw)
    fused_nerf_apply_rays_semantic.last_route = route
    return raw.reshape(4, N, S), logits


fused_nerf_apply_rays_semantic.last_route = None


# ------------------------------------------- int8 serving (kernels 10, 11)

_INV127 = 1.0 / 127.0  # multiplied in float32, as JAX's ``* (1.0 / 127.0)``


def quant_cols(w: torch.Tensor):
    """JAX ``_quant_cols``: per-output-column symmetric int8 quantization of
    a ``[K, N]`` weight (already rounded to the compute dtype). ``s =
    max(m, 1e-30) * (1/127)`` from the column max-abs ``m``, then ``q =
    round(w / s)`` (a true division, rounded half to even). Returns (q int8
    ``[K, N]``, s float32 ``[1, N]``)."""
    wf = w.float()
    s = torch.clamp_min(wf.abs().amax(0, keepdim=True), 1e-30) * _INV127
    return torch.round(wf / s).to(torch.int8), s


def qdot_plain(h: torch.Tensor, wq: torch.Tensor,
               srow: torch.Tensor) -> torch.Tensor:
    """JAX ``_qdot``: the W8A8 product of ``h [T, K]`` (values of the compute
    dtype) and ``wq [K, N]`` int8 with column scales ``srow [1, N]``, float32
    ``[T, N]``. Each row is quantized by its own max-abs ``m``: ``r = 127 /
    max(m, 1e-30)`` (a true division), ``q = round(h r)`` half to even, then
    ``acc * ((m * (1/127)) * srow)`` with ``acc`` the exact integer product.
    The product runs as a float32 matrix product, which is exact here: its
    operands are integers of at most 127 in magnitude and every partial sum
    is an integer below ``K * 127^2 < 2^24`` for ``K <= 1040`` (the kernels
    take ``K <= 256``)."""
    q, m = quant_rows(h)
    return (q @ wq.float()) * ((m * _INV127) * srow)


def quant_rows(h: torch.Tensor):
    """:func:`qdot_plain`'s activation quantization of ``h [T, K]``: (the
    int8 values ``round(h r)`` as float32 ``[T, K]``, the row max-abs ``m``
    ``[T, 1]``) with ``r = 127 / max(m, 1e-30)``."""
    hf = h.float()
    m = hf.abs().amax(1, keepdim=True)
    mc = torch.clamp_min(m, 1e-30)
    r = torch.full_like(mc, 127.0) / mc  # not 127.0 / mc: torch takes the reciprocal
    return torch.round(hf * r), m


class PackedQ8(NamedTuple):
    """The int8 serving weights (JAX ``_pack_params_q8``), made by
    :func:`pack_params_q8`."""
    base: PackedParams  # every layer in dtype: the first layer, the skip
    # products, the heads and the view layer's per-ray half are read here
    q: tuple  # int8 [K, N] (Flax layout): trunk_1..trunk_{D-1} (their trunk
    # rows after a live skip), feature, views_0's feature rows
    scales: torch.Tensor  # [pad8(D + 1), W] float32, row j scales q[j]
    wq4: torch.Tensor  # each q as [K/4, N] int32 words of 4 int8 along K
    q_offsets: ctypes.Array  # word offset of each q in ``wq4``


def pack_params_q8(params: Mapping[str, torch.Tensor], depth: int, dtype,
                   device=None, skips=()) -> PackedQ8:
    """JAX ``_pack_params_q8``: the packed weights of :func:`pack_params`
    (with the semantic head, where there is one) plus int8 twins of the
    wide layers, quantized by :func:`quant_cols` from the weights rounded to
    ``dtype``, and their column scales stacked into one float32 matrix
    ``[pad8(D + 1), W]`` (rows 0..D-2 the trunk, D-1 the feature layer, D the
    view layer, zero-padded from W/2)."""
    base = pack_params(params, depth, dtype, device)
    W, e_p = params["trunk_0.weight"].shape
    ls = live_skips(depth, skips)

    def kernel(name):  # [in, out] in dtype
        return params[f"{name}.weight"].detach().t().to(dtype)

    mats = [kernel(f"trunk_{i}")[e_p if (i - 1) in ls else 0:]
            for i in range(1, depth)]
    mats += [kernel("feature"), kernel("views_0")[:W]]
    qs, ss = zip(*(quant_cols(m) for m in mats))
    s_v = torch.nn.functional.pad(ss[-1], (0, W - ss[-1].shape[1]))
    sc = torch.cat(list(ss[:-1]) + [s_v])
    sc = torch.nn.functional.pad(sc, (0, 0, 0, (-sc.shape[0]) % 8))
    words, offs, o = [], [], 0
    for q in qs:
        K, N = q.shape
        words.append(q.reshape(K // 4, 4, N).transpose(1, 2).contiguous()
                     .view(torch.int32).reshape(-1))
        offs.append(o)
        o += words[-1].numel()
    return PackedQ8(base, tuple(q.to(device) for q in qs), sc.to(device),
                    torch.cat(words).to(device), (ctypes.c_int * len(offs))(*offs))


def _forward_q8_plain(params, pts_t, viewdirs_t, S, depth, width, multires,
                      multires_views, dtype, skips, packed: PackedQ8):
    """Kernel 10's arithmetic (JAX ``_forward_tile_q8``): kernel 1's
    forward with :func:`qdot_plain` for trunk layers 1..D-1, the feature
    layer and the view layer's feature half; a trunk layer adds its bias,
    then a live skip's encoding product; the view layer adds the ray's term,
    then its bias. In bfloat16 the first layer's and the skip's encoding
    products are :func:`_tc_mm`'s over the encoding zero-padded to a multiple
    of 16 columns, as the kernel forms them on the tensor cores. Returns raw
    ``[4, P]`` and the feature activation ``[P, W]`` (float32 holding
    ``dtype`` values)."""
    ls = live_skips(depth, skips)
    e_p = 3 + 6 * multires
    q, sc = packed.q, packed.scales

    def rnd(x):
        return x.to(dtype).float()

    def pad(x):  # the encoding's columns up to a multiple of 16, zero
        return torch.nn.functional.pad(x, (0, _pad16(e_p) - e_p))

    def enc_mm(wi):  # enc @ wi.T, wi [W, e_p]
        return _tc_mm(pad(enc), pad(wi)) if dtype == torch.bfloat16 else enc @ wi.T

    w, b = _plain_weights(params, dtype)
    enc, encv = _plain_encodings(pts_t, viewdirs_t, multires, multires_views,
                                 dtype)
    h = rnd(torch.relu(enc_mm(w("trunk_0")) + b("trunk_0")))
    for i in range(1, depth):
        acc = qdot_plain(h, q[i - 1], sc[i - 1:i]) + b(f"trunk_{i}")
        if (i - 1) in ls:
            acc = acc + enc_mm(w(f"trunk_{i}")[:, :e_p])
        h = rnd(torch.relu(acc))
    feat = rnd(qdot_plain(h, q[depth - 1], sc[depth - 1:depth])
               + b("feature"))
    sigma = h @ w("sigma").T + b("sigma")
    hv_ray = rnd(encv @ w("views_0")[:, width:].T)  # [N, W/2], once per ray
    hv = rnd(torch.relu(
        qdot_plain(feat, q[depth], sc[depth:depth + 1, :width // 2])
        + hv_ray.repeat_interleave(S, dim=0) + b("views_0")))
    rgb = hv @ w("rgb").T + b("rgb")
    return torch.cat([rgb, sigma], dim=-1).T.contiguous(), feat


def _q8_packed_for(params, depth, dtype, device, skips, packed, semantic):
    if packed is None:
        packed = pack_params_q8(params, depth, dtype, device, skips)
    if packed.base.dtype != dtype or packed.wq4.device != device:
        raise ValueError(f"packed int8 weights are for {packed.base.dtype} on "
                         f"{packed.wq4.device}, want {dtype} on {device}")
    if semantic and packed.base.sem is None:
        raise ValueError("the packed weights hold no semantic head")
    return packed


def fused_nerf_fwd_q8_plain(params, pts_t, viewdirs_t, S: int, *, depth: int,
                            width: int, multires: int, multires_views: int,
                            dtype=torch.float32, skips=(),
                            packed: PackedQ8 | None = None) -> torch.Tensor:
    """Kernel 10's twin: raw ``[4, P]``."""
    packed = _q8_packed_for(params, depth, dtype, pts_t.device, skips, packed,
                            False)
    return _forward_q8_plain(params, pts_t, viewdirs_t, S, depth, width,
                             multires, multires_views, dtype, skips, packed)[0]


def fused_nerf_fwd_q8_sem_plain(params, pts_t, viewdirs_t, S: int, *,
                                depth: int, width: int, multires: int,
                                multires_views: int, dtype=torch.float32,
                                skips=(), packed: PackedQ8 | None = None):
    """Kernel 11's twin: raw ``[4, P]`` and the ray-summed logits ``[P // S,
    C]`` of the semantic head (:func:`sem_head_plain`, kernel 6's) on the int8
    trunk's feature ``(qdot(h, W_feat) + b_feat)`` rounded to ``dtype``."""
    _check_sem_samples(S)
    packed = _q8_packed_for(params, depth, dtype, pts_t.device, skips, packed,
                            True)
    raw, feat = _forward_q8_plain(params, pts_t, viewdirs_t, S, depth, width,
                                  multires, multires_views, dtype, skips,
                                  packed)
    logits, _ = sem_head_plain(sem_tile_partials_plain(feat, S),
                               packed.base.sem, pts_t.shape[1] // S, S)
    return raw, logits


def _eval_only(params: Mapping[str, torch.Tensor], name: str):
    """The int8 forwards have no backward (JAX defines no VJP): refuse a call
    whose result autograd would have to differentiate."""
    if torch.is_grad_enabled() and any(p.requires_grad
                                       for p in params.values()):
        raise RuntimeError(
            f"{name} is eval only and has no backward: call it under "
            "torch.no_grad() or with parameters that require no gradient")


def _q8_launch(fn, packed: PackedQ8, pts_t, viewdirs_t, S, depth, width,
               multires, multires_views, skips, fpart=None):
    P = pts_t.shape[1]
    out = torch.empty((4, P), dtype=torch.float32, device=pts_t.device)
    base = packed.base
    lib = _build.load(Q8_KERNEL, Q8_ARGTYPES)
    err = lib.fused_nerf_q8_launch(
        pts_t.data_ptr(), viewdirs_t.data_ptr(), base.weights.data_ptr(),
        _tc_ptr(base), base.biases.data_ptr(), packed.wq4.data_ptr(),
        packed.scales.data_ptr(), out.data_ptr(),
        None if fpart is None else fpart.data_ptr(),
        0 if fpart is None else fpart.shape[1], P, S, depth, width, multires,
        multires_views, sum(1 << s for s in live_skips(depth, skips)),
        int(base.dtype == torch.bfloat16), *_offset_ptrs(base),
        ctypes.addressof(packed.q_offsets),
        torch.cuda.current_stream(pts_t.device).cuda_stream)
    _build.check(lib, Q8_KERNEL, err)
    fn.launches += 1
    return out


def fused_nerf_fwd_q8(params: Mapping[str, torch.Tensor], pts_t, viewdirs_t,
                      S: int, *, depth: int, width: int, multires: int,
                      multires_views: int, dtype=torch.float32, skips=(),
                      packed: PackedQ8 | None = None) -> torch.Tensor:
    """Kernel 10: raw ``[4, P]`` of the W8A8 forward for ``pts_t [3, P]``
    and ``viewdirs_t [3, P // S]``. Eval only: raises under autograd.
    ``packed`` is ``pack_params_q8(params, depth, dtype, device, skips)``
    made once by a caller that launches many times with unchanged weights;
    without it every call quantizes the weights anew."""
    _eval_only(params, "fused_nerf_fwd_q8")
    _check(pts_t, viewdirs_t, S, dtype)
    packed = _q8_packed_for(params, depth, dtype, pts_t.device, skips, packed,
                            False)
    if pts_t.device.type == "cpu":
        return _forward_q8_plain(params, pts_t, viewdirs_t, S, depth, width,
                                 multires, multires_views, dtype, skips,
                                 packed)[0]
    return _q8_launch(fused_nerf_fwd_q8, packed, pts_t.float().contiguous(),
                      viewdirs_t.float().contiguous(), S, depth, width,
                      multires, multires_views, skips)


fused_nerf_fwd_q8.launches = 0


def fused_nerf_fwd_q8_sem(params: Mapping[str, torch.Tensor], pts_t,
                          viewdirs_t, S: int, *, depth: int, width: int,
                          multires: int, multires_views: int,
                          dtype=torch.float32, skips=(),
                          packed: PackedQ8 | None = None):
    """Kernel 11: raw ``[4, P]`` and the ray-summed semantic logits ``[P //
    S, C]`` float32: kernel 10's trunk writing kernel 6's per-tile feature
    partial sums, then the semantic head kernel (:func:`sem_head`). Eval
    only."""
    _eval_only(params, "fused_nerf_fwd_q8_sem")
    _check(pts_t, viewdirs_t, S, dtype)
    _check_sem_samples(S)
    packed = _q8_packed_for(params, depth, dtype, pts_t.device, skips, packed,
                            True)
    if pts_t.device.type == "cpu":
        return fused_nerf_fwd_q8_sem_plain(
            params, pts_t, viewdirs_t, S, depth=depth, width=width,
            multires=multires, multires_views=multires_views, dtype=dtype,
            skips=skips, packed=packed)
    P = pts_t.shape[1]
    fpart = torch.empty((-(-P // TILE), sem_tile_slots(S), width),
                        dtype=torch.float32, device=pts_t.device)
    raw = _q8_launch(fused_nerf_fwd_q8_sem, packed, pts_t.float().contiguous(),
                     viewdirs_t.float().contiguous(), S, depth, width,
                     multires, multires_views, skips, fpart=fpart)
    logits, _ = sem_head(fpart, packed.base.sem, P // S, S)
    return raw, logits


fused_nerf_fwd_q8_sem.launches = 0


def _padded_rays(rays_o, rays_d, viewdirs, z_vals):
    """JAX ``_apply_rays_q8_core``'s padding: zero rays up to a whole number
    of JAX forward tiles (:func:`jax_fwd_tile`). The port's kernels mask a
    ragged tile and need none; the padding keeps the launch's points the
    TPU kernel's grid."""
    N, S = z_vals.shape
    n_pad = (-N) % max(1, jax_fwd_tile(S) // S)
    if n_pad:
        rays_o, rays_d, viewdirs, z_vals = (
            torch.nn.functional.pad(x, (0, 0, 0, n_pad))
            for x in (rays_o, rays_d, viewdirs, z_vals))
    return (_points_t(rays_o, rays_d, z_vals), viewdirs.float().T.contiguous(),
            N, S, N + n_pad)


def fused_nerf_apply_rays_q8(params: Mapping[str, torch.Tensor], rays_o,
                             rays_d, viewdirs, z_vals, *, depth: int,
                             width: int, multires: int, multires_views: int,
                             dtype=torch.bfloat16, skips=(),
                             packed: PackedQ8 | None = None) -> torch.Tensor:
    """The W8A8 serving forward (JAX ``fused_nerf_apply_rays_q8``): rays
    ``[N, 3]`` + depths ``z_vals [N, S]`` -> channel-major raw ``[4, N, S]``
    through kernel 10. Eval only: under autograd with a parameter that
    requires a gradient it raises, as JAX defines no VJP. Rays are padded
    to whole JAX forward tiles and sliced back."""
    pts_t, vd_t, N, S, n_full = _padded_rays(rays_o, rays_d, viewdirs, z_vals)
    raw = fused_nerf_fwd_q8(params, pts_t, vd_t, S, depth=depth, width=width,
                            multires=multires, multires_views=multires_views,
                            dtype=dtype, skips=skips, packed=packed)
    return raw.reshape(4, n_full, S)[:, :N]


def fused_nerf_apply_rays_semantic_q8(params: Mapping[str, torch.Tensor],
                                      rays_o, rays_d, viewdirs, z_vals, *,
                                      depth: int, width: int, multires: int,
                                      multires_views: int,
                                      dtype=torch.bfloat16, skips=(),
                                      packed: PackedQ8 | None = None):
    """The W8A8 semantic serving forward (JAX
    ``fused_nerf_apply_rays_semantic_q8``): raw ``[4, N, S]`` and the
    ray-summed logits ``[N, C]`` through kernel 11. Eval only, as
    :func:`fused_nerf_apply_rays_q8`; it saves no activations, so no point
    cap applies."""
    pts_t, vd_t, N, S, n_full = _padded_rays(rays_o, rays_d, viewdirs, z_vals)
    raw, logits = fused_nerf_fwd_q8_sem(
        params, pts_t, vd_t, S, depth=depth, width=width, multires=multires,
        multires_views=multires_views, dtype=dtype, skips=skips,
        packed=packed)
    return raw.reshape(4, n_full, S)[:, :N], logits[:N]
