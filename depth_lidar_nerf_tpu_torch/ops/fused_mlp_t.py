"""Fused NeRF MLP forward through the hand-written CUDA kernel
``csrc/fused_nerf_fwd.cu`` (port of the serving forward of ``ops/fused_mlp_t.py``).

The Pallas kernel it replaces, ``fused_mlp_t._fwd_kernel``, evaluates the
whole radiance MLP for a tile of points with the positional encoding computed
in-kernel, the skip concat as a second product on the encoding rows, and the
view layer's per-ray half computed once per ray; it writes channel-major raw
``[4, P]``. The CUDA kernel computes the same function (see its source note
for its bound and design).

:func:`fused_nerf_fwd` launches the kernel for CUDA tensors and runs the plain
PyTorch version :func:`fused_nerf_fwd_plain` for CPU tensors; it never falls
back from one to the other. ``fused_nerf_fwd.launches`` counts kernel launches.

``params`` everywhere is a mapping of the :class:`~models.nerf_mlp.NeRFMLP`
parameter names (``trunk_0.weight`` ``[out, in]``, ``trunk_0.bias``, ...) to
float32 tensors, e.g. ``dict(module.named_parameters())``.
"""

from __future__ import annotations

import ctypes
from typing import Mapping, NamedTuple

import torch

from depth_lidar_nerf_tpu_torch.ops import _build
from depth_lidar_nerf_tpu_torch.ops.embedding import positional_encoding

KERNEL = "fused_nerf_fwd"
# fused_nerf_fwd_launch(pts, vd, w, b, out, P, S, depth, width, multires,
#                       multires_views, skip_mask, bf16, w_off, b_off, stream)
ARGTYPES = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 8 + [ctypes.c_void_p] * 3
_DTYPES = (torch.float32, torch.bfloat16)


def live_skips(depth: int, skips) -> tuple:
    """Skip layers whose concat feeds a TRUNK layer (reference
    run_nerf_helpers.py:101-105: a skip after layer s is live iff
    s < depth - 1; netdepth=4 with skips=(4,) has none)."""
    return tuple(sorted(s for s in (skips or ()) if 0 <= s < depth - 1))


def supports_rays(params: Mapping[str, torch.Tensor], use_viewdirs: bool,
                  num_semantic: int, depth: int, width: int, multires: int,
                  multires_views: int, skips=()) -> bool:
    """Whether the kernel covers this model: the predicate of the JAX
    ``fused_mlp_t.supports_rays``. Depth 1-8, width 128 or 256, view
    directions on, no semantic head, no skip at the last trunk layer, and
    encodings of at most 128 rows together (which also bounds the kernel's
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


def _layer_names(depth: int):
    return [f"trunk_{i}" for i in range(depth)] + ["sigma", "feature",
                                                   "views_0", "rgb"]


class PackedParams(NamedTuple):
    """The weights in the kernel's layout, made by :func:`pack_params`."""
    weights: torch.Tensor  # every layer's [in, out], row-major, in dtype
    biases: torch.Tensor  # every bias, float32
    w_offsets: ctypes.Array  # element offset of each layer in ``weights``
    b_offsets: ctypes.Array  # and in ``biases``
    dtype: torch.dtype


def pack_params(params: Mapping[str, torch.Tensor], depth: int, dtype,
                device=None) -> PackedParams:
    """One buffer of every weight as ``[in, out]`` row-major in ``dtype``
    (the Flax kernel layout: a skip layer's encoding rows come first), one
    float32 buffer of every bias, and the element offset of each layer in
    both, in the order trunk_0..trunk_{D-1}, sigma, feature, views_0, rgb."""
    names = _layer_names(depth)
    ws = [params[f"{n}.weight"].detach().t().to(dtype).reshape(-1) for n in names]
    bs = [params[f"{n}.bias"].detach().float().reshape(-1) for n in names]

    def offsets(parts):
        out, o = [], 0
        for t in parts:
            out.append(o)
            o += t.numel()
        return (ctypes.c_int * len(out))(*out)

    return PackedParams(torch.cat(ws).to(device), torch.cat(bs).to(device),
                        offsets(ws), offsets(bs), dtype)


def fused_nerf_fwd_plain(params: Mapping[str, torch.Tensor], pts_t: torch.Tensor,
                         viewdirs_t: torch.Tensor, S: int, *, depth: int,
                         width: int, multires: int, multires_views: int,
                         dtype=torch.float32, skips=()) -> torch.Tensor:
    """The kernel's arithmetic in PyTorch: operands rounded to ``dtype``,
    products in float32, each activation rounded to ``dtype``.
    ``pts_t [3, P]``, ``viewdirs_t [3, P // S]`` -> raw ``[4, P]``."""
    ls = live_skips(depth, skips)
    e_p = 3 + 6 * multires

    def rnd(x):
        return x.to(dtype).float()

    def w(name):
        return rnd(params[f"{name}.weight"].detach().float())

    def b(name):
        return params[f"{name}.bias"].detach().float()

    enc = rnd(positional_encoding(pts_t.float().T, multires))  # [P, e_p]
    h = enc
    for i in range(depth):
        wi = w(f"trunk_{i}")
        if i == 0:
            acc = enc @ wi.T
        elif (i - 1) in ls:
            acc = enc @ wi[:, :e_p].T + h @ wi[:, e_p:].T
        else:
            acc = h @ wi.T
        h = rnd(torch.relu(acc + b(f"trunk_{i}")))
    sigma = h @ w("sigma").T + b("sigma")  # [P, 1]
    feat = rnd(h @ w("feature").T + b("feature"))
    wv = w("views_0")
    encv = rnd(positional_encoding(viewdirs_t.float().T, multires_views))
    hv_ray = rnd(encv @ wv[:, width:].T)  # [N, W/2], once per ray
    hv = rnd(torch.relu(feat @ wv[:, :width].T
                        + hv_ray.repeat_interleave(S, dim=0) + b("views_0")))
    rgb = hv @ w("rgb").T + b("rgb")
    return torch.cat([rgb, sigma], dim=-1).T.contiguous()


def _launch(packed: PackedParams, pts_t, viewdirs_t, S, depth, width,
            multires, multires_views, skips):
    P = pts_t.shape[1]
    out = torch.empty((4, P), dtype=torch.float32, device=pts_t.device)
    skip_mask = sum(1 << s for s in live_skips(depth, skips))
    lib = _build.load(KERNEL, ARGTYPES)
    err = lib.fused_nerf_fwd_launch(
        pts_t.data_ptr(), viewdirs_t.data_ptr(), packed.weights.data_ptr(),
        packed.biases.data_ptr(), out.data_ptr(), P, S, depth, width,
        multires, multires_views, skip_mask,
        int(packed.dtype == torch.bfloat16),
        ctypes.addressof(packed.w_offsets), ctypes.addressof(packed.b_offsets),
        torch.cuda.current_stream(pts_t.device).cuda_stream)
    _build.check(lib, KERNEL, err)
    fused_nerf_fwd.launches += 1
    return out


def fused_nerf_fwd(params: Mapping[str, torch.Tensor], pts_t: torch.Tensor,
                   viewdirs_t: torch.Tensor, S: int, *, depth: int, width: int,
                   multires: int, multires_views: int, dtype=torch.float32,
                   skips=(), packed: PackedParams | None = None) -> torch.Tensor:
    """Raw ``[4, P]`` for points ``pts_t [3, P]`` (point p on ray p // S)
    and unit view directions ``viewdirs_t [3, P // S]``, float32.

    ``packed`` is ``pack_params(params, depth, dtype)`` made once by a caller
    that launches many times with unchanged weights; without it every launch
    packs the weights anew."""
    if dtype not in _DTYPES:
        raise ValueError(f"dtype must be one of {_DTYPES}, got {dtype}")
    P = pts_t.shape[1]
    if pts_t.shape[0] != 3 or viewdirs_t.shape[0] != 3 or S < 1 or P % S \
            or viewdirs_t.shape[1] != P // S:
        raise ValueError(f"bad shapes pts {tuple(pts_t.shape)} viewdirs "
                         f"{tuple(viewdirs_t.shape)} S={S}")
    if torch.is_grad_enabled() and any(p.requires_grad
                                       for p in params.values()):
        # The kernel returns no graph; without this check a caller would
        # train on silently zero gradients.
        raise RuntimeError("fused_nerf_fwd has no backward yet: call it "
                           "under torch.no_grad()")
    kw = dict(depth=depth, width=width, multires=multires,
              multires_views=multires_views, dtype=dtype, skips=skips)
    if pts_t.device.type == "cpu":
        return fused_nerf_fwd_plain(params, pts_t, viewdirs_t, S, **kw)
    if pts_t.device.type != "cuda" or viewdirs_t.device != pts_t.device:
        raise ValueError(f"unsupported devices {pts_t.device}, "
                         f"{viewdirs_t.device}")
    if packed is None:
        packed = pack_params(params, depth, dtype, pts_t.device)
    if packed.dtype != dtype or packed.weights.device != pts_t.device:
        raise ValueError(f"packed weights are {packed.dtype} on "
                         f"{packed.weights.device}, want {dtype} on "
                         f"{pts_t.device}")
    return _launch(packed, pts_t.float().contiguous(),
                   viewdirs_t.float().contiguous(), S, depth, width, multires,
                   multires_views, skips)


fused_nerf_fwd.launches = 0


def fused_nerf_apply_rays(params: Mapping[str, torch.Tensor], rays_o, rays_d,
                          viewdirs, z_vals, *, depth: int, width: int,
                          multires: int, multires_views: int,
                          dtype=torch.bfloat16, skips=(),
                          packed: PackedParams | None = None) -> torch.Tensor:
    """Rays ``[N, 3]`` + depths ``z_vals [N, S]`` -> channel-major raw
    ``[4, N, S]`` (rgb 0-2, sigma 3), as the JAX ``fused_nerf_apply_rays``.

    Points are formed transposed, ``o + d z`` as ``[3, N, S]``; ``viewdirs``
    are the unit pre-NDC directions, one per ray. ``packed`` is as for
    :func:`fused_nerf_fwd`.
    """
    N, S = z_vals.shape
    ot = rays_o.float().T[:, :, None]
    dt = rays_d.float().T[:, :, None]
    pts_t = (ot + dt * z_vals.float()[None]).reshape(3, N * S)
    raw = fused_nerf_fwd(params, pts_t, viewdirs.float().T, S, depth=depth,
                         width=width, multires=multires,
                         multires_views=multires_views, dtype=dtype,
                         skips=skips, packed=packed)
    return raw.reshape(4, N, S)
