"""Inverse-CDF sampling through the hand-written CUDA kernel
``csrc/sample_pdf.cu`` (port of ``ops/sampling_pallas.py``).

:func:`sample_pdf_cuda` is a drop-in for :func:`ops.sampling.sample_pdf`: it
makes the draws ``u`` (``linspace`` for ``det``, else ``torch.rand`` from the
caller's generator) and hands them to :func:`inverse_cdf`, so the kernel
itself is deterministic and a test can give both versions the same ``u``.

:func:`inverse_cdf` runs the kernel for CUDA tensors and the plain PyTorch
version :func:`inverse_cdf_plain` for CPU tensors; it never falls back from
one to the other. ``inverse_cdf.launches`` counts kernel launches.

The kernel reads each input where it lies: rows at any stride (the
renderer's ``weights[..., 1:-1]`` slice, the ``expand``ed draws of ``det``
with stride 0), each row unit-stride, float32. :func:`inverse_cdf` refuses
anything else on either device rather than copying it.
"""

from __future__ import annotations

import ctypes

import torch

from depth_lidar_nerf_tpu_torch.ops import _build
from depth_lidar_nerf_tpu_torch.ops.sampling import pdf_uniforms
from depth_lidar_nerf_tpu_torch.utils.tracing import register_launches

KERNEL = "sample_pdf"
# sample_pdf_launch(bins, bins row stride, weights, weights row stride,
#                   u, u row stride, out, N, B, V, stream)
ARGTYPES = [ctypes.c_void_p, ctypes.c_longlong] * 3 + [ctypes.c_void_p] \
    + [ctypes.c_int] * 3 + [ctypes.c_void_p]


def inverse_cdf_plain(bins: torch.Tensor, weights: torch.Tensor,
                      u: torch.Tensor) -> torch.Tensor:
    """The kernel's algorithm in PyTorch: CDF, ``searchsorted(right=True)``,
    clamped gathers, guarded lerp (``run_nerf_helpers.py:497-540``).

    The total and the prefix sum run in the kernel's sequential float32
    order, so that the CDFs agree bit for bit: the reference's inversion is
    discontinuous where the denominator guard meets a draw on a bin edge
    (``u = 1`` against ``cdf[B-1]`` rounded either side of 1.0), and a
    different summation order there moves a sample by a whole bin."""
    bins, u = bins.float(), u.float()
    w = weights.float() + 1e-5
    total = torch.zeros_like(w[:, 0])
    for j in range(w.shape[1]):
        total = total + w[:, j]
    cdf = torch.zeros((w.shape[0], w.shape[1] + 1), dtype=torch.float32,
                      device=w.device)
    for j in range(w.shape[1]):
        cdf[:, j + 1] = cdf[:, j] + w[:, j] / total
    B = cdf.shape[-1]
    i = torch.searchsorted(cdf, u.contiguous(), right=True)
    below = torch.clamp(i - 1, min=0)
    above = torch.clamp(i, max=B - 1)
    c0, c1 = torch.gather(cdf, 1, below), torch.gather(cdf, 1, above)
    b0, b1 = torch.gather(bins, 1, below), torch.gather(bins, 1, above)
    denom = c1 - c0
    denom = torch.where(denom < 1e-5, torch.ones_like(denom), denom)
    return b0 + (u - c0) / denom * (b1 - b0)


def _launch(bins, weights, u):
    N, B = bins.shape
    V = u.shape[1]
    out = torch.empty((N, V), dtype=torch.float32, device=bins.device)
    if N == 0 or V == 0:
        return out
    lib = _build.load(KERNEL, ARGTYPES)
    err = lib.sample_pdf_launch(
        bins.data_ptr(), bins.stride(0), weights.data_ptr(), weights.stride(0),
        u.data_ptr(), u.stride(0), out.data_ptr(), N, B, V,
        torch.cuda.current_stream(bins.device).cuda_stream)
    _build.check(lib, KERNEL, err)
    inverse_cdf.launches += 1
    return out


def inverse_cdf(bins: torch.Tensor, weights: torch.Tensor,
                u: torch.Tensor) -> torch.Tensor:
    """Samples ``[N, V]`` from ``bins [N, B]``, ``weights [N, B-1]`` and
    draws ``u [N, V]``: float32, each row unit-stride, rows at any stride."""
    N, B = bins.shape
    if weights.shape != (N, B - 1) or u.dim() != 2 or u.shape[0] != N:
        raise ValueError(f"bad shapes bins {tuple(bins.shape)} weights "
                         f"{tuple(weights.shape)} u {tuple(u.shape)}")
    devs = {bins.device, weights.device, u.device}
    if len(devs) != 1:
        raise ValueError(f"inputs on several devices: {devs}")
    for name, t in (("bins", bins), ("weights", weights), ("u", u)):
        if t.dtype != torch.float32:
            raise ValueError(f"{name} is {t.dtype}; the kernel takes float32")
        if t.shape[1] > 1 and t.stride(1) != 1:
            raise ValueError(f"{name} has stride {t.stride(1)} along its last "
                             f"dimension; the kernel reads unit-stride rows")
    if bins.device.type == "cpu":
        return inverse_cdf_plain(bins, weights, u)
    if bins.device.type != "cuda":
        raise ValueError(f"unsupported device {bins.device}")
    return _launch(bins, weights, u)


register_launches(KERNEL, inverse_cdf)


def sample_pdf_cuda(bins: torch.Tensor, weights: torch.Tensor, N_samples: int,
                    *, det: bool = False,
                    generator: torch.Generator | None = None) -> torch.Tensor:
    """Drop-in for :func:`ops.sampling.sample_pdf` through the kernel."""
    u = pdf_uniforms(bins.shape[0], N_samples, det=det, generator=generator,
                     device=bins.device)
    return inverse_cdf(bins, weights, u)
