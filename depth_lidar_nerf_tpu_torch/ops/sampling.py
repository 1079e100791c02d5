"""Along-ray sampling: stratified coarse z values and inverse-CDF resampling
(port of ``ops/sampling.py``).

``sample_pdf`` here is the plain PyTorch formulation the JAX package also
uses: a dense compare over the bin axis in place of a binary search. The
hand-written CUDA kernel for the same function, and its own plain twin, live
in :mod:`depth_lidar_nerf_tpu_torch.ops.sampling_cuda`.

Randomness comes from an explicit ``torch.Generator``; JAX's threefry
streams are never reproduced, so parity tests run with ``det=True`` or hand
the same uniforms to both sides (:func:`sample_pdf_from_u`). Where a caller
renders only some rows of a batch (a rank of a data-parallel step), it
passes a :class:`RowRange` in the generator's place, and every per-ray draw
is drawn for the whole batch and sliced (:func:`draw_rows`).
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch


class RowRange(NamedTuple):
    """Rows ``lo:hi`` of an ``n``-row batch with the batch's generator
    (possibly None). Passed where a render takes its generator, it makes
    every per-ray draw (jitter, sigma noise, importance uniforms) draw all
    ``n`` rows from ``generator`` and keep ``lo:hi``: the shards of a batch
    then read the stream that one process reads for the whole batch, and
    at ``lo, hi, n = 0, n, n`` nothing changes, bit for bit."""

    generator: Optional[torch.Generator]
    lo: int
    hi: int
    n: int


def base_generator(generator) -> Optional[torch.Generator]:
    """The ``torch.Generator`` behind ``generator`` (a generator, a
    :class:`RowRange` or None)."""
    return generator.generator if isinstance(generator, RowRange) else generator


def batch_rows(generator, n_local: int) -> int:
    """The rows of the batch that ``n_local`` rows belong to: the
    :class:`RowRange`'s ``n``, else ``n_local``."""
    return generator.n if isinstance(generator, RowRange) else n_local


def draw_rows(shape, generator, *, normal: bool = False,
              dtype=torch.float32, device=None) -> torch.Tensor:
    """``torch.rand`` (``torch.randn`` with ``normal``) of ``shape``, whose
    dim 0 is rays, from ``generator``; through a :class:`RowRange` drawn for
    its ``n`` rows and sliced to ``lo:hi``."""
    fn = torch.randn if normal else torch.rand
    shape = tuple(shape)
    if not isinstance(generator, RowRange):
        return fn(shape, dtype=dtype, device=device, generator=generator)
    if shape[0] != generator.hi - generator.lo:
        raise ValueError(f"{shape[0]} rows drawn for the range "
                         f"{generator.lo}:{generator.hi}")
    full = fn((generator.n,) + shape[1:], dtype=dtype, device=device,
              generator=generator.generator)
    return full[generator.lo:generator.hi]


def unit_linspace(n: int, device=None) -> torch.Tensor:
    """``jnp.linspace(0, 1, n, float32)`` bit for bit: entry ``i`` is
    ``i * float32(1 / (n - 1))`` (XLA folds JAX's ``iota / (n - 1)`` into
    that product) and the last entry is 1. ``torch.linspace`` rounds
    otherwise in the last bit of some entries (30 of 64 at ``n = 64``)."""
    t = torch.arange(n, dtype=torch.float32, device=device)
    if n > 1:
        # Python scalars (the factor is rounded to float32 for the product)
        # and ``fill_``: a tensor made from a host value, or an item set
        # from one, is copied to the card from pageable memory, and such a
        # copy waits for the work queued before it.
        t = t * (1.0 / (n - 1))
        t[-1:].fill_(1.0)
    return t


def _mul_add(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """``a * b + c``. On the CPU rounded once, as a fused multiply-add (the
    float32 product is exact in float64): XLA's CPU code fuses it so, and
    there the port is held to the JAX package bit for bit. On the card the
    product and the sum are rounded apart, as the formula reads."""
    if a.device.type == "cpu":
        return (a.double() * b.double() + c.double()).float()
    return a * b + c


def stratified_z_vals(near: torch.Tensor, far: torch.Tensor, N_samples: int,
                      *, lindisp: bool = False, perturb: bool = True,
                      generator: torch.Generator | None = None) -> torch.Tensor:
    """Coarse sample depths ``[N_rays, N_samples]`` from ``near``/``far``
    ``[N_rays, 1]``; with ``perturb``, stratified jitter inside the bin
    midpoints (``run_nerf.py:571-593``).

    The JAX package runs this under ``jit``, where XLA's CPU code fuses
    ``near (1 - t) + far t`` into ``fma(far, t, near (1 - t))``; on the
    CPU the port does too (:func:`_mul_add`), and its depths equal JAX's
    bit for bit."""
    t_vals = unit_linspace(N_samples, near.device)
    if not lindisp:
        z_vals = _mul_add(far, t_vals, near * (1.0 - t_vals))
    else:
        z_vals = 1.0 / _mul_add(1.0 / far, t_vals, 1.0 / near * (1.0 - t_vals))
    z_vals = z_vals.expand(near.shape[:-1] + (N_samples,))

    if perturb:
        if base_generator(generator) is None:
            raise ValueError("perturb=True requires a generator")
        mids = 0.5 * (z_vals[..., 1:] + z_vals[..., :-1])
        upper = torch.cat([mids, z_vals[..., -1:]], dim=-1)
        lower = torch.cat([z_vals[..., :1], mids], dim=-1)
        t_rand = draw_rows(z_vals.shape, generator, dtype=z_vals.dtype,
                           device=z_vals.device)
        z_vals = lower + (upper - lower) * t_rand
    return z_vals


def searchsorted_right(sorted_seq: torch.Tensor, values: torch.Tensor) -> torch.Tensor:
    """Row-wise ``searchsorted(..., side='right')``:
    ``out[b, i] = #{j : sorted_seq[b, j] <= values[b, i]}`` (int32)."""
    return (values[..., :, None] >= sorted_seq[..., None, :]).sum(
        -1, dtype=torch.int32)


def pdf_uniforms(n_rays: int, N_samples: int, *, det: bool,
                 generator: torch.Generator | None, device) -> torch.Tensor:
    """The ``[n_rays, N_samples]`` draws ``u`` that invert the CDF:
    :func:`unit_linspace` for ``det``, else uniform from ``generator``."""
    if det:
        return unit_linspace(N_samples, device).expand(n_rays, N_samples)
    if base_generator(generator) is None:
        raise ValueError("det=False requires a generator")
    return draw_rows((n_rays, N_samples), generator, device=device)


def sample_pdf_from_u(bins: torch.Tensor, weights: torch.Tensor,
                      u: torch.Tensor) -> torch.Tensor:
    """Invert the CDF of ``weights [N, B-1]`` over ``bins [N, B]`` at ``u [N, V]``.

    Semantics of the reference ``sample_pdf`` (``run_nerf_helpers.py:497-540``):
    +1e-5 weight floor, zero-prepended CDF, below/above clamped to
    ``[0, B-1]``, guarded linear interpolation. Because cdf and bins are both
    monotone along the bin axis, the gathers at ``below``/``above`` equal
    masked max/min reductions (the JAX package's formulation).
    """
    weights = weights + 1e-5
    pdf = weights / weights.sum(-1, keepdim=True)
    cdf = torch.cumsum(pdf, dim=-1)
    cdf = torch.cat([torch.zeros_like(cdf[..., :1]), cdf], dim=-1)  # [N, B]

    mask = u[..., :, None] >= cdf[..., None, :]  # [N, V, B]
    neg = torch.tensor(-float("inf"), dtype=cdf.dtype, device=cdf.device)
    pos = torch.tensor(float("inf"), dtype=cdf.dtype, device=cdf.device)
    cdf_b = cdf[..., None, :].expand(mask.shape)
    bins_b = bins[..., None, :].expand(mask.shape)
    cdf_below = torch.where(mask, cdf_b, neg).amax(-1)
    bins_below = torch.where(mask, bins_b, neg).amax(-1)
    cdf_above = torch.where(mask, pos, cdf_b).amin(-1)
    bins_above = torch.where(mask, pos, bins_b).amin(-1)
    cdf_above = torch.where(torch.isinf(cdf_above), cdf[..., -1:], cdf_above)
    bins_above = torch.where(torch.isinf(bins_above), bins[..., -1:], bins_above)

    denom = cdf_above - cdf_below
    denom = torch.where(denom < 1e-5, torch.ones_like(denom), denom)
    t = (u - cdf_below) / denom
    return bins_below + t * (bins_above - bins_below)


def sample_pdf(bins: torch.Tensor, weights: torch.Tensor, N_samples: int, *,
               det: bool = False,
               generator: torch.Generator | None = None) -> torch.Tensor:
    """Inverse-CDF importance sampling of ``N_samples`` new depths per ray.

    ``bins [N, B]`` are z midpoints, ``weights [N, B-1]`` the coarse
    compositing weights of the interior samples.
    """
    u = pdf_uniforms(bins.shape[0], N_samples, det=det, generator=generator,
                     device=bins.device)
    return sample_pdf_from_u(bins.float(), weights.float(), u)
