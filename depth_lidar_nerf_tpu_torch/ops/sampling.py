"""Along-ray sampling: stratified coarse z values and inverse-CDF resampling
(port of ``ops/sampling.py``).

``sample_pdf`` here is the plain PyTorch formulation the JAX package also
uses: a dense compare over the bin axis in place of a binary search. The
hand-written CUDA kernel for the same function, and its own plain twin, live
in :mod:`depth_lidar_nerf_tpu_torch.ops.sampling_cuda`.

Randomness comes from an explicit ``torch.Generator``; JAX's threefry
streams are never reproduced, so parity tests run with ``det=True`` or hand
the same uniforms to both sides (:func:`sample_pdf_from_u`).
"""

from __future__ import annotations

import torch


def stratified_z_vals(near: torch.Tensor, far: torch.Tensor, N_samples: int,
                      *, lindisp: bool = False, perturb: bool = True,
                      generator: torch.Generator | None = None) -> torch.Tensor:
    """Coarse sample depths ``[N_rays, N_samples]`` from ``near``/``far``
    ``[N_rays, 1]``; with ``perturb``, stratified jitter inside the bin
    midpoints (``run_nerf.py:571-593``)."""
    t_vals = torch.linspace(0.0, 1.0, N_samples, dtype=torch.float32,
                            device=near.device)
    if not lindisp:
        z_vals = near * (1.0 - t_vals) + far * t_vals
    else:
        z_vals = 1.0 / (1.0 / near * (1.0 - t_vals) + 1.0 / far * t_vals)
    z_vals = z_vals.expand(near.shape[:-1] + (N_samples,))

    if perturb:
        if generator is None:
            raise ValueError("perturb=True requires a generator")
        mids = 0.5 * (z_vals[..., 1:] + z_vals[..., :-1])
        upper = torch.cat([mids, z_vals[..., -1:]], dim=-1)
        lower = torch.cat([z_vals[..., :1], mids], dim=-1)
        t_rand = torch.rand(z_vals.shape, dtype=z_vals.dtype,
                            device=z_vals.device, generator=generator)
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
    ``linspace(0, 1)`` for ``det``, else uniform from ``generator``."""
    if det:
        return torch.linspace(0.0, 1.0, N_samples, dtype=torch.float32,
                              device=device).expand(n_rays, N_samples)
    if generator is None:
        raise ValueError("det=False requires a generator")
    return torch.rand((n_rays, N_samples), dtype=torch.float32, device=device,
                      generator=generator)


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
