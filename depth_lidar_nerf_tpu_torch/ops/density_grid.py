"""Baked density grid: serving's replacement for the coarse MLP pass (port
of ``ops/density_grid.py``).

The fine model's raw sigma is evaluated once on a regular ``R^3`` grid over
the rendered frustum; grid-served renders then place their fine samples
from a trilinear lookup of that grid instead of a coarse MLP pass. The fine
pass, the image itself, still runs the full MLP. The grid stores raw
(pre-ReLU, noise-free) sigma, so the compositor applies unchanged.
"""

from __future__ import annotations

import numpy as np
import torch

from depth_lidar_nerf_tpu_torch.ops.embedding import positional_encoding
from depth_lidar_nerf_tpu_torch.ops.sampling import unit_linspace


def frustum_bounds(rays_o, rays_d, near: float, far: float,
                   margin: float = 0.05):
    """Axis-aligned bounds of ``o + d z`` over z in {near, far} for every
    given ray, padded by ``margin`` of the extent on each side: host numpy
    in float64, returned as float32 ``(lo [3], hi [3])``."""
    o = np.asarray(rays_o, np.float64).reshape(-1, 3)
    d = np.asarray(rays_d, np.float64).reshape(-1, 3)
    pts = np.concatenate([o + d * near, o + d * far], axis=0)
    lo, hi = pts.min(axis=0), pts.max(axis=0)
    pad = (hi - lo) * margin + 1e-6
    return (lo - pad).astype(np.float32), (hi + pad).astype(np.float32)


@torch.no_grad()
def bake_density_grid(model, cfg, lo, hi, resolution: int, device=None,
                      chunk: int = 1 << 18, mesh=None):
    """The model's raw sigma on an ``R^3`` grid over ``[lo, hi]`` (axes in
    ``meshgrid(indexing="ij")`` order), through the plain module's forward
    in chunks of ``chunk`` points: the positional encoding cast to the
    model's dtype and a zero view embedding (sigma is computed before the
    view conditioning, so its value is exact). ``device`` defaults to the
    model's. Returns ``(grid [R, R, R] float32, lo [3], hi [3])``, the
    ``density_grid`` argument of the renderer.

    Each axis is ``lo (1 - t) + hi t`` on :func:`unit_linspace`, the formula
    of ``jnp.linspace``; XLA compiles JAX's into a reassociated product and
    a fused multiply-add, so the axes agree with JAX's within one float32
    ulp, not bit for bit.

    With a ``mesh`` each rank bakes its share of the chunks
    (``parallel.mesh.ray_range``) and the ranks gather them: each chunk is
    evaluated as one process evaluates it, so the grid equals one
    process's."""
    from depth_lidar_nerf_tpu_torch.parallel.gather import gather_rays
    from depth_lidar_nerf_tpu_torch.parallel.mesh import ray_range

    if device is None:
        device = next(model.parameters()).device
    R = int(resolution)
    lo = torch.as_tensor(np.asarray(lo, np.float32), device=device)
    hi = torch.as_tensor(np.asarray(hi, np.float32), device=device)
    t = unit_linspace(R, device)
    axes = [lo[i] * (1.0 - t) + hi[i] * t for i in range(3)]
    pts = torch.stack(torch.meshgrid(*axes, indexing="ij"),
                      dim=-1).reshape(-1, 3)
    dtype = getattr(model, "dtype", torch.float32)
    n_views = 3 + 6 * cfg.multires_views
    p_lo, p_hi = ray_range(pts.shape[0], mesh, chunk)
    sigma = [torch.empty((0,), dtype=torch.float32, device=device)]
    for s in range(p_lo, p_hi, chunk):
        x = pts[s:min(s + chunk, p_hi)]
        pe = positional_encoding(x, cfg.multires).to(dtype)
        ve = torch.zeros((x.shape[0], n_views), dtype=dtype, device=device)
        sigma.append(model(pe, ve)[..., 3].float())
    sigma = torch.cat(sigma)
    if mesh is not None:
        sigma = gather_rays(sigma, pts.shape[0], mesh, chunk)
    return sigma.reshape(R, R, R), lo, hi


def trilinear_sigma(grid, lo, hi, pts):
    """Trilinear interpolation of ``grid [R, R, R]`` at world points
    ``pts [..., 3]``; points out of bounds clamp to the boundary voxels."""
    R = grid.shape[0]
    u = (pts - lo) / (hi - lo) * (R - 1)  # [..., 3] voxel coordinates
    i0 = torch.clamp(torch.floor(u), 0, R - 2).to(torch.int64)
    f = torch.clamp(u - i0, 0.0, 1.0)

    flat = grid.reshape(-1)
    base = (i0[..., 0] * R + i0[..., 1]) * R + i0[..., 2]

    def corner(dx, dy, dz):
        return flat[base + (dx * R + dy) * R + dz]

    fx, fy, fz = f[..., 0], f[..., 1], f[..., 2]
    c00 = corner(0, 0, 0) * (1 - fz) + corner(0, 0, 1) * fz
    c01 = corner(0, 1, 0) * (1 - fz) + corner(0, 1, 1) * fz
    c10 = corner(1, 0, 0) * (1 - fz) + corner(1, 0, 1) * fz
    c11 = corner(1, 1, 0) * (1 - fz) + corner(1, 1, 1) * fz
    c0 = c00 * (1 - fy) + c01 * fy
    c1 = c10 * (1 - fy) + c11 * fy
    return c0 * (1 - fx) + c1 * fx
