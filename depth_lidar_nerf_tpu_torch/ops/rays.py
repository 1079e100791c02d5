"""Ray generation: pinhole camera rays, per-coordinate rays, NDC warp
(port of ``ops/rays.py``).

Camera convention follows the reference's (modified-LLFF) pinhole model
(``run_nerf_helpers.py:266-337``): image-plane direction
``[(i - W/2)/f, -(j - H/2)/f, -1]`` rotated by ``c2w[:3, :3]``, origin at
``c2w[:3, 3]``.

The rotation is written as an elementwise product and a sum over three
terms, not a matrix product, so it is full float32 on every device: no
TF32 setting can round it (the JAX package asks for ``Precision.HIGHEST``
for the same reason).
"""

from __future__ import annotations

import torch


def _rotate(dirs: torch.Tensor, c2w: torch.Tensor) -> torch.Tensor:
    """``dirs[..., c] -> sum_c dirs[..., c] * R[r, c]`` in plain float32."""
    return (dirs[..., None, :] * c2w[:3, :3]).sum(-1)


def camera_rays(H: int, W: int, focal, c2w: torch.Tensor):
    """Full-image pinhole rays: ``rays_o, rays_d`` of shape ``[H, W, 3]``.

    Parity: ``get_rays`` (``run_nerf_helpers.py:266-300``).
    """
    c2w = c2w.to(torch.float32)
    i, j = torch.meshgrid(
        torch.arange(W, dtype=torch.float32, device=c2w.device),
        torch.arange(H, dtype=torch.float32, device=c2w.device),
        indexing="xy")
    dirs = torch.stack(
        [(i - W * 0.5) / focal, -(j - H * 0.5) / focal, -torch.ones_like(i)],
        dim=-1)
    rays_d = _rotate(dirs, c2w)
    rays_o = c2w[:3, -1].expand(rays_d.shape)
    return rays_o, rays_d


def rays_by_coord(H: int, W: int, focal, c2w: torch.Tensor,
                  coords: torch.Tensor):
    """Rays through pixel coordinates ``coords[..., 2]`` = (x/column, y/row).

    Parity: ``get_rays_by_coord_np`` (``run_nerf_helpers.py:303-318``).
    """
    c2w = c2w.to(torch.float32)
    u = (coords[..., 0] - W * 0.5) / focal
    v = -(coords[..., 1] - H * 0.5) / focal
    dirs = torch.stack([u, v, -torch.ones_like(u)], dim=-1)
    rays_d = _rotate(dirs, c2w)
    rays_o = c2w[:3, -1].expand(rays_d.shape)
    return rays_o, rays_d


def ndc_rays(H: int, W: int, focal, near, rays_o, rays_d):
    """Warp rays to normalized device coordinates (forward-facing scenes).

    Parity: ``ndc_rays`` (``run_nerf_helpers.py:320-337``).
    """
    t = -(near + rays_o[..., 2]) / rays_d[..., 2]
    rays_o = rays_o + t[..., None] * rays_d

    ox, oy, oz = rays_o[..., 0], rays_o[..., 1], rays_o[..., 2]
    dx, dy, dz = rays_d[..., 0], rays_d[..., 1], rays_d[..., 2]

    o0 = -1.0 / (W / (2.0 * focal)) * ox / oz
    o1 = -1.0 / (H / (2.0 * focal)) * oy / oz
    o2 = 1.0 + 2.0 * near / oz

    d0 = -1.0 / (W / (2.0 * focal)) * (dx / dz - ox / oz)
    d1 = -1.0 / (H / (2.0 * focal)) * (dy / dz - oy / oz)
    d2 = -2.0 * near / oz

    return torch.stack([o0, o1, o2], dim=-1), torch.stack([d0, d1, d2], dim=-1)
