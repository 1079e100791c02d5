"""Device-resident ray tables (port of ``train/tables.py``).

Every training ray is computed once and kept on the device; each step
gathers its batch by index, so the step moves no data from the host. Rays
are stored post-NDC with their unit pre-NDC view directions.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from depth_lidar_nerf_tpu_torch.device import resolve_device
from depth_lidar_nerf_tpu_torch.ops.rays import (camera_rays, ndc_rays,
                                                 rays_by_coord)
from depth_lidar_nerf_tpu_torch.render.renderer import RenderConfig, Rays


class RgbRayTable(NamedTuple):
    origins: torch.Tensor  # [M, 3]
    directions: torch.Tensor  # [M, 3]
    viewdirs: torch.Tensor  # [M, 3]
    rgb: torch.Tensor  # [M, 3]
    semantic: Optional[torch.Tensor]  # [M] int32 or None


class DepthRayTable(NamedTuple):
    origins: torch.Tensor
    directions: torch.Tensor
    viewdirs: torch.Tensor
    depth: torch.Tensor  # [M]
    weight: torch.Tensor  # [M]


def _finalize(rays_o, rays_d, cfg: RenderConfig, H, W, focal):
    rays_o = rays_o.reshape(-1, 3).astype(np.float32)
    rays_d = rays_d.reshape(-1, 3).astype(np.float32)
    viewdirs = rays_d / np.linalg.norm(rays_d, axis=-1, keepdims=True)
    if cfg.ndc:
        o, d = ndc_rays(H, W, focal, 1.0, torch.from_numpy(rays_o),
                        torch.from_numpy(rays_d))
        rays_o, rays_d = o.numpy(), d.numpy()
    return rays_o, rays_d, viewdirs.astype(np.float32)


def _rays_np(fn, *args):
    o, d = fn(*args)
    return o.numpy(), d.numpy()


def build_rgb_table(images: np.ndarray, poses: np.ndarray, i_train, H: int,
                    W: int, focal: float, cfg: RenderConfig,
                    segmentation: Optional[np.ndarray] = None,
                    device=None) -> RgbRayTable:
    """Every pixel ray of the training images ``images [N, H, W, 3]`` under
    camera-to-world ``poses [N, 3, 4]``, on ``device`` (``cuda`` unless
    given). The rays are made on the CPU, as the JAX package makes them on
    the host."""
    device = resolve_device(device)
    all_o, all_d, all_v, all_rgb, all_sem = [], [], [], [], []
    for i in i_train:
        ro, rd = _rays_np(camera_rays, H, W, focal,
                          torch.as_tensor(np.asarray(poses[i]),
                                          dtype=torch.float32))
        o, d, v = _finalize(ro, rd, cfg, H, W, focal)
        all_o.append(o)
        all_d.append(d)
        all_v.append(v)
        all_rgb.append(images[i].reshape(-1, 3).astype(np.float32))
        if segmentation is not None:
            all_sem.append(segmentation[i].reshape(-1).astype(np.int32))

    def dev(parts):
        return torch.from_numpy(np.concatenate(parts)).to(device)

    return RgbRayTable(dev(all_o), dev(all_d), dev(all_v), dev(all_rgb),
                       dev(all_sem) if segmentation is not None else None)


def build_depth_table(depth_gts, poses: np.ndarray, i_train, H: int, W: int,
                      focal: float, cfg: RenderConfig,
                      device=None) -> DepthRayTable:
    """Depth-supervised rays through the LiDAR pixel coordinates
    (``run_nerf.py:1167-1187``); ``depth_gts[i]`` holds ``depth``,
    ``coord`` (x, y) and ``weight`` for image i."""
    device = resolve_device(device)
    all_o, all_d, all_v, all_z, all_w = [], [], [], [], []
    for i in i_train:
        coords = torch.from_numpy(np.asarray(depth_gts[i]["coord"],
                                             np.float32))
        ro, rd = _rays_np(rays_by_coord, H, W, focal,
                          torch.as_tensor(np.asarray(poses[i]),
                                          dtype=torch.float32), coords)
        o, d, v = _finalize(ro, rd, cfg, H, W, focal)
        all_o.append(o)
        all_d.append(d)
        all_v.append(v)
        all_z.append(np.asarray(depth_gts[i]["depth"], np.float32).reshape(-1))
        all_w.append(np.asarray(depth_gts[i]["weight"],
                                np.float32).reshape(-1))

    def dev(parts):
        return torch.from_numpy(np.concatenate(parts)).to(device)

    return DepthRayTable(dev(all_o), dev(all_d), dev(all_v), dev(all_z),
                         dev(all_w))


def gather_rays(table, idx: torch.Tensor, cfg: RenderConfig) -> Rays:
    """Index a table into a renderer :class:`Rays` batch."""
    n = idx.shape[0]
    dev = table.origins.device
    near = torch.full((n, 1), cfg.near, dtype=torch.float32, device=dev)
    far = torch.full((n, 1), cfg.far, dtype=torch.float32, device=dev)
    viewdirs = table.viewdirs[idx] if cfg.use_viewdirs else None
    return Rays(table.origins[idx], table.directions[idx], viewdirs, near,
                far)
