"""Depth-supervision loaders: LiDAR ``depth_gt.npy`` and COLMAP sparse points
(the port's copy of ``depth_lidar_nerf_tpu/data/depth.py``).

Parity targets:

- ``load_lidar_depth`` (``load_llff.py:461-552``): per-image list of
  ``{depth, coord, weight}``; pixel coords rescaled by the downsample factor,
  metric depth rescaled by ``sc = 1/(bds.min() * bd_factor)`` then mapped to
  NDC z via ``d <- 1 - 1/d`` (``load_llff.py:521``, report §4.1).
- ``load_colmap_depth`` (``load_llff.py:359-406``): reproject COLMAP points3D
  per view, filter by bounds, weight ``2 exp(-(err/err_mean)^2)``.
"""

from __future__ import annotations

import os
from pathlib import Path

import numpy as np

from depth_lidar_nerf_tpu_torch.data.llff import load_poses_bounds


def load_lidar_depth(basedir: str, factor: int | None = None,
                     bd_factor: float = 0.75, ndc_depth: bool = True):
    """Load LiDAR ray-termination depth annotations.

    Returns a list (one entry per image) of dicts with keys ``depth``
    (float32, NDC if ``ndc_depth``), ``coord`` (float32 [M, 2] pixel (x, y) at
    working resolution) and ``weight`` (float32).
    """
    data_list = np.load(os.path.join(basedir, "depth_gt.npy"), allow_pickle=True)
    _, bds = load_poses_bounds(basedir, factor)
    sc = 1.0 if bd_factor is None else 1.0 / (bds.min() * bd_factor)
    scale_coord = factor if factor else 1

    out = []
    for data in data_list:
        depth = np.asarray(data["depth"], np.float64) * sc
        if ndc_depth:
            depth = 1.0 - 1.0 / depth
        out.append({
            "depth": depth.astype(np.float32),
            "coord": (np.asarray(data["coord"], np.float64) / scale_coord).astype(
                np.float32),
            "weight": np.asarray(data["weight"], np.float32),
        })
    return out


def load_colmap_depth(basedir: str, factor: int = 8, bd_factor: float = 0.75):
    """Sparse depth supervision from a COLMAP reconstruction
    (the legacy DS-NeRF path)."""
    from depth_lidar_nerf_tpu_torch.data.colmap_model import (
        read_images_binary,
        read_points3d_binary,
    )

    images = read_images_binary(Path(basedir) / "sparse" / "0" / "images.bin")
    points = read_points3d_binary(Path(basedir) / "sparse" / "0" / "points3D.bin")

    errs = np.array([p.error for p in points.values()])
    err_mean = errs.mean()

    # Iterate images in NAME order: poses_bounds.npy rows (and the training
    # image list) are filename-sorted by our gen_poses/colmap_to_poses_bounds,
    # while COLMAP assigns image IDs in registration order. The reference
    # iterates id_im = 1..N (load_llff.py:381) and relies on the two orders
    # coinciding; sorting by name holds whenever they do and stays correct
    # when they don't.
    order = sorted(images, key=lambda i: images[i].name)

    # camera-to-world per image
    poses = []
    for i in order:
        R = images[i].qvec2rotmat()
        t = images[i].tvec.reshape(3, 1)
        w2c = np.concatenate(
            [np.concatenate([R, t], 1), np.array([[0, 0, 0, 1.0]])], 0)
        poses.append(np.linalg.inv(w2c))
    poses = np.stack(poses)

    _, bds = load_poses_bounds(basedir, factor)
    sc = 1.0 if bd_factor is None else 1.0 / (bds.min() * bd_factor)

    out = []
    for n, i in enumerate(order):
        depth_l, coord_l, weight_l = [], [], []
        for xy, pid in zip(images[i].xys, images[i].point3D_ids):
            if pid == -1:
                continue
            p3 = points[pid].xyz
            depth = (poses[n, :3, 2].T @ (p3 - poses[n, :3, 3])) * sc
            if depth < bds[n, 0] * sc or depth > bds[n, 1] * sc:
                continue
            weight = 2 * np.exp(-((points[pid].error / err_mean) ** 2))
            depth_l.append(depth)
            coord_l.append(xy / factor)
            weight_l.append(weight)
        out.append({
            "depth": np.array(depth_l, np.float32),
            "coord": np.array(coord_l, np.float32).reshape(-1, 2),
            "weight": np.array(weight_l, np.float32),
        })
    return out
