"""LiDAR depth-supervision loader ``depth_gt.npy`` (the port's copy of
``load_lidar_depth`` in ``depth_lidar_nerf_tpu/data/depth.py``).

Parity target ``load_lidar_depth`` (``load_llff.py:461-552``): per-image list
of ``{depth, coord, weight}``; pixel coords rescaled by the downsample factor,
metric depth rescaled by ``sc = 1/(bds.min() * bd_factor)`` then mapped to
NDC z via ``d <- 1 - 1/d`` (``load_llff.py:521``, report §4.1). The COLMAP
sparse-point loader (``load_colmap_depth``) is not ported yet: it needs the
COLMAP model readers (ROADMAP Queue 1).
"""

from __future__ import annotations

import os

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
