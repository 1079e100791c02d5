"""Spiral render paths (the port's copy of the part of
``depth_lidar_nerf_tpu/data/poses.py`` that serving needs).

Behavioural parity with the reference's (modified-LLFF) pose pipeline
(``load_llff.py:136-173``). Everything is float64 numpy; no device code.
"""

from __future__ import annotations

import numpy as np


def _unit(x):
    return x / np.linalg.norm(x)


def view_matrix(forward, up, position):
    """Camera-to-world [3, 4] with z = forward, y ~ up (load_llff.py:139-145)."""
    z = _unit(forward)
    x = _unit(np.cross(up, z))
    y = _unit(np.cross(z, x))
    return np.stack([x, y, z, position], axis=1)


def average_pose(poses):
    """Mean camera ``[3, 4]`` of ``poses [N, 3, 4]``: mean center, summed
    z/up axes (load_llff.py:151-160)."""
    center = poses[:, :3, 3].mean(0)
    forward = _unit(poses[:, :3, 2].sum(0))
    up = poses[:, :3, 1].sum(0)
    return view_matrix(forward, up, center)


def generate_render_path(poses, focal, sc=1.0, N_views=120, N_rots=2,
                         zrate=0.5):
    """Spiral around the AVERAGE pose with 90th-percentile radii — the
    ``--render_mypath`` generator (``utils/generate_renderpath.py:33-51``):
    camera centers trace ``c2w @ ([cos t, -sin t, -sin(zrate t), 1] * rads)``
    and every view looks at the shared focal point ``c2w @ [0, 0, -focal, 1]``."""
    c2w = average_pose(poses[:, :3, :4])
    up = _unit(poses[:, :3, 1].sum(0))
    rads = np.percentile(np.abs(poses[:, :3, 3]), 90, 0) * sc
    rads = np.append(rads, 1.0)
    out = []
    for theta in np.linspace(0.0, 2.0 * np.pi * N_rots, N_views + 1)[:-1]:
        c = c2w[:3, :4] @ (np.array(
            [np.cos(theta), -np.sin(theta), -np.sin(theta * zrate), 1.0])
            * rads)
        z = c - c2w[:3, :4] @ np.array([0.0, 0.0, -focal, 1.0])
        out.append(view_matrix(z, up, c))
    return np.stack(out)
