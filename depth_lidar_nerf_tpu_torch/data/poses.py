"""Pose-set utilities: averaging, recentering, spherification, spiral paths
(the port's copy of ``depth_lidar_nerf_tpu/data/poses.py``).

Behavioural parity with the reference's (modified-LLFF) pose pipeline
(``load_llff.py:136-251,295-326``). Everything is float64-tolerant numpy; no
device code.
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


def world_to_camera(pts, c2w):
    """World points [..., 3] into the camera frame: R^T (p - t)
    (``ptstocam``, load_llff.py:147-149)."""
    return (pts - c2w[:3, 3]) @ c2w[:3, :3]


def average_pose(poses):
    """Mean camera: mean center, summed z/up axes (load_llff.py:151-160).

    ``poses [N, 3, 5]`` (with hwf column) or ``[N, 3, 4]``.
    """
    hwf = poses[0, :3, 4:5] if poses.shape[-1] == 5 else None
    center = poses[:, :3, 3].mean(0)
    forward = _unit(poses[:, :3, 2].sum(0))
    up = poses[:, :3, 1].sum(0)
    c2w = view_matrix(forward, up, center)
    if hwf is not None:
        c2w = np.concatenate([c2w, hwf], axis=1)
    return c2w


def recenter_poses(poses):
    """Express all poses relative to the average pose (load_llff.py:177-189)."""
    avg = average_pose(poses)
    bottom = np.array([[0, 0, 0, 1.0]])
    avg44 = np.concatenate([avg[:3, :4], bottom], axis=0)
    out = poses.copy()
    for i in range(poses.shape[0]):
        p44 = np.concatenate([poses[i, :3, :4], bottom], axis=0)
        out[i, :3, :4] = (np.linalg.inv(avg44) @ p44)[:3, :4]
    return out


def spiral_path(c2w, up, rads, focal, zrate=0.5, rots=2, N=120):
    """Spiral of novel-view poses around the average camera
    (load_llff.py:164-173)."""
    rads = np.asarray(list(rads) + [1.0])
    hwf = c2w[:, 4:5]
    out = []
    for theta in np.linspace(0.0, 2.0 * np.pi * rots, N + 1)[:-1]:
        offs = np.array([np.cos(theta), -np.sin(theta), -np.sin(theta * zrate), 1.0])
        c = c2w[:3, :4] @ (offs * rads)
        z = _unit(c - c2w[:3, :4] @ np.array([0, 0, -focal, 1.0]))
        out.append(np.concatenate([view_matrix(z, up, c), hwf], axis=1))
    return np.stack(out)


def spherify_poses(poses, bds):
    """Re-orient a 360-capture so cameras sit on a sphere; emits a circular
    render path (load_llff.py:195-251)."""
    def to44(p):
        bottom = np.tile(np.array([[[0, 0, 0, 1.0]]]), (p.shape[0], 1, 1))
        return np.concatenate([p[:, :3, :4], bottom], axis=1)

    rays_d = poses[:, :3, 2:3]
    rays_o = poses[:, :3, 3:4]

    # Point minimizing distance to all camera axes.
    A = np.eye(3) - rays_d * np.transpose(rays_d, [0, 2, 1])
    b = -A @ rays_o
    center = np.squeeze(-np.linalg.inv((np.transpose(A, [0, 2, 1]) @ A).mean(0)) @ b.mean(0))

    up = (poses[:, :3, 3] - center).mean(0)
    v0 = _unit(up)
    v1 = _unit(np.cross([0.1, 0.2, 0.3], v0))
    v2 = _unit(np.cross(v0, v1))
    world = np.stack([v1, v2, v0, center], axis=1)

    world44 = np.concatenate([world, np.array([[0, 0, 0, 1.0]])], axis=0)
    reset = np.linalg.inv(world44)[None] @ to44(poses)

    rad = np.sqrt(np.mean(np.sum(reset[:, :3, 3] ** 2, -1)))
    sc = 1.0 / rad
    reset[:, :3, 3] *= sc
    bds = bds * sc
    rad *= sc

    centroid = reset[:, :3, 3].mean(0)
    zh = centroid[2]
    radcircle = np.sqrt(rad**2 - zh**2)
    path = []
    for th in np.linspace(0.0, 2.0 * np.pi, 120):
        pos = np.array([radcircle * np.cos(th), radcircle * np.sin(th), zh])
        up_c = np.array([0, 0, -1.0])
        z = _unit(pos)
        x = _unit(np.cross(z, up_c))
        y = _unit(np.cross(z, x))
        path.append(np.stack([x, y, z, pos], axis=1))
    path = np.stack(path)

    hwf = np.broadcast_to(poses[0, :3, 4:5], (path.shape[0], 3, 1))
    path = np.concatenate([path, hwf], axis=-1)
    reset_out = np.concatenate(
        [reset[:, :3, :4], np.broadcast_to(poses[0, :3, 4:5], (reset.shape[0], 3, 1))],
        axis=-1,
    )
    return reset_out, path, bds


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
