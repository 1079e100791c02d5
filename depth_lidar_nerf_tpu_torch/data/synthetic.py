"""Synthetic scene generator (the port's own copy of ``data/synthetic.py``).

An analytic world of coloured floating blobs (optionally a textured wall
behind them, and for the ``hard`` scene textures and occluders), traced from
a few cameras with sparse "LiDAR" depth annotations. :func:`draw_scene`
returns the scene as numpy arrays, so a run can train on it without reading
or writing a file; :func:`make_scene` writes the same scene as an LLFF
directory (images, ``poses_bounds.npy``, ``depth_gt.npy``,
``segmentation_gt.npy``), its PNGs through the port's own writer
(:func:`utils.images.write_png`), so no imaging library is needed.
"""

from __future__ import annotations

import os
from typing import List, NamedTuple

import numpy as np

from depth_lidar_nerf_tpu_torch.utils.images import write_png


def _look_at(eye, target, up=(0, 1, 0)):
    z = eye - target
    z = z / np.linalg.norm(z)
    x = np.cross(np.asarray(up, np.float64), z)
    x = x / np.linalg.norm(x)
    y = np.cross(z, x)
    return np.stack([x, y, z, eye], axis=1)  # [3, 4] c2w, -z forward


_BLOBS = [  # (center, radius, color)
    (np.array([0.0, 0.0, -4.0]), 1.0, np.array([0.9, 0.2, 0.2])),
    (np.array([1.2, 0.6, -5.0]), 0.8, np.array([0.2, 0.8, 0.3])),
    (np.array([-1.1, -0.5, -3.5]), 0.6, np.array([0.2, 0.3, 0.9])),
]
# Extra occluders for the hard scene: small spheres in front of the wall, so
# the depth field has many discontinuities.
_OCCLUDERS = [
    (np.array([-2.1, 0.9, -5.4]), 0.35), (np.array([2.0, -0.8, -4.4]), 0.30),
    (np.array([0.7, -1.1, -3.2]), 0.25), (np.array([-0.6, 1.2, -4.8]), 0.40),
    (np.array([1.7, 1.3, -5.6]), 0.45), (np.array([-1.9, -1.2, -4.9]), 0.38),
    (np.array([0.2, 0.9, -2.9]), 0.22), (np.array([-0.2, -0.4, -5.8]), 0.50),
]
_BG = np.array([0.05, 0.05, 0.08])


def _hard_tex(p):
    """Multi-octave 3-D texture in [0, 1]."""
    x, y, z = p[:, 0], p[:, 1], p[:, 2]
    t = (0.50
         + 0.20 * np.sin(3.1 * x) * np.sin(2.3 * y + 0.7)
         + 0.15 * np.sin(9.7 * x + 1.1) * np.sin(7.3 * y) * np.sin(5.1 * z)
         + 0.10 * np.sin(23.0 * x) * np.sin(19.0 * y + 2.0)
         + 0.05 * np.sin(53.0 * x + 0.3) * np.sin(47.0 * y) * np.sin(31.0 * z))
    return np.clip(t, 0.0, 1.0)


def _trace(ro, rd, backdrop=False, hard=False):
    """Analytic sphere tracer: returns rgb [N, 3], depth [N], class [N]."""
    n = ro.shape[0]
    rgb = np.tile(_BG, (n, 1))
    depth = np.full(n, 1e5)
    cls = np.zeros(n, np.int32)  # 0 = background

    def shade(p, col):
        if not hard:
            return np.broadcast_to(col, p.shape).copy()
        m = _hard_tex(p)[:, None]
        return np.clip(col * (0.35 + 0.9 * m), 0.0, 1.0)

    if backdrop or hard:
        # A textured wall at z=-6 behind the blobs: every ray terminates.
        t_wall = (-6.0 - ro[:, 2]) / np.where(np.abs(rd[:, 2]) < 1e-9, 1e-9,
                                              rd[:, 2])
        hit_w = t_wall > 0.1
        p = ro + rd * t_wall[:, None]
        if hard:
            tex = _hard_tex(p)
        else:
            tex = 0.5 + 0.25 * np.sin(3.0 * p[:, 0]) * np.sin(2.0 * p[:, 1])
        rgb = np.where(hit_w[:, None],
                       np.stack([tex, tex * 0.8, tex * 0.6], -1), rgb)
        depth = np.where(hit_w, t_wall, depth)

    spheres = [(c, r, col, ci + 1) for ci, (c, r, col) in enumerate(_BLOBS)]
    if hard:
        spheres += [(c, r, _BLOBS[i % len(_BLOBS)][2],
                     (i % len(_BLOBS)) + 1)
                    for i, (c, r) in enumerate(_OCCLUDERS)]
    for c, r, col, label in spheres:
        oc = ro - c
        b = np.sum(oc * rd, -1)
        cc = np.sum(oc * oc, -1) - r * r
        disc = b * b - cc * np.sum(rd * rd, -1)
        hit = disc > 0
        t = (-b - np.sqrt(np.maximum(disc, 0))) / np.sum(rd * rd, -1)
        closer = hit & (t > 0.1) & (t < depth)
        depth = np.where(closer, t, depth)
        p_hit = ro + rd * t[:, None]
        rgb = np.where(closer[:, None], shade(p_hit, col), rgb)
        cls = np.where(closer, label, cls)
    return rgb, depth, cls


class SyntheticScene(NamedTuple):
    images: np.ndarray  # [n, H, W, 3] float64 in [0, 1]
    poses: np.ndarray  # [n, 3, 4] camera-to-world, -z forward
    depth_gts: List[dict]  # per image: depth [k] (z-depth), coord [k, 2], weight [k]
    segmentation: np.ndarray  # [n, H, W] int32 class ids
    hwf: tuple  # (H, W, focal)
    near: float
    far: float
    num_classes: int


def draw_scene(n_images: int = 4, H: int = 40, W: int = 52,
               focal: float = 50.0, n_depth_points: int = 300, seed: int = 0,
               backdrop: bool = False, num_classes: int | None = None,
               hard: bool = False) -> SyntheticScene:
    """The scene of :func:`make_scene` as arrays: the traced images, their
    camera-to-world poses (as the rays were traced, before the LLFF
    loader's recentring and rescaling), the depth annotations and the
    near/far bounds that ``make_scene`` writes."""
    rng = np.random.default_rng(seed)
    poses, images, depth_gts, segs = [], [], [], []
    for vi in range(n_images):
        angle = (vi / max(n_images - 1, 1) - 0.5) * 0.5
        eye = np.array([np.sin(angle) * 1.5, 0.15 * np.sin(vi),
                        np.cos(angle) * 0.4])
        c2w = _look_at(eye, np.array([0.0, 0.0, -4.0]))

        i, j = np.meshgrid(np.arange(W, dtype=np.float64),
                           np.arange(H, dtype=np.float64), indexing="xy")
        dirs = np.stack([(i - W * 0.5) / focal, -(j - H * 0.5) / focal,
                         -np.ones_like(i)], -1)
        rd = np.einsum("hwc,rc->hwr", dirs, c2w[:3, :3]).reshape(-1, 3)
        ro = np.broadcast_to(c2w[:3, 3], rd.shape)

        rgb, depth, cls = _trace(ro, rd, backdrop=backdrop, hard=hard)
        images.append(rgb.reshape(H, W, 3))
        segs.append(cls.reshape(H, W))

        # Sparse "LiDAR" annotations at random pixels with a surface hit.
        hit_idx = np.nonzero(depth < 1e4)[0]
        pick = rng.choice(hit_idx, size=min(n_depth_points, len(hit_idx)),
                          replace=False)
        coord = np.stack([pick % W, pick // W], axis=-1).astype(np.float64)
        # Reference depth convention: distance along the camera -z axis.
        zdepth = depth[pick] * (-(rd[pick] @ c2w[:3, 2]))
        depth_gts.append({"depth": zdepth, "coord": coord,
                          "weight": np.ones(len(pick))})
        poses.append(c2w)

    near = max(0.5, min(d["depth"].min() for d in depth_gts) * 0.8)
    far = max(d["depth"].max() for d in depth_gts) * 1.2
    return SyntheticScene(np.stack(images), np.stack(poses), depth_gts,
                          np.stack(segs), (H, W, focal), float(near),
                          float(far), max(len(_BLOBS) + 1, num_classes or 0))


def make_scene(basedir: str, n_images: int = 4, H: int = 40, W: int = 52,
               focal: float = 50.0, n_depth_points: int = 300, seed: int = 0,
               backdrop: bool = False, num_classes: int | None = None,
               hard: bool = False):
    """Write :func:`draw_scene`'s scene to ``basedir`` as an LLFF scene."""
    sc = draw_scene(n_images, H, W, focal, n_depth_points, seed, backdrop,
                    num_classes, hard)
    os.makedirs(os.path.join(basedir, "images"), exist_ok=True)
    hwf = np.array([[H], [W], [focal]], np.float64)
    rows = []
    for vi, (img, c2w) in enumerate(zip(sc.images, sc.poses)):
        write_png(os.path.join(basedir, "images", f"im_{vi:03d}.png"),
                  (img * 255).astype(np.uint8))
        llff = np.concatenate([c2w[:, 0:1], -c2w[:, 1:2], -c2w[:, 2:3],
                               c2w[:, 3:]], axis=1)
        rows.append(np.concatenate([llff, hwf], axis=1))
    poses_bounds = np.stack([np.concatenate([p.reshape(-1), [sc.near, sc.far]])
                             for p in rows])
    np.save(os.path.join(basedir, "poses_bounds.npy"), poses_bounds)
    np.save(os.path.join(basedir, "depth_gt.npy"),
            np.array(sc.depth_gts, dtype=object), allow_pickle=True)
    np.save(os.path.join(basedir, "segmentation_gt.npy"),
            {"segmentations": sc.segmentation,
             "num_classes": sc.num_classes}, allow_pickle=True)
    return basedir
