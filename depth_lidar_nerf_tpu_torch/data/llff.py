"""LLFF-format scene loader (``poses_bounds.npy`` + an image directory); the
port's copy of ``depth_lidar_nerf_tpu/data/llff.py``.

Behavioural parity with the reference's modified LLFF loader
(``load_llff.py:72-345``), including its deltas from stock LLFF:

- the KITTI pose-axis convention fix ``[x, -y, -z]`` instead of the stock
  ``[-u, r, -t] -> [r, u, -t]`` swap (``load_llff.py:269``);
- bd-factor rescale ``sc = 1 / (bds.min() * bd_factor)`` (``:281-283``);
- recenter to the average pose; spherify or spiral render path;
- holdout view = camera closest to the average pose (``:335-337``).

Images are read with :func:`utils.images.imread_rgb_float` (PNG without any
imaging library). A downsampled pyramid ``images_{factor}/`` that is missing
is built with PIL's LANCZOS filter, as in the JAX package; without PIL the
loader raises and names the folder to build, and never resizes another way.
"""

from __future__ import annotations

import os
import shutil

import numpy as np

from depth_lidar_nerf_tpu_torch.data.poses import (average_pose,
                                                   recenter_poses,
                                                   spherify_poses, spiral_path)
from depth_lidar_nerf_tpu_torch.utils.images import imread_rgb_float

_IMG_EXT = (".jpg", ".jpeg", ".png", ".JPG", ".PNG", ".JPEG")


def _image_files(d):
    return [os.path.join(d, f) for f in sorted(os.listdir(d)) if f.endswith(_IMG_EXT)]


def minify(basedir: str, factor: int) -> str:
    """Create ``images_{factor}/`` with PIL if missing; return its path.

    Downsampled images are written to a temp dir renamed into place on
    completion, so a crash mid-minify cannot leave a partial
    ``images_{factor}/`` that later loads would mistake for complete.
    """
    imgdir = os.path.join(basedir, f"images_{factor}")
    if os.path.exists(imgdir):
        return imgdir
    try:
        from PIL import Image
    except ImportError:
        raise RuntimeError(
            f"{imgdir} is missing and PIL is not importable to build it: "
            f"write the images of {os.path.join(basedir, 'images')} "
            f"downsampled {factor}x (LANCZOS) there, or load with factor 0"
        ) from None

    tmpdir = imgdir + ".tmp"
    if os.path.exists(tmpdir):  # leftover from a previous crash
        shutil.rmtree(tmpdir)
    os.makedirs(tmpdir)
    for f in _image_files(os.path.join(basedir, "images")):
        with Image.open(f) as img:
            w, h = img.size
            small = img.resize((w // factor, h // factor), Image.LANCZOS)
        out = os.path.join(tmpdir, os.path.splitext(os.path.basename(f))[0] + ".png")
        small.save(out)
    os.rename(tmpdir, imgdir)
    return imgdir


def load_poses_bounds(basedir: str, factor: int | None = None):
    """Read ``poses_bounds.npy`` -> (poses [N, 3, 5], bds [N, 2]) with the hwf
    column rescaled by the downsample factor (``load_llff.py:72-117``)."""
    arr = np.load(os.path.join(basedir, "poses_bounds.npy"))
    poses = arr[:, :-2].reshape(-1, 3, 5)
    bds = arr[:, -2:]
    if factor:
        # True size from the minified images; fall back to //factor.
        imgdir = os.path.join(basedir, f"images_{factor}")
        if os.path.exists(imgdir) and _image_files(imgdir):
            sh = imread_rgb_float(_image_files(imgdir)[0]).shape
            poses[:, 0, 4] = sh[0]
            poses[:, 1, 4] = sh[1]
        else:
            poses[:, 0, 4] = poses[:, 0, 4] // factor
            poses[:, 1, 4] = poses[:, 1, 4] // factor
        poses[:, 2, 4] = poses[:, 2, 4] / factor
    return poses.astype(np.float32), bds.astype(np.float32)


def load_llff_data(
    basedir: str,
    factor: int = 8,
    recenter: bool = True,
    bd_factor: float | None = 0.75,
    spherify: bool = False,
):
    """Load an LLFF scene. Returns (images, poses[N,3,5], bds, render_poses,
    i_test) with the reference's conventions."""
    poses, bds = load_poses_bounds(basedir, factor)
    imgdir = minify(basedir, factor) if factor and factor != 1 else os.path.join(
        basedir, "images")
    files = _image_files(imgdir)
    if len(files) != poses.shape[0]:
        raise ValueError(
            f"{len(files)} images in {imgdir} but {poses.shape[0]} poses")
    images = np.stack([imread_rgb_float(f) for f in files]).astype(np.float32)

    # Update hwf from the actual loaded images.
    poses[:, 0, 4] = images.shape[1]
    poses[:, 1, 4] = images.shape[2]

    # KITTI-convention axis fix (load_llff.py:269): camera basis columns
    # [cx, cy, cz] -> [cx, -cy, -cz] (translation and hwf untouched).
    poses = np.concatenate(
        [poses[:, :, 0:1], -poses[:, :, 1:2], -poses[:, :, 2:3], poses[:, :, 3:]],
        axis=2,
    )

    sc = 1.0 if bd_factor is None else 1.0 / (bds.min() * bd_factor)
    poses[:, :3, 3] *= sc
    bds = bds * sc

    if recenter:
        poses = recenter_poses(poses)

    if spherify:
        poses, render_poses, bds = spherify_poses(poses, bds)
    else:
        c2w = average_pose(poses)
        up = poses[:, :3, 1].sum(0)
        up = up / np.linalg.norm(up)
        close_depth, inf_depth = bds.min() * 0.9, bds.max() * 5.0
        dt = 0.75
        focal = 1.0 / ((1.0 - dt) / close_depth + dt / inf_depth)
        tt = poses[:, :3, 3]
        rads = np.percentile(np.abs(tt), 90, axis=0)
        render_poses = spiral_path(c2w, up, rads, focal, zrate=0.5, rots=2, N=120)

    dists = np.sum((average_pose(poses)[:3, 3] - poses[:, :3, 3]) ** 2, -1)
    i_test = int(np.argmin(dists))
    return (
        images,
        poses.astype(np.float32),
        bds.astype(np.float32),
        np.asarray(render_poses, np.float32),
        i_test,
    )
