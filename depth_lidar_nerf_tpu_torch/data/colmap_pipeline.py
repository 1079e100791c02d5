"""COLMAP pose pipeline: run COLMAP and convert to ``poses_bounds.npy`` (the
port's copy of ``depth_lidar_nerf_tpu/data/colmap_pipeline.py``).

Parity: ``imgs2poses.py`` + ``llff/poses/colmap_wrapper.py:23-77`` (subprocess
feature_extractor / exhaustive_matcher / mapper) + ``llff/poses/pose_utils.py``
(sparse model -> LLFF pose matrix with hwf column, .1/99.9-percentile* depth
bounds; the reference uses close/inf depth percentiles 0.5/99.5 —
``pose_utils.py:82``). COLMAP itself is an external binary; everything else is
numpy.
"""

from __future__ import annotations

import os
import subprocess

import numpy as np

from depth_lidar_nerf_tpu_torch.data.colmap_model import (
    qvec2rotmat,
    read_cameras_binary,
    read_images_binary,
    read_points3d_binary,
)


def run_colmap(basedir: str, match_type: str = "exhaustive_matcher",
               colmap_bin: str = "colmap"):
    """feature_extractor -> matcher -> mapper into ``sparse/0``
    (colmap_wrapper.py:23-77)."""
    db = os.path.join(basedir, "database.db")
    sparse = os.path.join(basedir, "sparse")
    os.makedirs(sparse, exist_ok=True)
    logfile = os.path.join(basedir, "colmap_output.txt")
    cmds = [
        [colmap_bin, "feature_extractor", "--database_path", db,
         "--image_path", os.path.join(basedir, "images"),
         "--ImageReader.single_camera", "1"],
        [colmap_bin, match_type, "--database_path", db],
        [colmap_bin, "mapper", "--database_path", db,
         "--image_path", os.path.join(basedir, "images"),
         "--output_path", sparse,
         "--Mapper.num_threads", "16",
         "--Mapper.init_min_tri_angle", "4",
         "--Mapper.multiple_models", "0",
         "--Mapper.extract_colors", "0"],
    ]
    with open(logfile, "w") as log:
        for cmd in cmds:
            subprocess.run(cmd, check=True, stdout=log, stderr=log)
    return os.path.join(sparse, "0")


def colmap_to_poses_bounds(basedir: str) -> np.ndarray:
    """sparse/0 -> the [N, 17] poses_bounds array (pose_utils.py:12-90)."""
    sparse = os.path.join(basedir, "sparse", "0")
    cams = read_cameras_binary(os.path.join(sparse, "cameras.bin"))
    images = read_images_binary(os.path.join(sparse, "images.bin"))
    points = read_points3d_binary(os.path.join(sparse, "points3D.bin"))

    cam = cams[list(cams)[0]]
    h, w = cam.height, cam.width
    focal = cam.params[0]
    hwf = np.array([h, w, focal]).reshape(3, 1)

    # world-to-cam per image, sorted by filename (pose_utils.py:24-37).
    order = sorted(images, key=lambda i: images[i].name)
    w2c = []
    for i in order:
        R = qvec2rotmat(images[i].qvec)
        t = images[i].tvec.reshape(3, 1)
        w2c.append(np.concatenate(
            [np.concatenate([R, t], 1), np.array([[0, 0, 0, 1.0]])], 0))
    w2c = np.stack(w2c)
    c2w = np.linalg.inv(w2c)[:, :3, :4]  # [N, 3, 4]

    # LLFF axis convention: [y, x, -z] columns (pose_utils.py:41).
    poses = np.concatenate(
        [c2w[:, :, 1:2], c2w[:, :, 0:1], -c2w[:, :, 2:3], c2w[:, :, 3:4]],
        axis=2)
    poses = np.concatenate(
        [poses, np.broadcast_to(hwf, (poses.shape[0], 3, 1))], axis=2)

    # Per-image depth bounds from visible 3D points (pose_utils.py:58-90).
    id_to_row = {img_id: r for r, img_id in enumerate(order)}
    vis_depths = [[] for _ in order]
    for p in points.values():
        for img_id in p.image_ids:
            if img_id not in id_to_row:
                continue
            r = id_to_row[img_id]
            z = (w2c[r] @ np.append(p.xyz, 1.0))[2]
            vis_depths[r].append(z)

    bounds = []
    for ds in vis_depths:
        ds = np.asarray(ds) if len(ds) else np.array([0.01, 1.0])
        bounds.append([np.percentile(ds, 0.5), np.percentile(ds, 99.5)])
    bounds = np.asarray(bounds)

    arr = np.concatenate([poses.reshape(len(order), -1), bounds], axis=1)
    np.save(os.path.join(basedir, "poses_bounds.npy"), arr)
    return arr


def gen_poses(basedir: str, match_type: str = "exhaustive_matcher") -> bool:
    """imgs2poses entry (pose_utils.py:261-286): run COLMAP if no model yet,
    then write poses_bounds.npy."""
    sparse = os.path.join(basedir, "sparse", "0")
    have = (os.path.exists(sparse) and
            {"cameras.bin", "images.bin", "points3D.bin"}.issubset(
                set(os.listdir(sparse))))
    if not have:
        run_colmap(basedir, match_type)
    colmap_to_poses_bounds(basedir)
    return True


if __name__ == "__main__":  # imgs2poses.py:8-18 CLI equivalent
    import argparse

    ap = argparse.ArgumentParser(
        "imgs2poses: COLMAP sparse model -> poses_bounds.npy")
    ap.add_argument("scenedir", help="dir with an images/ subdir")
    ap.add_argument("--match_type", default="exhaustive_matcher",
                    choices=["exhaustive_matcher", "sequential_matcher"])
    ns = ap.parse_args()
    gen_poses(ns.scenedir, ns.match_type)
