"""DTU scene loader (images + ``cameras.npz`` projection matrices); the
port's copy of ``depth_lidar_nerf_tpu/data/dtu.py``.

Parity: ``load_dtu.py:6-70`` — decompose ``world_mat_i @ scale_mat_i`` into
K/R/t, fixed near=0.1 / far=5.0 handled by the caller
(``run_nerf.py:976-977``). Where the JAX package calls OpenCV's
``decomposeProjectionMatrix``, the port takes an RQ decomposition from scipy
with OpenCV's conventions, so it needs no cv2.
"""

from __future__ import annotations

import os

import numpy as np
from scipy.linalg import rq

from depth_lidar_nerf_tpu_torch.utils.images import imread_rgb_float


def _decompose_projection(P: np.ndarray):
    """P [3, 4] -> K [3, 3] (K[2, 2] = 1), R [3, 3], t [3], as OpenCV's
    ``decomposeProjectionMatrix`` and the JAX package give them: ``P[:, :3]
    = K' R`` by RQ with R a rotation and the first two diagonal entries of
    K' positive (OpenCV's ``RQDecomp3x3``), K = K' / K'[2, 2]; t the camera
    centre, the null vector of P."""
    M = np.asarray(P[:, :3], np.float64)
    K, R = rq(M)
    D = np.diag(np.sign(np.diag(K)))  # K D has a positive diagonal
    K, R = K @ D, D @ R
    if np.linalg.det(R) < 0:  # keep R a rotation; the sign goes to K[2, 2]
        flip = np.diag([1.0, 1.0, -1.0])
        K, R = K @ flip, flip @ R
    t = -np.linalg.solve(M, np.asarray(P[:, 3], np.float64))
    return K / K[2, 2], R, t


def load_dtu_data(basedir: str):
    """Returns images [N, H, W, 3], c2w poses [N, 4, 4], hwf."""
    cam = np.load(os.path.join(basedir, "cameras.npz"))
    imgdir = os.path.join(basedir, "image")
    if not os.path.isdir(imgdir):
        imgdir = os.path.join(basedir, "images")
    files = [os.path.join(imgdir, f) for f in sorted(os.listdir(imgdir))
             if f.lower().endswith((".png", ".jpg", ".jpeg"))]
    images = np.stack(
        [imread_rgb_float(f) for f in files]
    ).astype(np.float32)

    poses, focal = [], None
    for i in range(len(files)):
        world_mat = cam[f"world_mat_{i}"]
        scale_mat = cam.get(f"scale_mat_{i}", np.eye(4))
        P = (world_mat @ scale_mat)[:3, :4]
        K, R, t = _decompose_projection(P)
        c2w = np.eye(4)
        c2w[:3, :3] = R.T
        c2w[:3, 3] = t
        # OpenCV camera (+z forward, +y down) -> NeRF camera (-z forward, +y up)
        c2w[:3, 1:3] *= -1
        poses.append(c2w)
        focal = K[0, 0]
    poses = np.stack(poses).astype(np.float32)
    H, W = images.shape[1:3]
    return images, poses, (H, W, float(focal))
