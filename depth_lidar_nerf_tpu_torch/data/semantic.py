"""Semantic ground-truth loader (``segmentation_gt.npy``); the port's copy
of ``depth_lidar_nerf_tpu/data/semantic.py``.

Parity: ``load_semantic_data`` (``load_llff.py:556-584``) + the
nearest-neighbour downsample from ``SemanticSegmentorHelper
.downsample_predictions`` (``preprocess/KITTI360/segmentor.py:80-84``).
"""

from __future__ import annotations

import os

import numpy as np


def nearest_downsample(seg: np.ndarray, H: int, W: int) -> np.ndarray:
    """NN-resize integer class maps ``[N, h, w] -> [N, H, W]``."""
    n, h, w = seg.shape
    rows = (np.arange(H) * (h / H)).astype(np.int64).clip(0, h - 1)
    cols = (np.arange(W) * (w / W)).astype(np.int64).clip(0, w - 1)
    return seg[:, rows[:, None], cols[None, :]]


def load_semantic_data(basedir: str, H: int | None = None, W: int | None = None):
    """Returns (segmentations [N, H, W] int32, num_classes)."""
    data = np.load(os.path.join(basedir, "segmentation_gt.npy"),
                   allow_pickle=True).item()
    seg = np.asarray(data["segmentations"])
    num_classes = int(data["num_classes"])
    if seg.ndim == 4:  # [N, 1, h, w]
        seg = seg[:, 0]
    if H is not None and (seg.shape[1] != H or seg.shape[2] != W):
        seg = nearest_downsample(seg, H, W)
    return seg.astype(np.int32), num_classes
