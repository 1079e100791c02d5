"""Epoch-shuffled ray batch iterator (host-side compatibility shim; the
port's copy of ``depth_lidar_nerf_tpu/data/ray_dataset.py``).

Role of the reference's ``RayDataset`` + torch DataLoader
(``data.py:4-22``, ``run_nerf.py:1202-1206``). The training path does NOT
use this — batches are gathered on device from resident ray tables
(``train/tables.py``) with zero per-step host traffic. This iterator exists
for users porting host-side pipelines (e.g. exact no-replacement epoch
semantics) and for parity testing.
"""

from __future__ import annotations

from typing import Iterator, Optional

import numpy as np


class RayDataset:
    """Indexable view over a ray array, optionally paired with per-ray
    semantic labels (data.py:4-22)."""

    def __init__(self, ray_data: np.ndarray,
                 semantic_data: Optional[np.ndarray] = None):
        self.rays = np.asarray(ray_data)
        self.semantic = None if semantic_data is None else np.asarray(semantic_data)
        if self.semantic is not None and len(self.semantic) != len(self.rays):
            raise ValueError("semantic labels must align with rays")

    def __len__(self) -> int:
        return len(self.rays)

    def __getitem__(self, i):
        if self.semantic is None:
            return self.rays[i]
        return self.rays[i], self.semantic[i]


def epoch_batches(dataset: RayDataset, batch_size: int,
                  rng: np.random.Generator | None = None,
                  drop_last: bool = False) -> Iterator:
    """One shuffled pass over the dataset in batches (the DataLoader role).

    Re-invoke for the next epoch — the reference recreates its DataLoader on
    StopIteration (run_nerf.py:1337-1347).
    """
    rng = rng or np.random.default_rng()
    order = rng.permutation(len(dataset))
    stop = len(order) - (len(order) % batch_size) if drop_last else len(order)
    for s in range(0, stop, batch_size):
        yield dataset[order[s:s + batch_size]]
