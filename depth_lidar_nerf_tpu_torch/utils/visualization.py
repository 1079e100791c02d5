"""Depth colour maps (the port's copy of the two functions of
``utils/visualization.py`` that the driver writes depth images with).

Parity: ``utils/visualization.py:52-66`` of the reference — a jet colour map
of a depth image, pure numpy.
"""

from __future__ import annotations

import numpy as np


def _jet(x: np.ndarray) -> np.ndarray:
    """Jet colormap on [0, 1] -> uint8 RGB."""
    x = np.clip(x, 0.0, 1.0)
    r = np.clip(1.5 - np.abs(4 * x - 3), 0, 1)
    g = np.clip(1.5 - np.abs(4 * x - 2), 0, 1)
    b = np.clip(1.5 - np.abs(4 * x - 1), 0, 1)
    return (np.stack([r, g, b], axis=-1) * 255).astype(np.uint8)


def depth_to_colormap(depth: np.ndarray, lo: float | None = None,
                      hi: float | None = None) -> np.ndarray:
    """Jet-colored depth image [H, W] -> [H, W, 3] uint8."""
    d = np.nan_to_num(np.asarray(depth, np.float64))
    lo = np.min(d) if lo is None else lo
    hi = np.max(d) if hi is None else hi
    scale = (d - lo) / (hi - lo + 1e-12)
    return _jet(scale)
