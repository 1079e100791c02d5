"""Depth/keypoint visualization helpers (the port's copy of
``utils/visualization.py``).

Parity: ``utils/visualization.py:52-102`` of the reference — jet-colormap
depth images, depth-scatter overlays on RGB, masked-UV depth views. Pure
numpy; :func:`visualize_sigma` imports matplotlib when called.
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


def depth_on_image(depth_points: dict, image: np.ndarray) -> np.ndarray:
    """Scatter sparse depth annotations onto an RGB image
    (utils/visualization.py:69-87)."""
    img = (np.asarray(image) * 255).astype(np.uint8).copy()
    coords = np.asarray(depth_points["coord"]).astype(int)
    depths = np.asarray(depth_points["depth"], np.float64)
    # np.ptp(): the ndarray method was removed in NumPy 2.0.
    colors = _jet((depths - depths.min()) / (np.ptp(depths) + 1e-12))
    H, W = img.shape[:2]
    for (x, y), c in zip(coords, colors):
        if 0 <= y < H and 0 <= x < W:
            img[y, x] = c
    return img


def masked_uv_depth(depth_map: np.ndarray, coords: np.ndarray) -> np.ndarray:
    """Depth image showing only the annotated pixels
    (utils/visualization.py:90-102)."""
    mask = np.zeros(depth_map.shape, bool)
    c = np.asarray(coords).astype(int)
    H, W = depth_map.shape
    ok = (c[:, 1] >= 0) & (c[:, 1] < H) & (c[:, 0] >= 0) & (c[:, 0] < W)
    mask[c[ok, 1], c[ok, 0]] = True
    vis = depth_to_colormap(depth_map)
    vis[~mask] = 0
    return vis


def visualize_sigma(sigma, z_vals, filename: str) -> str:
    """Density-vs-depth profile plot for one ray
    (run_nerf_helpers.py:614-619)."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    plt.figure()
    plt.plot(np.asarray(z_vals), np.asarray(sigma))
    plt.xlabel("z_vals")
    plt.ylabel("sigma")
    plt.savefig(filename)
    plt.close()
    return filename
