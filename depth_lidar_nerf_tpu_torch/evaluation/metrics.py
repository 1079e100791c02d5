"""Image quality metrics for the driver's held-out views: PSNR and SSIM (the
port's copy of the first part of ``evaluation/metrics.py``).

Parity targets: ``eval_utils.py:15-118`` of the reference (numpy
fspecial-Gauss SSIM, PSNR). LPIPS is ``models/lpips.py``.
"""

from __future__ import annotations

import numpy as np
from scipy import signal


def psnr(img1: np.ndarray, img2: np.ndarray, max_val: float = 1.0) -> float:
    mse = np.mean((np.asarray(img1, np.float64) - np.asarray(img2, np.float64)) ** 2)
    if mse == 0:
        return float("inf")
    return float(20 * np.log10(max_val) - 10 * np.log10(mse))


def _fspecial_gauss(size: int, sigma: float) -> np.ndarray:
    radius = size // 2
    offset = 0.0
    start, stop = -radius, radius + 1
    if size % 2 == 0:
        offset = 0.5
        stop -= 1
    x, y = np.mgrid[offset + start:stop, offset + start:stop]
    g = np.exp(-((x**2 + y**2) / (2.0 * sigma**2)))
    return g / g.sum()


def ssim_np(
    img1: np.ndarray,
    img2: np.ndarray,
    max_val: float = 1.0,
    filter_size: int = 11,
    filter_sigma: float = 1.5,
    k1: float = 0.01,
    k2: float = 0.03,
) -> float:
    """Gaussian-window SSIM over HWC images (eval_utils.py:38-118 semantics).

    Matches the reference's offline eval exactly (differentially tested
    against its own code): ``mode="same"`` convolution — border pixels count
    toward the mean — and the filter shrinks (sigma rescaled) when the image
    is smaller than ``filter_size``. The paper's Table 1 SSIM numbers were
    computed with these semantics, so parity comparisons must use them.
    """
    img1 = np.asarray(img1, np.float64)
    img2 = np.asarray(img2, np.float64)
    if img1.ndim == 2:
        img1, img2 = img1[..., None], img2[..., None]

    h, w = img1.shape[:2]
    size = min(filter_size, h, w)
    sigma = size * filter_sigma / filter_size if filter_size else 0.0
    window = _fspecial_gauss(size, sigma) if filter_size else None
    c1 = (k1 * max_val) ** 2
    c2 = (k2 * max_val) ** 2

    def filt(x):
        # filter_size=0 means no blur (eval_utils.py:86-99: mu = img).
        if window is None:
            return x
        return signal.fftconvolve(x, window, mode="same")

    vals = []
    for c in range(img1.shape[-1]):
        a, b = img1[..., c], img2[..., c]
        mu1 = filt(a)
        mu2 = filt(b)
        s11 = filt(a * a) - mu1**2
        s22 = filt(b * b) - mu2**2
        s12 = filt(a * b) - mu1 * mu2
        ssim_map = ((2 * mu1 * mu2 + c1) * (2 * s12 + c2)) / (
            (mu1**2 + mu2**2 + c1) * (s11 + s22 + c2)
        )
        vals.append(ssim_map.mean())
    return float(np.mean(vals))
