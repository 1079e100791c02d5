"""Offline metrics CLI: PSNR, SSIM and LPIPS over two image directories (port
of ``evaluation/eval_metrics.py``).

Parity: ``eval_metrics_script.py:20-65`` of the reference: pairs the images
of two directories in sorted order (names holding ``depth`` left out) and
prints each pair's metrics, then their mean and standard deviation. LPIPS
is the port's AlexNet LPIPS (``models/lpips.py``) with an ``lpips`` package
state dict from ``--lpips_weights``, else weights drawn from seed 0, on the
card (``evaluate_dirs(..., device="cpu")`` runs it on the CPU). Images are
read through ``utils/images.py``.

Usage::

    python -m depth_lidar_nerf_tpu_torch.evaluation.eval_metrics \\
        --generated_dir out/ --gt_dir gt/ [--no_lpips] [--lpips_weights f.pth]
"""

from __future__ import annotations

import argparse
import os

import numpy as np
import torch

from depth_lidar_nerf_tpu_torch.device import resolve_device
from depth_lidar_nerf_tpu_torch.evaluation.metrics import psnr, ssim_np
from depth_lidar_nerf_tpu_torch.models.lpips import init_lpips
from depth_lidar_nerf_tpu_torch.utils.images import imread_rgb_float

_EXT = (".png", ".jpg", ".jpeg")


def _load_dir(d):
    files = [os.path.join(d, f) for f in sorted(os.listdir(d))
             if f.lower().endswith(_EXT) and "depth" not in f]
    return files, [imread_rgb_float(f) for f in files]


def evaluate_dirs(generated_dir: str, gt_dir: str, use_lpips: bool = True,
                  lpips_weights: str | None = None, device=None):
    """Per-image rows ``{file, psnr, ssim[, lpips]}`` and the summary
    ``{metric: (mean, std)}``; LPIPS on ``device`` (the card unless
    given)."""
    gen_files, gen = _load_dir(generated_dir)
    gt_files, gt = _load_dir(gt_dir)
    if len(gen) != len(gt):
        raise ValueError(f"{len(gen)} generated vs {len(gt)} gt images")

    model = None
    if use_lpips:
        device = resolve_device(device)
        model = init_lpips(weights_path=lpips_weights, device=device)

    rows = []
    for f, a, b in zip(gen_files, gen, gt):
        if a.shape != b.shape:
            raise ValueError(f"shape mismatch for {f}: {a.shape} vs {b.shape}")
        row = {"file": os.path.basename(f), "psnr": psnr(a, b),
               "ssim": ssim_np(a, b)}
        if model is not None:
            x, y = (torch.as_tensor(v.astype(np.float32), device=device)[None]
                    for v in (a, b))
            with torch.no_grad():
                row["lpips"] = float(model(x, y)[0])
        rows.append(row)
    summary = {}
    for key in ("psnr", "ssim", "lpips"):
        vals = [r[key] for r in rows if key in r]
        if vals:
            summary[key] = (float(np.mean(vals)), float(np.std(vals)))
    return rows, summary


def main(argv=None):
    ap = argparse.ArgumentParser("eval_metrics")
    ap.add_argument("--generated_dir", required=True)
    ap.add_argument("--gt_dir", required=True)
    ap.add_argument("--no_lpips", action="store_true")
    ap.add_argument("--lpips_weights", default=None)
    args = ap.parse_args(argv)

    rows, summary = evaluate_dirs(args.generated_dir, args.gt_dir,
                                  use_lpips=not args.no_lpips,
                                  lpips_weights=args.lpips_weights)
    for r in rows:
        extras = f"  lpips {r['lpips']:.4f}" if "lpips" in r else ""
        print(f"{r['file']}: psnr {r['psnr']:.2f}  ssim {r['ssim']:.4f}{extras}")
    for k, (m, s) in summary.items():
        print(f"mean {k}: {m:.4f} (std {s:.4f})")


if __name__ == "__main__":
    main()
