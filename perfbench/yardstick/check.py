"""The numbers that decide ``correct``, each held against its limit.

Training: each of the first steps' loss (``loss<i>_gap``) and depth term
before its weight (``depth<i>_gap``, where the configuration has one: the
LiDAR half of the batch), each leaf's first gradient norm
(as the optimizer gets it) and each leaf's change over those steps, taken
by the worst leaf: the gap between the program's norm and the
reference's, over the larger of the reference's norm of that leaf and of
the median leaf. Leaves whose reference gradient is under a thousandth of
the median leaf's move by round-off alone and are left out of both.

Serving: of each checked frame, the mean absolute gap of its rgb
(``rgb_gap``) and the 99th percentile of its pixels' absolute rgb gaps
(``rgb_p99_gap``), the worst frame counting; the disparity's mean gap
over the reference's mean disparity (``disp_gap``) is read beside them.
"""

from __future__ import annotations

import statistics
from typing import Dict, List

import numpy as np
import torch

SMALL_GRAD = 1e-3


def _leaf_gap(got: Dict[str, float], ref: Dict[str, float], keep) -> float:
    med = statistics.median(ref[k] for k in keep)
    # A leaf the program left without optimizer state had no gradient.
    return max(abs(got.get(k, 0.0) - ref[k]) / max(ref[k], med) for k in keep)


def train_numbers(prog, ref) -> Dict[str, float]:
    """``prog`` and ``ref`` are :class:`yardstick.reference.Readings`."""
    med = statistics.median(ref.grad_norms.values())
    keep = [k for k, g in ref.grad_norms.items() if g >= SMALL_GRAD * med]
    out = {f"loss{i + 1}_gap": abs(a - b) / abs(b)
           for i, (a, b) in enumerate(zip(prog.losses, ref.losses))}
    out.update({f"depth{i + 1}_gap": abs(a - b) / abs(b)
                for i, (a, b) in enumerate(zip(prog.depth_losses, ref.depth_losses))})
    out["grad_gap"] = _leaf_gap(prog.grad_norms, ref.grad_norms, keep)
    out["update_gap"] = _leaf_gap(prog.change_norms, ref.change_norms, keep)
    out["grad_diff"] = grad_diff(prog, ref, keep)
    return out


def grad_diff(prog, ref, keep) -> float:
    """The worst leaf's first-gradient difference, ``|g - g_ref|`` over the
    larger of ``|g_ref|`` and the median leaf's: unlike a gap of norms it
    sees which rays and samples the gradient was taken over."""
    med = statistics.median(ref.grad_norms[k] for k in keep)
    out = 0.0
    for k in keep:
        g = prog.grads.get(k)
        r = ref.grads[k]
        d = float(torch.linalg.norm(r if g is None else g.to(r.device) - r))
        out = max(out, d / max(ref.grad_norms[k], med))
    return out


def frame_numbers(frames: List, refs: List) -> Dict[str, float]:
    """``frames`` and ``refs``: ``(rgb [H, W, 3], disp [H, W])`` numpy."""
    rgb = max(float(np.mean(np.abs(f[0] - r[0]))) for f, r in zip(frames, refs))
    p99 = max(float(np.quantile(np.abs(f[0] - r[0]), 0.99)) for f, r in zip(frames, refs))
    disp = max(float(np.mean(np.abs(f[1] - r[1])) / np.mean(np.abs(r[1])))
               for f, r in zip(frames, refs))
    return {"rgb_gap": rgb, "rgb_p99_gap": p99, "disp_gap": disp}


def judge(numbers: Dict[str, float], limits: Dict[str, float]):
    """(correct, {name: {"value", "limit"}}): correct when every number is
    finite and within its limit, and every limit has its number."""
    out, ok = {}, True
    for name, lim in limits.items():
        v = numbers.get(name)
        good = v is not None and np.isfinite(v) and v <= lim
        ok = ok and good
        out[name] = {"value": v, "limit": lim}
    return ok, out
