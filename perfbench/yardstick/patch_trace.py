"""A traced window's device time given to the program's patch spans.

The program opens ``patch.ng`` (one a no-grad tile), ``patch.grad``,
``patch.feature`` and ``patch.smooth`` as ``record_function`` ranges on the
host (``train/step.py``). A device operation belongs to the span that was
open on the host when it was launched: its launch is the runtime call
(``cudaLaunchKernel`` and kin) with the operation's correlation id, or
else the framework operator it is linked to. VGG19's backward has no span:
its operations are those launched inside an ``aten::convolution_backward``
(no other convolution runs in a step). Nothing here imports the program.
"""

from __future__ import annotations

import bisect
from typing import Dict, List, NamedTuple, Tuple

from yardstick import trace

PATCH_SPANS = ("patch.ng", "patch.grad", "patch.feature", "patch.smooth")
CONV_BWD = "convolution_backward"
# Kernel 6 (the no-grad semantic forward) and its head.
KERNEL6 = ("fused_nerf_fwd_sem_kernel", "fused_nerf_sem_head_kernel")


class Events(NamedTuple):
    """What the attribution reads of a profile, on the window's clock
    (seconds from its start)."""

    ranges: List[Tuple[str, float, float]]  # patch spans, convolution backwards
    launches: Dict[int, float]  # correlation id -> the runtime call's start
    ops: Dict[int, float]  # framework operator id -> its start
    device: List[Tuple[str, int, int, float, float]]  # name, id, linked id, start, end


def _is_runtime(name: str) -> bool:
    return name.startswith(("cuda", "cu")) and not name.startswith("cudnn")


def from_profile(prof) -> Events:
    """The :class:`Events` of a finished ``torch.profiler`` profile whose
    window is its ``bench.window`` range."""
    import torch

    cuda = torch.autograd.DeviceType.CUDA
    evs = list(prof.events())
    win = [e for e in evs if e.name == trace.SPAN_PREFIX + "window"
           and e.device_type != cuda]
    t0 = win[0].time_range.start if win else 0.0
    ranges, launches, ops, device = [], {}, {}, []
    for e in evs:
        a = (e.time_range.start - t0) * 1e-6
        b = (e.time_range.end - t0) * 1e-6
        if e.device_type == cuda:
            if not (getattr(e, "is_user_annotation", False)
                    or e.name.startswith(trace.SPAN_PREFIX)
                    or e.name.startswith("Optimizer.") or e.name in PATCH_SPANS):
                device.append((trace.short_name(e.name), int(e.id),
                               int(getattr(e, "linked_correlation_id", 0) or 0), a, b))
            continue
        if e.name in PATCH_SPANS or CONV_BWD in e.name:
            ranges.append((e.name, a, b))
        elif _is_runtime(e.name):
            if e.id > 0:
                launches[int(e.id)] = a
        elif e.id > 0:
            ops.setdefault(int(e.id), a)
    return Events(ranges, launches, ops, device)


class _Index:
    """The range that holds an instant: of those that do, the one that
    started last (the innermost, where ranges nest)."""

    def __init__(self, ranges):
        self.r = sorted(ranges, key=lambda x: x[1])
        self.starts = [a for _, a, _ in self.r]
        self.reach, top = [], float("-inf")  # the latest end up to each
        for _, _, b in self.r:
            top = max(top, b)
            self.reach.append(top)

    def at(self, t):
        k = bisect.bisect_right(self.starts, t) - 1
        while k >= 0 and self.reach[k] >= t:
            name, a, b = self.r[k]
            if a <= t <= b:
                return name
            k -= 1
        return None


def attribute(ev: Events) -> Dict[str, float]:
    """Device seconds by where each operation was launched: under each
    patch span, ``vgg_bwd`` (inside a convolution backward),
    ``kernel6_ng`` (kernel 6's and its head's under ``patch.ng``), and the
    counts ``device_ops`` and ``matched`` (those whose launch was found)."""
    spans = _Index([r for r in ev.ranges if r[0] in PATCH_SPANS])
    convs = _Index([r for r in ev.ranges if CONV_BWD in r[0]])
    out = {k: 0.0 for k in PATCH_SPANS + ("vgg_bwd", "kernel6_ng")}
    matched = 0
    for name, cid, linked, a, b in ev.device:
        t = ev.launches.get(cid)
        if t is None and linked:
            t = ev.ops.get(linked)
        if t is None:
            continue
        matched += 1
        if convs.at(t) is not None:
            out["vgg_bwd"] += b - a
        where = spans.at(t)
        if where is not None:
            out[where] += b - a
            if where == "patch.ng" and name in KERNEL6:
                out["kernel6_ng"] += b - a
    out["device_ops"] = float(len(ev.device))
    out["matched"] = float(matched)
    return out


def span_ranges(ev: Events) -> List[Tuple[float, float]]:
    """The patch spans' host ranges, merged."""
    return trace.union((a, b) for n, a, b in ev.ranges if n in PATCH_SPANS)
