"""Reduce a ``torch.profiler`` trace of the measured window to what the
per-layer metrics read.

A :class:`Trace` holds the device intervals (kernels, copies and sets:
``(name, start_s, end_s)``, on the window's clock) and the benchmark's
own host spans (``bench.*`` ``record_function`` ranges). Busy time is the
length of the union of the device intervals, so that kernels which
overlap on several streams (NCCL beside compute) count once.
"""

from __future__ import annotations

from typing import Dict, Iterable, List, NamedTuple, Optional, Tuple

SPAN_PREFIX = "bench."


class Trace(NamedTuple):
    device: List[Tuple[str, float, float]]  # sorted by start
    spans: List[Tuple[str, float, float]]  # the benchmark's host spans
    t0: float  # the window's start
    t1: float  # the window's end

    @property
    def window_s(self) -> float:
        return self.t1 - self.t0


def union(intervals: Iterable[Tuple[float, float]]) -> List[Tuple[float, float]]:
    """Disjoint, sorted intervals covering the same time."""
    out: List[List[float]] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]


def length(intervals) -> float:
    return sum(b - a for a, b in intervals)


def overlap(a: Tuple[float, float], merged: List[Tuple[float, float]]) -> float:
    """Time of interval ``a`` that the disjoint ``merged`` cover."""
    import bisect

    starts = [s for s, _ in merged]
    k = max(0, bisect.bisect_right(starts, a[0]) - 1)
    t = 0.0
    while k < len(merged) and merged[k][0] < a[1]:
        s, e = merged[k]
        t += max(0.0, min(e, a[1]) - max(s, a[0]))
        k += 1
    return t


def short_name(name: str) -> str:
    """A kernel's identifier: ``void f<T, 4>(Net, ...)`` -> ``f``."""
    s = name.replace("(anonymous namespace)::", "")
    if s.startswith("void "):
        s = s[5:]
    for ch in "<(":
        s = s.split(ch, 1)[0]
    return s.strip().split("::")[-1] or name


def from_profile(prof, t0_us: Optional[float] = None,
                 t1_us: Optional[float] = None) -> Trace:
    """The device intervals and ``bench.*`` spans of a finished profile,
    clipped to the ``bench.window`` span when there is one."""
    import torch

    cuda = torch.autograd.DeviceType.CUDA
    dev, spans = [], []
    for e in prof.events():
        a, b = e.time_range.start, e.time_range.end
        if e.device_type == cuda:
            # A user annotation (a record_function range, the optimizer's
            # step) is mirrored on the device's timeline: not an operation.
            if not (getattr(e, "is_user_annotation", False)
                    or e.name.startswith(SPAN_PREFIX)
                    or e.name.startswith("Optimizer.")):
                dev.append((e.name, a, b))
        elif e.name.startswith(SPAN_PREFIX):
            spans.append((e.name, a, b))
    win = [s for s in spans if s[0] == SPAN_PREFIX + "window"]
    if win:
        t0_us, t1_us = win[0][1], win[0][2]
    if t0_us is None:
        t0_us = min(a for _, a, _ in dev + spans)
        t1_us = max(b for _, _, b in dev + spans)
    clip = []
    for n, a, b in dev:
        a, b = max(a, t0_us), min(b, t1_us)
        if b > a:
            clip.append((n, (a - t0_us) / 1e6, (b - t0_us) / 1e6))
    clip.sort(key=lambda x: x[1])
    sp = [(n, (a - t0_us) / 1e6, (b - t0_us) / 1e6) for n, a, b in spans]
    return Trace(clip, sp, 0.0, (t1_us - t0_us) / 1e6)


def busy_s(tr: Trace) -> float:
    return length(union((a, b) for _, a, b in tr.device))


def kernel_time(tr: Trace, names) -> float:
    """Summed device time of the kernels whose identifier is in ``names``."""
    names = set(names)
    return sum(b - a for n, a, b in tr.device if short_name(n) in names)


def is_nccl(name: str) -> bool:
    return "nccl" in name.lower()


def exposed_nccl_s(tr: Trace) -> float:
    """NCCL kernel time that no other kernel overlaps."""
    compute = union((a, b) for n, a, b in tr.device if not is_nccl(n))
    return sum((b - a) - overlap((a, b), compute)
               for n, a, b in tr.device if is_nccl(n))


def top_ops(tr: Trace, k: int = 10) -> List[List]:
    """The ``k`` device operations that took most time, by identifier."""
    by: Dict[str, float] = {}
    for n, a, b in tr.device:
        key = short_name(n)
        by[key] = by.get(key, 0.0) + (b - a)
    return [[n, t] for n, t in sorted(by.items(), key=lambda x: -x[1])[:k]]


def idle_gaps(tr: Trace, k: int = 10) -> List[List]:
    """The ``k`` longest times the device had nothing to run, each named by
    the innermost benchmark span the host was in at the gap's start."""
    busy = union((a, b) for _, a, b in tr.device)
    gaps, t = [], tr.t0
    for a, b in busy:
        if a > t:
            gaps.append((t, a))
        t = max(t, b)
    if tr.t1 > t:
        gaps.append((t, tr.t1))
    out = []
    for a, b in sorted(gaps, key=lambda g: g[0] - g[1])[:k]:
        inner = [s for s in tr.spans if s[1] <= a < s[2]]
        name = (min(inner, key=lambda s: s[2] - s[1])[0] if inner
                else "host outside the benchmark's spans")
        out.append([name, b - a])
    return out


def summary(tr: "Trace") -> dict:
    """What a rank sends rank 0: its busy time, window and exposed NCCL."""
    return {"busy_s": busy_s(tr), "window_s": tr.window_s,
            "exposed_nccl_s": exposed_nccl_s(tr)}


Trace.summary = summary


def reduce_after(tr: Trace, reduce_name: str, after: str) -> float:
    """Device time of the ``reduce_name`` kernels whose nearest earlier
    kernel of the ``fused_nerf`` family is an ``after`` kernel: the
    reductions that close that kernel's work."""
    t, last = 0.0, None
    for n, a, b in tr.device:
        s = short_name(n)
        if s == reduce_name:
            if last == after:
                t += b - a
        elif s.startswith("fused_nerf"):
            last = s
    return t
