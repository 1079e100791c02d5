"""The program's own spans on the traced window's clock, and the device's
idle time split by what the host was doing.

The program (``depth_lidar_nerf_tpu_torch.utils.tracing``) records its
spans in memory while a profiler records: ``(name, id, parent, t0_ns,
t1_ns)`` on the host's wall clock. A unit is one training step (``step``)
or one served frame (``frame``), each enclosed by exactly one of the
harness's own spans (``bench.step``, ``bench.render_path``). The window's
origin on the program's clock is the median over units of the offset
between the two starts; the distance between the offsets' quartiles is
the alignment's spread. (The first unit's offset stands apart: the first
``record_function`` under a new profiler stamps its start about a
millisecond before it returns.)

Each device-idle interval of the window (the gaps in the union of the
device intervals) is split by the innermost program span open at each
instant; the rest is idle outside the program's spans. A span's phase is
its ancestor (or itself) that is a direct child of a unit, so that a
render tile inside a step's render phase counts as that phase.

Where the program records no such spans (a version without the recorder),
:func:`split` returns None.
"""

from __future__ import annotations

import json
import statistics
import sys
from typing import Dict, List, NamedTuple, Optional, Tuple

from yardstick import trace

UNITS = {"step": "bench.step", "frame": "bench.render_path"}
OUTSIDE = "outside"  # idle while the host was in no program span


class Split(NamedTuple):
    units: int  # aligned program units in the window
    idle_s: Dict[str, float]  # by phase (or unit name, or OUTSIDE)
    idle_total_s: float  # the window's idle time
    spread_s: float  # the alignment's spread (offsets' quartiles)
    offset_max_s: float  # the largest distance of an offset from the median
    unit_host_s: List[float]  # each unit's host duration


def recorder():
    """The program's recorder, or None where the program has none."""
    try:
        from depth_lidar_nerf_tpu_torch.utils import tracing
    except ImportError:
        return None
    return tracing


def idle_intervals(tr: trace.Trace) -> List[Tuple[float, float]]:
    """The window's device-idle intervals, sorted."""
    out, t = [], tr.t0
    for a, b in trace.union((a, b) for _, a, b in tr.device):
        if a > t:
            out.append((t, min(a, tr.t1)))
        t = max(t, b)
    if tr.t1 > t:
        out.append((t, tr.t1))
    return [(a, b) for a, b in out if b > a]


def innermost(spans: List[Tuple[float, float, int, int]]):
    """Disjoint ``(start, end, index)`` segments, each labelled with the
    innermost span open over it (``index`` None: no span open). ``spans``
    are ``(start, end, depth, index)`` of properly nested intervals."""
    events = []
    for a, b, depth, k in spans:
        events.append((a, 1, depth, k))  # opens after closes at one instant
        events.append((b, 0, -depth, k))
    events.sort()
    segs, stack, t = [], [], None
    for when, kind, _, k in events:
        if t is not None and when > t:
            segs.append((t, when, stack[-1] if stack else None))
        t = when
        if kind:
            stack.append(k)
        elif k in stack:
            stack.remove(k)
    return segs


def attribute(idle: List[Tuple[float, float]],
              segs) -> Dict[Optional[int], float]:
    """Idle seconds under each segment label (both lists sorted)."""
    out: Dict[Optional[int], float] = {}
    i = j = 0
    while i < len(idle) and j < len(segs):
        a, b = idle[i]
        s, e, k = segs[j]
        lo, hi = max(a, s), min(b, e)
        if hi > lo:
            out[k] = out.get(k, 0.0) + (hi - lo)
        if b <= e:
            i += 1
        else:
            j += 1
    covered = sum(out.values())
    total = sum(b - a for a, b in idle)
    out[None] = out.get(None, 0.0) + max(0.0, total - covered)
    return out


def _phase(recs, k: int, unit: str) -> str:
    """The phase a span belongs to: its ancestor-or-self whose parent is a
    ``unit`` span; the unit itself; or, outside any unit, its root's name."""
    path = [k]
    while recs[path[-1]].parent is not None:
        path.append(recs[path[-1]].parent)
    for child, parent in zip(path, path[1:]):
        if recs[parent].name == unit:
            return recs[child].name
    return recs[path[-1]].name


# The last split: the readers of one run share it. It holds its trace, so
# that another run's trace cannot take the same id.
_LAST: list = [None, None, None]  # trace, unit, split


def split(ctx, unit: str) -> Optional[Split]:
    """The window's idle time split by the program's phases of ``unit``
    (``"step"`` or ``"frame"``); None without the program's spans. Printed
    once a run to standard error."""
    tr = ctx["trace"]
    if _LAST[0] is not tr or _LAST[1] != unit:
        _LAST[:] = [tr, unit, _split(tr, unit)]
        if _LAST[2] is not None:
            _report(unit, _LAST[2])
    return _LAST[2]


def _split(tr: trace.Trace, unit: str) -> Optional[Split]:
    rec = recorder()
    if rec is None or tr is None:
        return None
    # Parents index the recorder's list, which holds open spans too.
    allr = rec.records()
    roots = sorted((r for r in allr if r.name == unit and r.parent is None
                    and r.t1_ns is not None), key=lambda r: r.t0_ns)
    bench = sorted((s for s in tr.spans if s[0] == UNITS[unit]),
                   key=lambda s: s[1])
    if not roots or len(roots) != len(bench):
        return None
    offsets = [r.t0_ns * 1e-9 - b[1] for r, b in zip(roots, bench)]
    origin = statistics.median(offsets)
    spread = 0.0
    if len(offsets) > 1:
        q = statistics.quantiles(offsets, n=4)
        spread = q[2] - q[0]
    depth = {}
    for k, r in enumerate(allr):
        depth[k] = 0 if r.parent is None else depth[r.parent] + 1
    spans = [(r.t0_ns * 1e-9 - origin, r.t1_ns * 1e-9 - origin, depth[k], k)
             for k, r in enumerate(allr) if r.t1_ns is not None]
    idle = idle_intervals(tr)
    by_span = attribute(idle, innermost(spans))
    idle_s: Dict[str, float] = {}
    for k, t in by_span.items():
        name = OUTSIDE if k is None else _phase(allr, k, unit)
        idle_s[name] = idle_s.get(name, 0.0) + t
    return Split(len(roots), idle_s, sum(b - a for a, b in idle), spread,
                 max(abs(o - origin) for o in offsets),
                 [(r.t1_ns - r.t0_ns) * 1e-9 for r in roots])


def _report(unit: str, s: Split):
    per = {k: 1e3 * v / s.units for k, v in sorted(s.idle_s.items())}
    print("spans " + json.dumps({
        "unit": unit, "units": s.units,
        "align_spread_ms": 1e3 * s.spread_s,
        "align_max_ms": 1e3 * s.offset_max_s,
        "idle_ms_per_unit": per,
        "idle_ms_per_unit_total": 1e3 * s.idle_total_s / s.units}),
        file=sys.stderr)


def idle_ms(ctx, unit: str, phases) -> Optional[float]:
    """Device-idle ms a unit while the host was in one of ``phases``."""
    if not ctx["trace"] or not ctx["trace"].device:
        return None
    s = split(ctx, unit)
    if s is None:
        return None
    return 1e3 * sum(s.idle_s.get(p, 0.0) for p in phases) / s.units
