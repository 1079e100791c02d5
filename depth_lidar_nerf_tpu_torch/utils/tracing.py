"""The port's one recorder: spans and counters at its layer boundaries.

Tracing is on exactly while a ``torch.profiler`` records
(``torch._C._autograd._profiler_enabled()``): the benchmark's traced runs
and the driver's ``--profile_dir`` turn it on, and nothing else does. Off,
:func:`span` makes that one check and returns a shared null context.

On, ``with span(name, id):`` records ``(name, id, parent, t0_ns, t1_ns)``
in memory: ``parent`` is the index of the enclosing open span (None at the
top), ``id`` the step number or frame index that the spans of one unit
share. It also opens a ``record_function`` range of the same name, so that
a chrome trace shows the program's phases above its kernels. Times come
from ``time.time_ns()``, the wall clock on which the profiler stamps its
host events; a span adds no device synchronisation. Spans nest on the
thread that drives the step (the autograd engine's device threads open
none).

:func:`count` adds to host counters; :func:`add_device` adds a device
tensor into a device scalar without a sync, read once by
:func:`device_counters` after the traced window. Callers record counters
only where :func:`enabled` holds.

Records, counters and device scalars belong to the latest session: the
first call under a profiler after :func:`span` found tracing off starts
one, clearing them and noting the launch counters' values
(:func:`session_launches` is the change since). A session keeps at most
:data:`MAX_RECORDS` spans; past that a span records nothing (the readers
then find fewer units than the harness and read nothing).

Every kernel wrapper with a ``.launches`` counter registers itself by
kernel name (:func:`register_launches`) when its module is imported;
:func:`launch_counts` reads them. A call that runs as phases which count
their own launches (the split backward) adds to its wrapper's
``.launches`` through :func:`count_split_call`, so that
:func:`launch_counts` leaves it out and counts each launch once.
"""

from __future__ import annotations

import contextlib
import time
from typing import Dict, List, NamedTuple, Optional

import torch

MAX_RECORDS = 1 << 20

_enabled = torch._C._autograd._profiler_enabled


class Span(NamedTuple):
    name: str
    id: Optional[int]
    parent: Optional[int]  # index of the enclosing span in the same list
    t0_ns: int
    t1_ns: Optional[int]  # None while open


class _Recorder:
    def __init__(self):
        self.armed = True  # the next call under a profiler starts a session
        self.records: List[list] = []
        self.stack: List[Optional[int]] = []
        self.counts: Dict[str, int] = {}
        self.device: Dict[str, torch.Tensor] = {}
        self.launch_base: Dict[str, int] = {}

    def start_session(self):
        self.armed = False
        self.records, self.stack = [], []
        self.counts, self.device = {}, {}
        self.launch_base = launch_counts()


_REC = _Recorder()
_NULL = contextlib.nullcontext()
_LAUNCHES: Dict[str, object] = {}


def enabled() -> bool:
    """Whether tracing is on: a torch profiler is recording. (Only
    :func:`span` notes that it is off, since the autograd engine's threads
    call this too.)"""
    if _enabled():
        if _REC.armed:
            _REC.start_session()
        return True
    return False


class _Open:
    __slots__ = ("name", "id", "rf", "rec")

    def __init__(self, name: str, id: Optional[int]):
        self.name, self.id = name, id

    def __enter__(self):
        # The span encloses its record_function range, whose entry and exit
        # cost tens of microseconds under the profiler.
        r = _REC
        self.rec = [self.name, self.id, r.stack[-1] if r.stack else None,
                    time.time_ns(), None]
        r.stack.append(len(r.records))
        r.records.append(self.rec)
        self.rf = torch.autograd.profiler.record_function(self.name)
        self.rf.__enter__()
        return self

    def __exit__(self, *exc):
        self.rf.__exit__(*exc)
        if _REC.stack:
            _REC.stack.pop()
        self.rec[4] = time.time_ns()
        return False


def span(name: str, id: Optional[int] = None):
    """A span of the program's host timeline while tracing is on; a shared
    null context otherwise."""
    if not _enabled():
        _REC.armed = True
        return _NULL
    if _REC.armed:
        _REC.start_session()
    if len(_REC.records) >= MAX_RECORDS:
        return _NULL
    return _Open(name, id)


def count(name: str, n: int = 1) -> None:
    """Add ``n`` to host counter ``name``."""
    enabled()
    _REC.counts[name] = _REC.counts.get(name, 0) + int(n)


def add_device(name: str, value: torch.Tensor) -> None:
    """Add ``value`` (a device scalar) into device scalar ``name``, with no
    synchronisation."""
    enabled()
    acc = _REC.device.get(name)
    if acc is None:
        _REC.device[name] = value.detach().clone()
    else:
        acc.add_(value.detach())


def records() -> List[Span]:
    """The session's spans, in the order they opened."""
    return [Span(*r) for r in _REC.records]


def counters() -> Dict[str, int]:
    """The session's host counters."""
    return dict(_REC.counts)


def device_counters() -> Dict[str, float]:
    """The session's device scalars, read to the host (a synchronisation)."""
    return {k: float(v) for k, v in _REC.device.items()}


def register_launches(name: str, wrapper):
    """Give kernel wrapper ``wrapper`` its ``launches`` counter, at zero,
    and list it under kernel ``name``."""
    wrapper.launches = 0
    wrapper.split_calls = 0
    _LAUNCHES[name] = wrapper
    return wrapper


def count_split_call(wrapper) -> None:
    """One call of ``wrapper`` that ran as phases counting their own
    launches: its ``launches`` counts the call, :func:`launch_counts` does
    not."""
    wrapper.launches += 1
    wrapper.split_calls += 1


def launch_wrappers() -> Dict[str, object]:
    """Every registered kernel wrapper, by kernel name (those of the kernel
    modules imported so far)."""
    return dict(_LAUNCHES)


def launch_counts() -> Dict[str, int]:
    """``{kernel: launches}`` of every registered wrapper."""
    return {k: w.launches - w.split_calls for k, w in _LAUNCHES.items()}


def session_launches() -> Dict[str, int]:
    """Each kernel's launches since the latest profiling session began."""
    base = _REC.launch_base
    return {k: n - base.get(k, 0) for k, n in launch_counts().items()}
