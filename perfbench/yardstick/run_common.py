"""What the traffic drivers share: a run's inputs and outcome, the
benchmark's host spans and the profiler around the window."""

from __future__ import annotations

import contextlib
from typing import Dict, List, NamedTuple, Optional

import torch

from yardstick import trace as trace_mod


class RunSpec(NamedTuple):
    cell: str
    config: dict  # the configuration's file
    plain: dict  # the same, made explicit (yardstick.cell.plain)
    traffic: dict
    seed: int
    seconds: float
    trace: bool
    t_start: float  # the process's start, by the host clock
    device_type: str  # "cuda" on the card; "cpu" in the CPU tests


class Outcome(NamedTuple):
    e2e: Dict[str, float]
    numbers: Dict[str, float]  # what the correctness check compares
    attempted: int
    failed: int
    peak: int  # bytes, on the fullest card
    trace: Optional[trace_mod.Trace]  # rank 0's window
    rank_traces: List[Optional[dict]]  # each rank's trace summary
    counts: Dict[str, float]  # the window's work, for the metric readers
    plain: dict


def span(name: str):
    """A benchmark span on the host's timeline (``bench.<name>``)."""
    return torch.autograd.profiler.record_function(trace_mod.SPAN_PREFIX + name)


class _Profile:
    def __init__(self, prof):
        self.prof = prof

    def reduce(self) -> trace_mod.Trace:
        return trace_mod.from_profile(self.prof)


@contextlib.contextmanager
def profiler(on: bool, device):
    """``torch.profiler`` over the window when ``on`` (CPU and device
    activities); otherwise nothing."""
    if not on:
        yield None
        return
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if device.type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    with profile(activities=acts, acc_events=True) as prof:
        yield _Profile(prof)
