"""Build a checkout-like directory for the harness's CPU tests: a copy of
``perfbench/`` with the tiny cells of ``tests/tiny`` in place of the
benchmark's, and run cells there on the CPU."""

from __future__ import annotations

import json
import shutil
import sys
from pathlib import Path

PERFBENCH = Path(__file__).resolve().parents[1]
REPO = PERFBENCH.parent
TINY = PERFBENCH / "tests" / "tiny"

for p in (str(PERFBENCH), str(REPO)):
    if p not in sys.path:
        sys.path.insert(0, p)


from yardstick.train import rank_main as _REAL_RANK_MAIN  # noqa: E402


def tiny_root(tmp: Path, limits=None) -> Path:
    """``tmp`` as a checkout: ``BENCHMARK.json`` of the tiny cells and a copy
    of ``perfbench/`` holding their traffic and limits. ``limits`` maps a
    cell to limits that replace its file's."""
    shutil.copytree(PERFBENCH, tmp / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(TINY / "BENCHMARK.json", tmp / "BENCHMARK.json")
    shutil.copy(TINY / "train-dp2.json", tmp / "perfbench" / "traffic")
    for f in TINY.glob("*.limits.json"):
        name = f.name[:-len(".limits.json")]
        data = json.loads(f.read_text())
        if limits and name in limits:
            data["limits"] = limits[name]
        (tmp / "perfbench" / "limits" / f"{name}.json").write_text(json.dumps(data))
    return tmp


def run_cell(root: Path, name: str, seed: int = 123456789012, seconds: float = 0.5,
             trace: int = 0):
    """The result line of one tiny cell, run on the CPU."""
    import run

    return run.execute(["--workload", name, "--seed", str(seed), "--seconds",
                        str(seconds), "--trace", str(trace)], root=root,
                       device_type="cpu")


def rank_main_without_exchange(spec, device_type="cuda"):
    """A rank of the training driver with the program's gradient
    all-reduce made a no-op (a planted fault; module level, so that the
    spawned ranks can import it)."""
    import depth_lidar_nerf_tpu_torch.train.step as step

    real = step.all_reduce_grads
    step.all_reduce_grads = lambda params, mesh: None
    try:
        return _REAL_RANK_MAIN(spec, device_type)
    finally:
        step.all_reduce_grads = real


def spec_for(cfg, traffic, seed):
    from yardstick import cell, run_common

    return run_common.RunSpec("tiny", cfg, cell.plain(cfg), traffic, seed, 0.0,
                              False, 0.0, "cpu")
