"""Run one cell of the benchmark and print its result as the last line.

    python3 perfbench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

The cell (``BENCHMARK.json``'s ``workloads``) names a configuration and a
traffic mix, each a file under ``perfbench/``; the mix's ``kind`` names its
driver (``yardstick/<kind>.py``). A run builds its inputs and weights from
``--seed``, warms up the cell's own shapes (set-up), measures for
``--seconds``, and then checks what the timed path produced against the
plain float32 reference. With ``--trace 0`` the result carries the cell's
end-to-end metrics; with ``--trace 1`` the window runs under
``torch.profiler`` and the result carries the per-layer metrics, the
device's busy and window seconds and a breakdown.

It exits non-zero and prints no result without a CUDA device (or with
fewer than the cell asks for), and if JAX or the JAX package is loaded
once the window has closed. The program's kernels build into the
checkout's ``build/`` on its first run there.
"""

from __future__ import annotations

import time

T_START = time.time()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

HERE = Path(__file__).resolve().parent
FORBIDDEN = ("jax", "jaxlib", "flax", "depth_lidar_nerf_tpu")


def cache_dirs(root: Path) -> dict:
    """Every build and kernel cache at a fixed path inside the checkout."""
    b = root / "build"
    return {"TORCH_EXTENSIONS_DIR": str(b / "torch_extensions"),
            "TRITON_CACHE_DIR": str(b / "triton_cache"),
            "CUDA_CACHE_PATH": str(b / "cuda_cache"),
            "TORCHINDUCTOR_CACHE_DIR": str(b / "inductor_cache"),
            "USE_FLAX": "0"}


def loaded_forbidden():
    """Top-level modules of JAX or of the JAX package that are loaded,
    compared by whole name (the port's name begins with the package's)."""
    return sorted({m.split(".", 1)[0] for m in list(sys.modules)} & set(FORBIDDEN))


def parse(argv):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def power_limit() -> str | None:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True, timeout=30).stdout.strip().splitlines()
        return out[0] if out else None
    except (OSError, subprocess.SubprocessError):
        return None


def execute(argv, root: Path = HERE.parent, device_type: str = "cuda",
            t_start: float = T_START):
    """The run as a dict (the result line), or None where it must print no
    result. ``device_type="cpu"`` skips the look for a card (the CPU
    tests)."""
    sys.path.insert(0, str(HERE))
    sys.path.insert(0, str(root))
    for k, v in cache_dirs(root).items():
        os.environ[k] = v
    args = parse(argv)
    from yardstick import cell as cellmod

    bench = cellmod.load_benchmark(root)
    w = cellmod.workload(bench, args.workload)
    config = cellmod.config(bench, w["config"], root)
    traffic = cellmod.traffic(w["traffic"], root)
    limits = cellmod.limits(args.workload, root)

    import torch

    if device_type == "cuda" and (not torch.cuda.is_available()
                                  or torch.cuda.device_count() < w["chips"]):
        print(f"needs {w['chips']} CUDA device(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return None
    torch.set_num_threads(min(4, torch.get_num_threads()))
    import importlib

    from yardstick import check, run_common

    spec = run_common.RunSpec(args.workload, config, cellmod.plain(config),
                              traffic, args.seed, args.seconds,
                              bool(args.trace), t_start, device_type)
    driver = importlib.import_module(f"yardstick.{traffic['kind']}")
    out = driver.run(spec)
    bad = loaded_forbidden()
    if bad:
        print(f"loaded in the reporting process: {bad}", file=sys.stderr)
        return None
    correct, checks = check.judge(out.numbers, limits)
    if out.failed:
        correct = False
    device = {"platform": "gpu" if device_type == "cuda" else "cpu",
              "kind": (torch.cuda.get_device_name(0) if device_type == "cuda"
                       else "cpu"),
              "count": w["chips"], "memory_peak_bytes": int(out.peak)}
    if device_type == "cuda":
        device["power_limit"] = power_limit()
    res = {"correct": bool(correct), "attempted": int(out.attempted),
           "failed": int(out.failed)}
    if args.trace:
        ranks = [r for r in out.rank_traces if r]
        device["busy_s"] = sum(r["busy_s"] for r in ranks) / len(ranks)
        device["window_s"] = out.trace.window_s
        metrics = {}
        ctx = {"trace": out.trace, "ranks": ranks, "counts": out.counts,
               "plain": out.plain, "cell": args.workload}
        for m in cellmod.per_layer(bench, args.workload):
            v = cellmod.metric_module(m["name"], root).read(ctx)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
        res["metrics"] = metrics
        res["breakdown"] = {"device_ops": run_common.trace_mod.top_ops(out.trace),
                            "idle_gaps": run_common.trace_mod.idle_gaps(out.trace)}
    else:
        res["metrics"] = {m["name"]: {"value": out.e2e[m["name"]], "unit": m["unit"]}
                          for m in cellmod.end_to_end(bench, args.workload)}
    res["device"] = device
    res["checks"] = checks
    return res


def main(argv=None) -> int:
    res = execute(sys.argv[1:] if argv is None else argv)
    if res is None:
        return 2
    for name, c in res["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(res), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
