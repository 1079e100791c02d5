"""Find a cell's parts by name: ``BENCHMARK.json`` joins a configuration
(``configs/<config>.json``), a traffic mix (``traffic/<traffic>.json``),
per-layer metrics (``metrics/<metric>.py``) and the limits of its
correctness check (``limits/<workload>.json``); each is a file of its own,
so a later change adds a cell, a mix or a metric by adding files."""

from __future__ import annotations

import importlib.util
import json
from pathlib import Path
from typing import Dict, List

HERE = Path(__file__).resolve().parents[1]  # perfbench/
ROOT = HERE.parent  # the checkout


def load_benchmark(root: Path = ROOT) -> dict:
    return json.loads((Path(root) / "BENCHMARK.json").read_text())


def bench_dir(root: Path = ROOT) -> Path:
    """The directory that holds the benchmark's files: the one that holds
    its command's script."""
    return Path(root) / "perfbench"


def workload(bench: dict, name: str) -> dict:
    for w in bench["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError(f"no workload {name!r} in BENCHMARK.json")


def config(bench: dict, name: str, root: Path = ROOT) -> dict:
    for c in bench["configs"]:
        if c["name"] == name:
            out = json.loads((Path(root) / c["file"]).read_text())
            out["name"] = name
            return out
    raise KeyError(f"no configuration {name!r} in BENCHMARK.json")


def traffic(name: str, root: Path = ROOT) -> dict:
    return json.loads((bench_dir(root) / "traffic" / f"{name}.json").read_text())


def limits(name: str, root: Path = ROOT) -> Dict[str, float]:
    """The limit of each number compared in ``name``'s correctness check."""
    return json.loads((bench_dir(root) / "limits" / f"{name}.json").read_text())["limits"]


def metric_module(name: str, root: Path = ROOT):
    """The reader of per-layer metric ``name``: ``metrics/<name>.py``."""
    path = bench_dir(root) / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        "perfbench_metric_" + name.replace(".", "_").replace("-", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _applies(entry: dict, cell: str, reported: List[str]) -> bool:
    if "workloads" in entry:
        return cell in entry["workloads"]
    return entry.get("moves") is None or entry["moves"] in reported


def end_to_end(bench: dict, cell: str) -> List[dict]:
    return [m for m in bench["end_to_end"] if _applies(m, cell, [])]


def per_layer(bench: dict, cell: str) -> List[dict]:
    reported = [m["name"] for m in end_to_end(bench, cell)]
    return [m for m in bench["per_layer"] if _applies(m, cell, reported)]


# What the reference and the counts read; a configuration file states
# each, so that the program's defaults never stand in for a value.
REQUIRED = ("N_rand", "N_samples", "N_importance", "netdepth", "netwidth",
            "netdepth_fine", "netwidth_fine", "multires", "multires_views",
            "raw_noise_std", "no_ndc", "colmap_depth", "depth_loss",
            "depth_lambda", "depth_rays_prop", "weighted_loss",
            "semantic_loss", "semantic_lambda", "num_classes", "cull_eps",
            "lrate", "lrate_decay", "i_print", "H", "W", "focal",
            "compute_dtype")


def plain(cfg: dict) -> dict:
    """A configuration as the reference and the counts read it: the nets'
    shapes, the encodings' widths and the class count made explicit."""
    out = dict(cfg)
    out.setdefault("skips", [4])
    out["e_p"] = 3 + 3 * 2 * cfg["multires"]
    out["e_v"] = 3 + 3 * 2 * cfg["multires_views"]
    out["num_classes"] = cfg["num_classes"] if cfg.get("semantic_loss") else 0
    out["nets"] = {
        "coarse": {"depth": cfg["netdepth"], "width": cfg["netwidth"],
                   "skips": out["skips"]},
        "fine": {"depth": cfg["netdepth_fine"], "width": cfg["netwidth_fine"],
                 "skips": out["skips"]}}
    missing = [k for k in REQUIRED if k not in cfg]
    if missing:
        raise KeyError(f"configuration {cfg.get('name')} lacks {missing}")
    return out
