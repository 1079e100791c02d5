"""The harness finds each part of a cell by name, so that a cell, a mix or
a metric is added with files alone; BENCHMARK.json keeps the contract's
shape; nothing of the benchmark imports JAX or the JAX package."""

import ast
import json
import re
import shutil
from pathlib import Path

import harness_helpers as h
import pytest

from yardstick import cell

BENCH = json.loads((h.REPO / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
FORBIDDEN = {"jax", "jaxlib", "flax", "depth_lidar_nerf_tpu"}
PROGRAM = "depth_lidar_nerf_tpu_torch"


def _imports(path: Path):
    """Top-level names of every module ``path`` imports."""
    tree = ast.parse(path.read_text())
    out = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            out |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            out.add(node.module.split(".")[0])
        elif isinstance(node, ast.Call) and getattr(node.func, "attr", "") == "import_module":
            if node.args and isinstance(node.args[0], ast.Constant):
                out.add(str(node.args[0].value).split(".")[0])
    return out


@pytest.mark.parametrize("path", sorted(str(p.relative_to(h.PERFBENCH))
                                        for p in h.PERFBENCH.rglob("*.py")))
def test_no_jax_import(path):
    names = _imports(h.PERFBENCH / path)
    assert not names & FORBIDDEN, f"{path} imports {names & FORBIDDEN}"


@pytest.mark.parametrize("mod", ["reference", "scene", "counts", "check",
                                 "trace", "cell"])
def test_yardstick_takes_nothing_of_the_program(mod):
    names = _imports(h.PERFBENCH / "yardstick" / f"{mod}.py")
    assert PROGRAM not in names


def test_whole_name_comparison():
    import run

    assert PROGRAM.startswith("depth_lidar_nerf_tpu")
    import sys

    had = set(sys.modules)
    import depth_lidar_nerf_tpu_torch  # noqa: F401

    assert "depth_lidar_nerf_tpu" not in run.loaded_forbidden()
    assert not (had - set(sys.modules))


@pytest.mark.parametrize("w", [w["name"] for w in BENCH["workloads"]])
def test_cell_parts_found_by_name(w):
    wl = cell.workload(BENCH, w)
    cfg = cell.config(BENCH, wl["config"], h.REPO)
    plain = cell.plain(cfg)
    tr = cell.traffic(wl["traffic"], h.REPO)
    assert tr["kind"] in ("train", "serve")
    assert (h.PERFBENCH / "yardstick" / f"{tr['kind']}.py").exists()
    lim = cell.limits(w, h.REPO)
    assert lim and all(v > 0 for v in lim.values())
    e2e = [m["name"] for m in cell.end_to_end(BENCH, w)]
    assert "setup_s" in e2e and len(e2e) >= 2
    per = cell.per_layer(BENCH, w)
    assert per
    for m in per:
        assert m["moves"] in e2e
        assert callable(cell.metric_module(m["name"], h.REPO).read)
    assert plain["nets"]["fine"]["width"] == cfg["netwidth_fine"]


def test_contract_shape():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert 1 <= BENCH["run_seconds"] <= 51
    names = [x["name"] for k in ("configs", "workloads", "end_to_end", "per_layer")
             for x in BENCH[k]]
    assert all(NAME.match(n) for n in names)
    for k in ("configs", "workloads"):
        assert len({x["name"] for x in BENCH[k]}) == len(BENCH[k])
    metrics = [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]
    assert len(set(metrics)) == len(metrics)
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("perfbench/")
        assert not any(k.endswith(("_dim", "_rank")) or "width" in k
                       for k in c["reduced"])
    four = [w for w in BENCH["workloads"] if w["chips"] == 4]
    assert len(four) <= max(1, len(BENCH["workloads"]) // 4)
    for m in BENCH["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    assert any(m["name"] == "setup_s" for m in BENCH["end_to_end"])
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert re.match(r"^[A-Za-z0-9_/%.-]{1,16}$", m["unit"])
        assert m["better"] in ("lower", "higher")
    for x in BENCH["workloads"] + BENCH["configs"]:
        assert 1 <= len(x["why"]) <= 200 and "\n" not in x["why"]
    assert len((h.REPO / "BENCHMARK.json").read_bytes()) <= 64 * 1024


def test_new_files_are_found(tmp_path):
    """A metric, a mix and a configuration dropped in as files, with their
    BENCHMARK.json entries, are found and read without an edit."""
    root = h.tiny_root(tmp_path)
    pb = root / "perfbench"
    (pb / "metrics" / "window_s.train.py").write_text(
        'def read(ctx):\n    return ctx["trace"].window_s\n')
    shutil.copy(pb / "traffic" / "train.json", pb / "traffic" / "train-long.json")
    shutil.copy(pb / "tests" / "tiny" / "tiny_kitti.json", pb / "configs" / "tiny2.json")
    shutil.copy(pb / "limits" / "tiny_kitti.train.json", pb / "limits" / "tiny2.train-long.json")
    b = json.loads((root / "BENCHMARK.json").read_text())
    b["configs"].append({"name": "tiny2", "source": "x", "file": "perfbench/configs/tiny2.json",
                         "reduced": [], "why": "x"})
    b["workloads"].append({"name": "tiny2.train-long", "config": "tiny2",
                           "traffic": "train-long", "chips": 1, "why": "x"})
    for m in b["end_to_end"]:
        if m["name"] == "train_rays_per_s":
            m["workloads"].append("tiny2.train-long")
    b["per_layer"].append({"name": "window_s.train", "unit": "s", "better": "lower",
                           "source": "device_trace", "layer": "device",
                           "moves": "train_rays_per_s",
                           "workloads": ["tiny2.train-long"]})
    (root / "BENCHMARK.json").write_text(json.dumps(b))
    res = h.run_cell(root, "tiny2.train-long", seconds=0.3, trace=1)
    assert res["correct"]
    assert res["metrics"]["window_s.train"]["value"] > 0
