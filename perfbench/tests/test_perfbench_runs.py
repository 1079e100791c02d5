"""Whole runs of the tiny cells on the CPU: the last line's schema, the
reference against the port's plain CPU path, and ``correct`` coming out
false under each fault a cell can have and under the control."""

import json
from pathlib import Path

import harness_helpers as h
import pytest
import torch

from yardstick import check, reference

TRAIN, SERVE, DP = "tiny_kitti.train", "tiny_rgb.serve", "tiny_kitti.train-dp2"


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return h.tiny_root(tmp_path_factory.mktemp("checkout"))


@pytest.mark.parametrize("cell", [TRAIN, SERVE])
@pytest.mark.parametrize("traced", [0, 1])
def test_last_line(root, cell, traced):
    res = h.run_cell(root, cell, seed=2**31 + 17, trace=traced)
    assert list(res)[:3] == ["correct", "attempted", "failed"]
    assert list(res)[-1] == "checks"
    assert set(res) <= {"correct", "attempted", "failed", "metrics", "device",
                        "breakdown", "checks"}
    assert res["correct"] is True and res["failed"] == 0 and res["attempted"] > 0
    dev = res["device"]
    assert {"platform", "kind", "count", "memory_peak_bytes"} <= set(dev)
    for c in res["checks"].values():
        assert set(c) == {"value", "limit"} and c["value"] <= c["limit"]
    if traced:
        assert {"busy_s", "window_s"} <= set(dev)
        assert set(res["breakdown"]) == {"device_ops", "idle_gaps"}
        assert all(len(v) <= 10 for v in res["breakdown"].values())
    else:
        assert "setup_s" in res["metrics"]
        assert all(v["value"] > 0 for v in res["metrics"].values())
    json.dumps(res)


def test_same_seed_same_numbers(root):
    a = h.run_cell(root, TRAIN, seed=99)
    b = h.run_cell(root, TRAIN, seed=99)
    assert a["checks"] == b["checks"]


def _faulty(monkeypatch, fault):
    import depth_lidar_nerf_tpu_torch.render.renderer as rr
    import depth_lidar_nerf_tpu_torch.train.losses as losses
    import depth_lidar_nerf_tpu_torch.train.state as st

    if fault == "unchanged":
        monkeypatch.setattr(st.OptaxAdam, "step", lambda self, closure=None: None)
    elif fault == "half_batch":
        for name in ("img2mse", "semantic_cross_entropy"):
            fn = getattr(losses, name)
            monkeypatch.setattr(losses, name, lambda a, b, _f=fn: _f(
                a[:a.shape[0] // 2], b[:b.shape[0] // 2]))
        dl = losses.depth_loss
        monkeypatch.setattr(losses, "depth_loss", lambda r, t, w=None, **kw: dl(
            r[:r.shape[0] // 2], t[:t.shape[0] // 2],
            None if w is None else w[:w.shape[0] // 2], **kw))
    elif fault == "no_depth":
        monkeypatch.setattr(losses, "depth_loss", lambda r, t, w=None, **kw: r.sum() * 0.0)
    elif fault == "depth_shifted":
        dl = losses.depth_loss
        monkeypatch.setattr(losses, "depth_loss", lambda r, t, w=None, **kw: dl(
            r, t.roll(-1), None if w is None else w.roll(-1), **kw))
    elif fault in ("altered", "half_frame"):
        real = rr.render_rays

        def bad(*a, **kw):
            out = dict(real(*a, **kw))
            rgb = out["rgb_map"].clone()
            n = rgb.shape[0]
            if fault == "altered":
                rgb[: max(1, n // 10)] += 0.05
            else:
                rgb[n // 2:] = 0.0
            out["rgb_map"] = rgb
            return out

        monkeypatch.setattr(rr, "render_rays", bad)


@pytest.mark.parametrize("cell,fault", [(TRAIN, "unchanged"), (TRAIN, "half_batch"),
                                        (TRAIN, "no_depth"), (TRAIN, "depth_shifted"),
                                        (SERVE, "altered"), (SERVE, "half_frame")])
def test_fault_is_not_correct(root, monkeypatch, cell, fault):
    _faulty(monkeypatch, fault)
    res = h.run_cell(root, cell, seed=4242)
    assert res["correct"] is False
    assert any(c["value"] > c["limit"] for c in res["checks"].values())
    if fault == "no_depth":
        assert res["checks"]["depth1_gap"]["value"] == 1.0


def test_exchange_left_out_is_not_correct(root, monkeypatch):
    """The gradient all-reduce skipped on every rank of the two-rank cell."""
    import yardstick.train as tr

    monkeypatch.setattr(tr, "rank_main", h.rank_main_without_exchange)
    res = h.run_cell(root, DP, seed=4243, seconds=0.3)
    assert res["correct"] is False
    assert res["checks"]["grad_gap"]["value"] > res["checks"]["grad_gap"]["limit"]


def test_two_ranks_sound(root):
    res = h.run_cell(root, DP, seed=4244, seconds=0.3)
    assert res["correct"] is True and res["device"]["count"] == 2


@pytest.mark.parametrize("seed", [7, 2**31 + 3])
def test_control_fails_the_limits(root, seed):
    """The reference in the program's place, its products' operands rounded
    to float8 e4m3, reads over the tiny cell's limits; the sound program
    reads under them."""
    import run  # noqa: F401  (puts the checkout's paths in place)
    from yardstick import cell, train

    b = json.loads((root / "BENCHMARK.json").read_text())
    cfg = cell.config(b, "tiny_kitti", root)
    tr_ = cell.traffic("train", root)
    spec = h.spec_for(cfg, tr_, seed)
    sess = train.Session(spec, torch.device("cpu"))
    prog = sess.first_steps(3)
    kw = dict(n_steps=3, block=tr_["check_block_rays"])
    ref = reference.train_steps(sess.plain, sess.data, sess.init, seed, **kw)
    ctl = reference.train_steps(sess.plain, sess.data, sess.init, seed,
                                mm_dtype=reference.fp8(), **kw)
    lim = cell.limits(TRAIN, root)
    assert check.judge(check.train_numbers(prog, ref), lim)[0]
    assert not check.judge(check.train_numbers(ctl, ref), lim)[0]
