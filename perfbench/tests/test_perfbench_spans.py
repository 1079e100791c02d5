"""The program's spans on the window's clock (``yardstick.spans``): exact
attribution on a synthetic trace, and every reader of the spans and
counters on a traced tiny run on the CPU, where the trace's device
intervals are planted (the CPU has none)."""

import json

import harness_helpers as h
import pytest

from yardstick import spans, trace

READERS = {  # reader -> the tiny cells it is listed for
    "step_host_ms.train": ["tiny_kitti.train", "tiny_rgb.train"],
    "idle_ms_forward.train": ["tiny_kitti.train", "tiny_rgb.train"],
    "idle_ms_backward.train": ["tiny_kitti.train", "tiny_rgb.train"],
    "idle_ms_optimizer.train": ["tiny_kitti.train", "tiny_rgb.train"],
    "launches_per_step.train": ["tiny_kitti.train", "tiny_rgb.train"],
    "culled_live_share.train": ["tiny_rgb.train"],
    "idle_ms_render.serve": ["tiny_rgb.serve"],
    "idle_ms_to_host.serve": ["tiny_rgb.serve"],
}


class _Recorder:
    """A stand-in for the program's recorder, holding given spans."""

    def __init__(self, recs):
        self.recs = recs

    def records(self):
        return self.recs


def _span(name, id, parent, t0_s, t1_s, clock_s):
    from depth_lidar_nerf_tpu_torch.utils.tracing import Span

    return Span(name, id, parent, round((t0_s + clock_s) * 1e9),
                round((t1_s + clock_s) * 1e9))


def test_synthetic_attribution(monkeypatch):
    """Two steps 0-10 and 12-22 ms (the program's clock 1000 s ahead of the
    window's), each with draw, render, loss, backward and optimizer phases
    of 2 ms and a tile span nested in render; the device idles 1-3, 5-6,
    9-13 and 20-21 ms."""
    C = 1000.0
    recs = []
    for u, s0 in enumerate((0.0, 0.012)):
        root = len(recs)
        recs.append(_span("step", u + 1, None, s0, s0 + 0.010, C))
        for p, name in enumerate(("step.draw", "step.render", "step.loss",
                                  "step.backward", "step.optimizer")):
            k = len(recs)
            recs.append(_span(name, None, root, s0 + 0.002 * p,
                              s0 + 0.002 * (p + 1), C))
            if name == "step.render":
                recs.append(_span("frame.tile", 0, k, s0 + 0.0025,
                                  s0 + 0.0035, C))
    monkeypatch.setattr(spans, "recorder", lambda: _Recorder(recs))
    dev = [("k", a, b) for a, b in ((0.0, 0.001), (0.003, 0.005),
                                    (0.006, 0.009), (0.013, 0.020),
                                    (0.021, 0.023))]
    bench = [("bench.step", 0.0, 0.0101), ("bench.step", 0.012, 0.0221)]
    tr = trace.Trace(dev, bench, 0.0, 0.023)
    s = spans.split({"trace": tr}, "step")
    assert s.units == 2
    assert s.spread_s == pytest.approx(0.0, abs=1e-9)
    ms = {k: 1e3 * v for k, v in s.idle_s.items()}
    # 1-3 ms: draw 1-2, render 2-3 (its tile starts at 2.5); 5-6: loss;
    # 9-10: optimizer, 10-12: outside, 12-13: draw; 20-21: optimizer.
    want = {"step.draw": 2.0, "step.render": 1.0, "step.loss": 1.0,
            "step.optimizer": 2.0, spans.OUTSIDE: 2.0}
    for k in set(ms) | set(want):  # the clocks' rounding leaves slivers
        assert ms.get(k, 0.0) == pytest.approx(want.get(k, 0.0), abs=1e-6), k
    assert 1e3 * s.idle_total_s == pytest.approx(8.0, abs=1e-6)
    assert s.unit_host_s == pytest.approx([0.010, 0.010], abs=1e-9)
    assert spans.idle_ms({"trace": tr}, "step", ("step.draw", "step.render")) \
        == pytest.approx(1.5, abs=1e-6)


def test_synthetic_spread_and_missing(monkeypatch):
    """Offsets of 0, 0.05 and 0.02 ms: origin 0.02 ms, quartiles 0 and
    0.05 ms, the largest distance 0.03 ms; a program with fewer units than
    the harness's spans, or none, reads nothing."""
    recs = [_span("frame", k, None, t, t + 0.004, 0.0)
            for k, t in enumerate((0.0, 0.01005, 0.02002))]
    monkeypatch.setattr(spans, "recorder", lambda: _Recorder(recs))
    bench = [("bench.render_path", t, t + 0.005) for t in (0.0, 0.01, 0.02)]
    tr = trace.Trace([("k", 0.0, 0.001)], bench, 0.0, 0.03)
    s = spans.split({"trace": tr}, "frame")
    assert s.spread_s == pytest.approx(5e-5, abs=1e-9)
    assert s.offset_max_s == pytest.approx(3e-5, abs=1e-9)
    tr2 = trace.Trace([("k", 0.0, 0.001)], bench + [bench[-1]], 0.0, 0.03)
    assert spans.split({"trace": tr2}, "frame") is None
    monkeypatch.setattr(spans, "recorder", lambda: None)
    tr3 = trace.Trace([("k", 0.0, 0.001)], bench, 0.0, 0.03)
    assert spans.split({"trace": tr3}, "frame") is None


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    """The tiny checkout with the readers listed, and an RGB training cell
    at width 128, which the kernels' routes (here their plain twins) cover,
    so that its coarse pass takes the culled backward."""
    r = h.tiny_root(tmp_path_factory.mktemp("checkout"))
    b = json.loads((r / "BENCHMARK.json").read_text())
    cfg = json.loads((h.TINY / "tiny_rgb.json").read_text())
    cfg.update(netwidth=128, netwidth_fine=128)
    (r / "tiny_rgb128.json").write_text(json.dumps(cfg))
    b["configs"].append({"name": "tiny_rgb128", "source": "x",
                         "file": "tiny_rgb128.json", "reduced": [],
                         "why": "x"})
    b["workloads"].append({"name": "tiny_rgb.train", "config": "tiny_rgb128",
                           "traffic": "train", "chips": 1, "why": "x"})
    for m in b["end_to_end"]:
        if m["name"] == "train_rays_per_s":
            m["workloads"].append("tiny_rgb.train")
    for name, cells in READERS.items():
        b["per_layer"].append({
            "name": name, "unit": "ms", "better": "lower",
            "source": "device_trace", "layer": "x",
            "moves": "frames_per_s" if name.endswith(".serve")
            else "train_rays_per_s", "workloads": cells})
    (r / "BENCHMARK.json").write_text(json.dumps(b))
    lim = json.loads((r / "perfbench" / "limits" / "tiny_kitti.train.json")
                     .read_text())
    (r / "perfbench" / "limits" / "tiny_rgb.train.json").write_text(
        json.dumps(lim))
    return r


def _planted(monkeypatch):
    """The trace's device busy over the middle of each harness unit span,
    so that the device idles at each unit's edges and between units."""
    real = trace.from_profile

    def with_device(prof, *a, **kw):
        tr = real(prof, *a, **kw)
        dev = sorted(("planted", a + 0.25 * (b - a), a + 0.75 * (b - a))
                     for n, a, b in tr.spans
                     if n in ("bench.step", "bench.render_path"))
        return tr._replace(device=dev)

    monkeypatch.setattr(trace, "from_profile", with_device)


@pytest.mark.parametrize("cell", ["tiny_kitti.train", "tiny_rgb.train",
                                  "tiny_rgb.serve"])
def test_readers_on_a_traced_run(root, monkeypatch, cell, capsys):
    _planted(monkeypatch)
    res = h.run_cell(root, cell, seed=2**31 + 29, seconds=0.5, trace=1)
    got = res["metrics"]
    for name, cells in READERS.items():
        if cell in cells:
            assert name in got, name
            assert got[name]["value"] >= 0.0, name
    # The split adds up to the window's idle time.
    line = [l for l in capsys.readouterr().err.splitlines()
            if l.startswith("spans ")][-1]
    rep = json.loads(line[len("spans "):])
    idle_ms = 1e3 * (res["device"]["window_s"] - res["device"]["busy_s"])
    total = rep["idle_ms_per_unit_total"] * rep["units"]
    assert total == pytest.approx(idle_ms, rel=1e-6)
    assert sum(rep["idle_ms_per_unit"].values()) * rep["units"] == \
        pytest.approx(idle_ms, rel=1e-6)
    assert rep["align_spread_ms"] < 5.0
    if cell != "tiny_rgb.serve":
        assert got["idle_ms_forward.train"]["value"] > 0.0
        assert got["launches_per_step.train"]["value"] == 0.0  # no card
    if cell == "tiny_rgb.train":
        assert 0.0 < got["culled_live_share.train"]["value"] <= 100.0
    if cell == "tiny_rgb.serve":
        assert got["idle_ms_render.serve"]["value"] > 0.0
