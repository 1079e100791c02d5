"""The benchmark's patch cell on the CPU at a small size: the program's
patch step against the plain patch reference (``perfbench/yardstick/
reference_patch.py``) on seeded random weights, VGG19 in bfloat16 caught
by that comparison, the window on whole periods of the loss schedule, and
the patch readers fed a synthetic trace.

The small size: W=32 MLPs (coarse D=2, fine D=6), 16+16 samples, a 16x32
frame whose whole is the crop, a 4x8 grad leg, VGG19 at its published
widths to ``conv5_4``; the program in float32, so that both sides compute
the same float32 mathematics in another order."""

import json
import shutil
import sys
from pathlib import Path

import pytest
import torch

REPO = Path(__file__).resolve().parents[1]
PERFBENCH = REPO / "perfbench"
for _p in (str(PERFBENCH), str(REPO)):
    if _p not in sys.path:
        sys.path.insert(0, _p)

from yardstick import (cell, check_patch, counts_patch, patch_trace,  # noqa: E402
                       reference_patch, run_common, trace, train_patch)

CELL = "tiny_full.train-patch"
FAULTS = ("no_feature", "no_feature0", "no_smooth", "grad_shifted", "half_batch")
TAPS = ["conv1_2", "conv2_2", "conv3_4", "conv4_4", "conv5_4"]
TINY = {
    "source": "tiny widths of kitti360_full, for the CPU tests",
    "dataset_type": "llff", "H": 16, "W": 32, "focal": 20.0, "n_train_views": 3,
    "N_rand": 64, "N_samples": 16, "N_importance": 16, "use_viewdirs": True,
    "raw_noise_std": 1.0, "chunk": 256, "netchunk": 4096, "netdepth": 2,
    "netwidth": 32, "netdepth_fine": 6, "netwidth_fine": 32, "skips": [4],
    "multires": 10, "multires_views": 4, "no_ndc": False, "colmap_depth": True,
    "depth_loss": True, "depth_lambda": 0.01, "depth_rays_prop": 0.5,
    "weighted_loss": False, "lidar_points_per_view": 40, "semantic_loss": True,
    "semantic_lambda": 0.01, "num_classes": 5, "lrate": 0.0005,
    "lrate_decay": 250, "i_print": 100, "compute_dtype": "float32",
    "cull_eps": 0.0001, "depth_inverse_loss": True,
    "depth_inverse_loss_every_n": 10, "depth_inverse_lambda": 0.01,
    "feature_loss": True, "feature_loss_type": "vgg", "vgg_layers": TAPS,
    "vgg_layer_weights": [0.1, 0.1, 1, 1, 1], "vgg_loss_type": "l1",
    "feature_start_iteration": 1, "feature_loss_every_n": 10,
    "feature_lambda": 0.01, "nH": 16, "nW": 32, "gradH": 4, "gradW": 8,
    "datadir": "/nonexistent", "reduced": []}
TRAFFIC = {"kind": "train_patch", "why": "x", "period": 10, "checked_steps": 10,
           "warm_steps": 10, "check_block_rays": 64}
# Float32 on both sides in another order: the sound gaps are round-off,
# 1e-6 to 1e-5 at this size; the faults read 1e-2 and up.
LIMITS = {f"loss{i}_gap": 1e-4 for i in range(2, 11)}
# The update after step 10 carries ten Adam steps, which turn round-off in
# near-zero gradient entries into whole updates: ~1e-4.
LIMITS.update(depth1_gap=1e-4, grad_gap=1e-4, update_gap=1e-3, grad_diff=1e-4,
              grad1_diff=1e-4, feature_gap=1e-4, feature0_gap=1e-4, inv_gap=1e-4,
              vgg_gap=1e-4)


def _spec(seed, cfg=TINY):
    cfg = dict(cfg, name="tiny_full")
    return run_common.RunSpec(CELL, cfg, cell.plain(cfg), TRAFFIC, seed, 0.0,
                              False, 0.0, "cpu")


@pytest.fixture(scope="module")
def readings():
    """The program's checked steps and the reference's, and the
    reference's with VGG19 in bfloat16 and with each fault, on one seed;
    the program's last step taken again from the reference's state."""
    seed = 2**31 + 29
    sess = train_patch.PatchSession(_spec(seed), torch.device("cpu"))
    prog = sess.first_steps(TRAFFIC["checked_steps"])
    variants = {"reference": {}, "vgg_bf16": {"vgg_dtype": torch.bfloat16}}
    variants.update({f: {"fault": f} for f in FAULTS})
    # The variants that change only the last step resume from the shared
    # steps before it; every side takes that step at the reference's state.
    refs, before = reference_patch.train_steps(
        sess.plain, sess.data, sess.init, sess.vgg, seed, 10, 64, sess.ng_tile,
        variants)
    prog = sess.step_at(prog, before, 10)
    return prog, refs, sess.vgg


def test_patch_step_matches_the_reference(readings):
    """Every loss, each patch term and each leaf's gradient of the patch
    step agree with the reference within float32 round-off."""
    prog, refs, vgg = readings
    ref = refs["reference"]
    assert set(prog.patch) == set(reference_patch.PATCH_TERMS)
    for a, b in zip(prog.readings.losses, ref.readings.losses):
        # A step's loss sums a few thousand float32 terms in another order.
        assert abs(a - b) <= 1e-5 * abs(b)
    for k in reference_patch.PATCH_TERMS:
        # VGG19's sixteen convolutions accumulate in another order on the
        # two sides (mkldnn against the reference's own F.conv2d calls).
        assert abs(prog.patch[k] - ref.patch[k]) <= 1e-5 * abs(ref.patch[k]), k
    med = sorted(ref.readings.grad_norms.values())[len(ref.readings.grad_norms) // 2]
    for k, g in ref.readings.grads.items():
        # Each leaf's gradient, both sides at the reference's parameters
        # before step 10, against the larger of its norm and the median
        # leaf's: float32 sums of a few thousand rays' terms in another
        # order, and VGG19's input gradient through sixteen convolutions.
        d = float(torch.linalg.norm(prog.readings.grads[k] - g))
        assert d <= 1e-4 * max(ref.readings.grad_norms[k], med), k
    nums = check_patch.numbers(prog, ref, vgg, TAPS)
    assert all(nums[k] <= v for k, v in LIMITS.items()), nums


def test_vgg19_in_bfloat16_fails_the_comparison(readings):
    """VGG19's operands rounded to bfloat16 move its taps (``vgg_gap``, read
    on the same inputs) and the content loss past the limits that the
    program meets."""
    _, refs, vgg = readings
    nums = check_patch.numbers(refs["vgg_bf16"], refs["reference"], vgg, TAPS)
    over = [k for k, v in LIMITS.items() if nums[k] > v]
    assert {"vgg_gap", "feature_gap", "feature0_gap"} <= set(over), nums


@pytest.mark.parametrize("fault", FAULTS)
def test_planted_fault_fails(readings, fault):
    """Each planted fault of the patch terms, and half the base batch,
    reads over a limit."""
    _, refs, vgg = readings
    nums = check_patch.numbers(refs[fault], refs["reference"], vgg, TAPS)
    assert any(nums[k] > v for k, v in LIMITS.items()), nums


def _tiny_root(tmp: Path) -> Path:
    shutil.copytree(PERFBENCH, tmp / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    pb = tmp / "perfbench"
    (pb / "configs" / "tiny_full.json").write_text(json.dumps(TINY))
    (pb / "traffic" / "tiny-patch.json").write_text(json.dumps(TRAFFIC))
    (pb / "limits" / f"{CELL}.json").write_text(json.dumps({"limits": LIMITS}))
    per = ["mfu.train_patch", "patch_host_ms.train_patch", "idle_ms_patch.train_patch",
           "vgg19_roofline.train_patch", "fused_nerf_fwd_sem_ng_roofline"]
    bench = {"command": ["python3", "perfbench/run.py"], "paths": ["perfbench"],
             "run_seconds": 1,
             "configs": [{"name": "tiny_full", "source": "x",
                          "file": "perfbench/configs/tiny_full.json",
                          "reduced": [], "why": "x"}],
             "workloads": [{"name": CELL, "config": "tiny_full",
                            "traffic": "tiny-patch", "chips": 1, "why": "x"}],
             "end_to_end": [{"name": "train_rays_per_s", "unit": "rays/s",
                             "better": "higher", "bound": 0.05,
                             "source": "host_clock"},
                            {"name": "setup_s", "unit": "s", "better": "lower",
                             "bound": 0.25, "source": "host_clock"}],
             "per_layer": [{"name": n, "unit": "%", "better": "higher",
                            "source": "host_clock", "layer": "x",
                            "moves": "train_rays_per_s"} for n in per]}
    (tmp / "BENCHMARK.json").write_text(json.dumps(bench))
    return tmp


def test_window_holds_whole_periods(tmp_path, monkeypatch):
    """The window opens after a step that is a multiple of the period and
    closes on one, so it holds whole periods; the run is correct and its
    traced line reads the host-clock patch metrics."""
    root = _tiny_root(tmp_path)
    import run

    seen = []
    real_step, real_span = train_patch.PatchSession.step, train_patch.span

    def step(self):
        m = real_step(self)
        seen.append(self.i)
        return m

    def span(name):
        if name == "window":
            seen.append("open")
        return real_span(name)

    monkeypatch.setattr(train_patch.PatchSession, "step", step)
    # This test process imports JAX for other tests; a run itself does not.
    monkeypatch.setattr(run, "loaded_forbidden", lambda: [])
    monkeypatch.setattr(train_patch, "span", span)
    res = run.execute(["--workload", CELL, "--seed", str(2**31 + 5), "--seconds",
                       "0.2", "--trace", "1"], root=root, device_type="cpu")
    assert res["correct"] is True, res["checks"]
    k = seen.index("open")
    assert seen[k - 1] % 10 == 0 and seen[-1] % 10 == 0
    assert res["attempted"] == seen[-1] - seen[k - 1] and res["attempted"] % 10 == 0
    assert res["metrics"]["mfu.train_patch"]["value"] > 0
    assert res["metrics"]["patch_host_ms.train_patch"]["value"] > 0


def test_patch_readers_on_a_synthetic_trace():
    """Two patch steps of a synthetic trace: the device time launched under
    ``patch.feature`` and inside the convolution backwards makes VGG19's
    roofline; the idle time under the patch spans, ``idle_ms_patch``;
    kernel 6 under ``patch.ng``, its roofline."""
    import importlib.util

    def reader(name):
        spec = importlib.util.spec_from_file_location(
            "m_" + name.replace(".", "_"), PERFBENCH / "metrics" / f"{name}.py")
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        return mod.read

    ranges = [("patch.ng", 0.00, 0.02), ("patch.feature", 0.10, 0.11),
              ("aten::convolution_backward", 0.20, 0.21),
              ("patch.ng", 1.00, 1.02), ("patch.feature", 1.10, 1.11),
              ("aten::convolution_backward", 1.20, 1.21)]
    launches, device = {}, []
    for k, (host, a, b, name) in enumerate([
            (0.001, 0.005, 0.015, "fused_nerf_fwd_sem_kernel"),
            (0.101, 0.105, 0.108, "sm90_xmma_fprop"),
            (0.201, 0.205, 0.209, "sm90_xmma_dgrad"),
            (0.5, 0.5, 0.6, "fused_nerf_bwd_acts_kernel"),
            (1.001, 1.005, 1.015, "fused_nerf_fwd_sem_kernel"),
            (1.101, 1.105, 1.108, "sm90_xmma_fprop"),
            (1.201, 1.205, 1.209, "sm90_xmma_dgrad")]):
        launches[100 + k] = host
        device.append((name, 100 + k, 0, a, b))
    ev = patch_trace.Events(ranges, launches, {}, device)
    dev = patch_trace.attribute(ev)
    assert dev["matched"] == 7
    assert dev["patch.feature"] == pytest.approx(0.006)
    assert dev["vgg_bwd"] == pytest.approx(0.008)
    assert dev["kernel6_ng"] == pytest.approx(0.02)
    cfg = cell.plain(dict(TINY, name="tiny_full"))
    tr = trace.Trace([(n, a, b) for n, _, _, a, b in device], [], 0.0, 2.0)
    ctx = {"trace": tr, "plain": cfg,
           "counts": {"steps": 20, "patch_steps": 2, "n_rays": 64, "chips": 1,
                      "patch_device_s": dev,
                      "patch_spans": patch_trace.span_ranges(ev)}}
    bound = counts_patch.vgg_bound_s(TAPS, 16, 32)
    assert reader("vgg19_roofline.train_patch")(ctx) == pytest.approx(
        100 * bound * 2 / 0.014)
    # Under the patch spans the card idles 0.0-0.005 and 0.015-0.02 of each
    # no-grad leg and 0.10-0.105 and 0.108-0.11 of each feature span.
    assert reader("idle_ms_patch.train_patch")(ctx) == pytest.approx(
        1e3 * (0.005 + 0.005 + 0.005 + 0.002))
    assert reader("fused_nerf_fwd_sem_ng_roofline")(ctx) == pytest.approx(
        100 * counts_patch.ng_fwd_bound_s(cfg) * 2 / 0.02)
    # A program without the patch spans: nothing to read.
    ctx["counts"] = {"steps": 20, "patch_steps": 2, "n_rays": 64, "chips": 1,
                     "patch_device_s": patch_trace.attribute(
                         patch_trace.Events([], launches, {}, device)),
                     "patch_spans": []}
    for name in ("vgg19_roofline.train_patch", "idle_ms_patch.train_patch",
                 "fused_nerf_fwd_sem_ng_roofline"):
        assert reader(name)(ctx) is None
