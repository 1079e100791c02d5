"""The port's recorder (``utils/tracing.py``): nothing recorded with
tracing off; under a CPU ``torch.profiler`` the spans nest with their
parents and ids and agree with the profiler's own events; the launch
registry holds every wrapper with a ``.launches`` counter; a training step
and a served frame record their phases, and kernel 3's path its tile
counters. One card test: tracing adds no device synchronisation."""

import contextlib
import importlib
import pkgutil
import time
import warnings

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

import depth_lidar_nerf_tpu_torch
from depth_lidar_nerf_tpu_torch.utils import tracing

STEP_PHASES = ["step.draw", "step.render", "step.loss", "step.backward",
               "step.optimizer"]


def _cpu_profile():
    return profile(activities=[ProfilerActivity.CPU])


def _new_session():
    """Tracing found off: the next call under a profiler starts a session."""
    assert tracing.span("off") is tracing.span("off again")


def test_off_records_nothing():
    """Off, ``span`` is one shared null context and records nothing; the
    next profiler's first span starts a new session."""
    _new_session()
    with _cpu_profile():
        with tracing.span("before", 1):
            pass
    before = tracing.records()
    assert [(r.name, r.id) for r in before] == [("before", 1)]
    assert not tracing.enabled()
    null = tracing.span("x", 2)
    assert tracing.span("y") is null
    with null:
        with tracing.span("z", 3):
            pass
    tracing.count("n", 5)  # counters count whenever called
    assert tracing.records() == before
    with _cpu_profile():
        with tracing.span("after"):
            pass
    assert [r.name for r in tracing.records()] == ["after"]
    assert tracing.counters() == {}


def _nested_units(n):
    # The first record_function under a new profiler returns about a
    # millisecond after it stamps its start: a warm-up span goes first.
    with tracing.span("warm"):
        pass
    for k in range(n):
        with tracing.span("unit", k):
            with tracing.span("unit.a"):
                with tracing.span("unit.a.inner", 10 + k):
                    time.sleep(0.0005)
            with tracing.span("unit.b"):
                torch.ones(256).sum()


def test_spans_nest_and_agree_with_the_profiler():
    """Each span lies in its parent; parents and ids are as opened; each
    span's start and end are within 0.2 ms of its ``record_function``
    event's on the profiler's clock (trace start + relative time). A run
    that another process preempted between the two stamps may miss, so up
    to three runs are made and one must agree throughout."""
    names = ("unit", "unit.a", "unit.a.inner", "unit.b")
    worst = []
    for _ in range(3):
        _new_session()
        with _cpu_profile() as prof:
            _nested_units(4)
        recs = tracing.records()
        assert [r.name for r in recs] == ["warm"] + list(names) * 4
        for k, r in enumerate(recs):
            want_parent = {"warm": None, "unit": None,
                           "unit.a": k - 1, "unit.a.inner": k - 1,
                           "unit.b": k - 3}[r.name]
            assert r.parent == want_parent, (k, r)
            if r.parent is not None:
                p = recs[r.parent]
                assert p.t0_ns <= r.t0_ns <= r.t1_ns <= p.t1_ns
        assert [r.id for r in recs if r.name == "unit"] == [0, 1, 2, 3]
        assert [r.id for r in recs if r.name == "unit.a.inner"] == \
            [10, 11, 12, 13]
        start = prof.profiler.kineto_results.trace_start_ns()
        events = sorted((e for e in prof.events() if e.name in names),
                        key=lambda e: e.time_range.start)
        mine = [r for r in recs if r.name in names]
        assert [e.name for e in events] == [r.name for r in mine]
        gaps = [max(abs(start + 1e3 * e.time_range.start - r.t0_ns),
                    abs(start + 1e3 * e.time_range.end - r.t1_ns))
                for e, r in zip(events, mine)]
        worst.append(max(gaps) * 1e-6)
        if worst[-1] < 0.2:
            break
    assert min(worst) < 0.2, worst


def _wrappers_found():
    """Every object with a ``launches`` counter at module level in any of
    the port's modules."""
    found = {}
    for m in pkgutil.walk_packages(depth_lidar_nerf_tpu_torch.__path__,
                                   "depth_lidar_nerf_tpu_torch."):
        if m.name.endswith("__main__"):
            continue
        mod = importlib.import_module(m.name)
        for name, obj in vars(mod).items():
            if isinstance(getattr(obj, "launches", None), int):
                found[id(obj)] = f"{m.name}.{name}"
    return found


def test_registry_lists_every_wrapper():
    """Every wrapper with a ``.launches`` counter is registered once its
    module is imported; ``launch_counts`` counts a split call's launches
    under its phases and not again under its wrapper."""
    found = _wrappers_found()
    wrappers = tracing.launch_wrappers()
    assert len(found) == len(wrappers) == 21
    assert set(found) == {id(w) for w in wrappers.values()}
    counts = tracing.launch_counts()
    assert set(counts) == set(wrappers)
    from depth_lidar_nerf_tpu_torch.ops import fused_mlp_t, sampling_cuda

    chain, whole = fused_mlp_t.fused_nerf_bwd_chain, \
        fused_mlp_t.fused_nerf_bwd_acts
    n_whole = whole.launches
    _new_session()
    with _cpu_profile():
        with tracing.span("s"):
            sampling_cuda.inverse_cdf.launches += 3
            chain.launches += 2  # a split call of two chunks
            tracing.count_split_call(whole)
    try:
        assert whole.launches == n_whole + 1
        assert tracing.launch_counts()["sample_pdf"] == counts["sample_pdf"] + 3
        assert tracing.session_launches()["fused_nerf_bwd_acts"] == 0
        assert tracing.session_launches()["sample_pdf"] == 3
        assert sum(tracing.session_launches().values()) == 5
    finally:
        sampling_cuda.inverse_cdf.launches -= 3
        chain.launches -= 2
        whole.launches -= 1
        whole.split_calls -= 1


def _stack(device, N_rand=64):
    """A width-128 RGB stack (the kernels' routes; on the CPU their plain
    twins), its state, a random 2-view table and a step."""
    from depth_lidar_nerf_tpu_torch.train.config import (TrainConfig,
                                                         render_config_from)
    from depth_lidar_nerf_tpu_torch.train.state import (build_models,
                                                        init_train_state)
    from depth_lidar_nerf_tpu_torch.train.step import make_train_step
    from depth_lidar_nerf_tpu_torch.train.tables import build_rgb_table

    H, W, focal = 12, 16, 14.0
    cfg = TrainConfig(N_rand=N_rand, N_samples=16, N_importance=16,
                      netdepth=2, netwidth=128, netdepth_fine=2,
                      netwidth_fine=128, use_viewdirs=True, multires=10,
                      multires_views=4, no_ndc=True, chunk=128,
                      raw_noise_std=1.0, lrate=5e-4, cull_eps=1e-4)
    rcfg = render_config_from(cfg, 0, 2.0, 6.0)
    models = build_models(cfg, rcfg, device=device, seed=0)
    rng = np.random.default_rng(0)
    images = rng.random((2, H, W, 3)).astype(np.float32)
    poses = np.tile(np.eye(4, dtype=np.float32)[:3], (2, 1, 1))
    poses[1, 0, 3] = 0.3
    table = build_rgb_table(images, poses, [0, 1], H, W, focal, rcfg,
                            device=device)
    step = make_train_step(cfg, rcfg, models, (H, W, focal))
    return cfg, rcfg, models, init_train_state(cfg, models), table, step, \
        (H, W, focal), poses


def test_training_step_and_frame_record_their_spans():
    """One step under a CPU profiler: ``step`` (id the step number) and its
    five phases in order, and kernel 3's tile counters (its plain twin on
    the CPU: the coarse pass takes the culled backward); then one
    ``render_path`` frame: ``frame`` (id the pose index), ``frame.rays``,
    a ``frame.tile`` a tile, ``frame.to_host``."""
    from depth_lidar_nerf_tpu_torch.train.config import eval_render_config
    from depth_lidar_nerf_tpu_torch.train.loop import render_path

    cfg, rcfg, models, state, table, step, hwf, poses = _stack("cpu")
    gen = torch.Generator().manual_seed(1)
    step(state, table, None, gen)  # step 1, untraced
    with _cpu_profile():
        step(state, table, None, gen)  # a new session: tracing was off
    recs = tracing.records()
    assert [(r.name, r.id, r.parent) for r in recs] == \
        [("step", 2, None)] + [(p, None, 0) for p in STEP_PHASES]
    tiles = tracing.counters()["cull.tiles"]
    live = tracing.device_counters()["cull.live_tiles"]
    assert tiles > 0 and 0 < live <= tiles

    _new_session()
    with _cpu_profile():
        render_path(models, poses[:1], hwf, eval_render_config(cfg, rcfg),
                    device="cpu")
    recs = tracing.records()
    assert [(r.name, r.id, r.parent) for r in recs] == [
        ("frame", 0, None), ("frame.rays", None, 0), ("frame.tile", 0, 0),
        ("frame.tile", 1, 0), ("frame.to_host", None, 0)]


@pytest.mark.cuda
def test_tracing_adds_no_synchronisation():
    """Under ``torch.cuda.set_sync_debug_mode("warn")``, a step traced
    (spans, the launch registry's session, kernel 3's counters) makes
    exactly as many synchronising calls as the same step untraced."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    cfg, rcfg, models, state, table, step, hwf, poses = _stack(
        "cuda", N_rand=4096)
    gen = torch.Generator(device="cuda").manual_seed(1)
    step(state, table, None, gen)
    torch.cuda.synchronize()

    def warned(traced):
        acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
        with (profile(activities=acts) if traced
              else contextlib.nullcontext()):
            # The profiler's own set-up on its first launch goes first.
            torch.ones(1, device="cuda").sum()
            torch.cuda.synchronize()
            with warnings.catch_warnings(record=True) as w:
                warnings.simplefilter("always")
                torch.cuda.set_sync_debug_mode("warn")
                try:
                    step(state, table, None, gen)
                finally:
                    torch.cuda.set_sync_debug_mode(0)
            torch.cuda.synchronize()
        # (The mode's first use also warns that it is a prototype.)
        return [str(x.message) for x in w
                if "called a synchronizing" in str(x.message)]

    untraced = warned(False)
    traced = warned(True)
    assert tracing.counters()["cull.tiles"] > 0
    assert [r.name for r in tracing.records()][:1] == ["step"]
    assert len(traced) == len(untraced), (traced, untraced)


def test_patch_step_records_its_spans():
    """A patch step (content loss and smoothness) under a CPU profiler: the
    no-grad tiles (``patch.ng``, id the tile) and the grad leg
    (``patch.grad``) inside ``step.render``, ``patch.smooth`` and
    ``patch.feature`` inside ``step.loss``; ``patch.steps``,
    ``patch.rays_ng`` and ``patch.rays_grad`` count the step and the crop's
    rays. A base step records none of them."""
    from depth_lidar_nerf_tpu_torch.train.config import (TrainConfig,
                                                         render_config_from)
    from depth_lidar_nerf_tpu_torch.train.state import (build_models,
                                                        init_train_state)
    from depth_lidar_nerf_tpu_torch.train.step import (PatchSource,
                                                       make_train_step)
    from depth_lidar_nerf_tpu_torch.train.tables import build_rgb_table

    H, W, focal = 12, 16, 14.0
    cfg = TrainConfig(N_rand=32, N_samples=8, N_importance=8, netdepth=2,
                      netwidth=32, netdepth_fine=2, netwidth_fine=32,
                      use_viewdirs=True, multires=4, multires_views=2,
                      no_ndc=True, chunk=40,
                      raw_noise_std=1.0, lrate=5e-4, feature_loss=True,
                      feature_loss_type="vgg", vgg_layers=["conv1_2"],
                      vgg_layer_weights=[1.0], vgg_loss_type="l1",
                      depth_inverse_loss=True, nH=12, nW=16, gradH=2, gradW=4,
                      datadir="/nonexistent")
    rcfg = render_config_from(cfg, 0, 2.0, 6.0)
    models = build_models(cfg, rcfg, device="cpu", seed=0)
    rng = np.random.default_rng(0)
    images = rng.random((2, H, W, 3)).astype(np.float32)
    poses = np.tile(np.eye(4, dtype=np.float32)[:3], (2, 1, 1))
    poses[1, 0, 3] = 0.3
    table = build_rgb_table(images, poses, [0, 1], H, W, focal, rcfg,
                            device="cpu")
    state = init_train_state(cfg, models)
    patch = make_train_step(cfg, rcfg, models, (H, W, focal),
                            feature_on=True, smooth_on=True)
    base = make_train_step(cfg, rcfg, models, (H, W, focal))
    src = PatchSource(torch.from_numpy(images), torch.from_numpy(poses))
    gen = torch.Generator().manual_seed(3)
    _new_session()
    with _cpu_profile():
        patch(state, table, None, gen, patch=src)
    recs = tracing.records()
    where = {(r.name, r.id, recs[r.parent].name) for r in recs
             if r.name.startswith("patch.")}
    # 184 no-grad rays in tiles of 128 (the plain route's least tile).
    assert where == {("patch.ng", 0, "step.render"), ("patch.ng", 1, "step.render"),
                     ("patch.grad", None, "step.render"),
                     ("patch.smooth", None, "step.loss"),
                     ("patch.feature", None, "step.loss")}
    assert all(recs[recs[r.parent].parent].name == "step" for r in recs
               if r.name.startswith("patch."))
    assert {k: v for k, v in tracing.counters().items()
            if k.startswith("patch.")} == {"patch.steps": 1,
                                            "patch.rays_ng": 184,
                                            "patch.rays_grad": 8}
    _new_session()
    with _cpu_profile():
        base(state, table, None, gen)
    assert [r.name for r in tracing.records()] == ["step"] + STEP_PHASES
    assert not any(k.startswith("patch.") for k in tracing.counters())
