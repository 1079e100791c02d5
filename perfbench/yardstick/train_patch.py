"""The patch training traffic: ``train/loop.py``'s step loop over the loss
schedule of the paper's full method, timed over whole periods.

As :mod:`yardstick.train`, with the steps that the schedule makes patch
steps (``build_step_fns(...).select(i)`` says which) handed the
:class:`PatchSource` of the scene's training images and poses, as
``train/loop.py`` hands it. VGG19's weights are drawn from the seed
(:func:`vgg_weights`) and loaded into the program's perceptual model.

Set-up runs the checked steps (``1..checked_steps``, the last a patch
step) and reads what :mod:`yardstick.check_patch` compares of them: each
step's loss and depth term, step 1's gradient and each leaf's change
after the steps; then warms up to a step ``i`` with ``i % period == 0``.
The window opens there and closes on the first such step once
``--seconds`` have passed, timed to that step's end, so that every window
holds whole periods of the schedule. The count is the base batch times
the steps. After the window :mod:`yardstick.reference_patch` repeats the
checked steps in float32; the program is then fed the reference's
parameters and Adam moments before the last step and takes that step
once more (:meth:`PatchSession.step_at`), so that both sides' gradient,
patch terms and VGG19 calls of the patch step are taken at the
reference's own weights.

A traced run also gives the readers the program's patch counters over
the window (``patch.steps``, ``patch.rays_ng``, ``patch.rays_grad``), the
device time launched under each of its patch spans and inside VGG19's
convolution backward (:mod:`yardstick.patch_trace`) and the spans' host
ranges, and prints them to standard error.
"""

from __future__ import annotations

import json
import math
import sys
import time
from typing import Dict

import torch

from yardstick import check_patch, patch_trace, reference_patch, scene, spans
from yardstick.reference import step_seed
from yardstick.reference_patch import PATCH_TERMS, PatchReadings
from yardstick.run_common import Outcome, RunSpec, profiler, span
from yardstick.train import Readings, Session, _leaves, _sync

VGG_TAG = 30  # the seed's use for VGG19's weights


def vgg_weights(taps, seed: int, device) -> Dict[str, torch.Tensor]:
    """VGG19's float32 weights up to the deepest of ``taps`` (the port's
    names, ``conv1_1.weight``, ...): Flax's LeCun-normal rule, a unit normal
    clipped at two standard deviations and rescaled, from one draw on the
    device seeded from ``seed``; zero biases."""
    layers = reference_patch.vgg_layers(taps)
    total = sum(ci * co * 9 for _, ci, co, _ in layers)
    z = torch.clamp(torch.randn(total, device=device,
                                generator=scene.generator(device, seed, VGG_TAG)),
                    -2.0, 2.0)
    out, off = {}, 0
    for name, ci, co, _ in layers:
        n = ci * co * 9
        out[name + ".weight"] = (z[off:off + n].reshape(co, ci, 3, 3)
                                 * (math.sqrt(1.0 / (ci * 9)) / scene.TRUNC_STD))
        out[name + ".bias"] = torch.zeros(co, device=device)
        off += n
    return out


def _grads(leaves) -> Dict[str, torch.Tensor]:
    """The gradient of the step just taken (the program sets each leaf's
    ``grad`` before its optimizer step and clears it in the next)."""
    return {name: (p.grad if p.grad is not None else torch.zeros_like(p))
            .detach().float().clone() for name, p in leaves}


class PatchSession(Session):
    """One training state whose loss schedule has patch steps."""

    def __init__(self, spec: RunSpec, device):
        super().__init__(spec, device)
        from depth_lidar_nerf_tpu_torch.render.renderer import pick_render_tile
        from depth_lidar_nerf_tpu_torch.train.step import (NG_FUSED_CAP,
                                                           NG_PLAIN_CAP,
                                                           PatchSource)

        self.vgg = vgg_weights(spec.plain["vgg_layers"], spec.seed, device)
        with torch.no_grad():
            self.models.vgg.load_state_dict(self.vgg)
        self.source = PatchSource(self.data.images, self.data.poses)
        # The no-grad leg's tile, by the program's own rule: the reference
        # draws that leg's randomness tile by tile.
        n_ng = reference_patch.legs(spec.plain)[0]
        self.ng_tile = max(1, min(n_ng, pick_render_tile(
            self.models.coarse, self.models.fine, self.rcfg, n_ng,
            fused_cap=NG_FUSED_CAP, flax_cap=NG_PLAIN_CAP)))

    def step(self):
        """The training loop's iteration ``i``: seed, select, step (a patch step
        with the patch source)."""
        self.i += 1
        i = self.i
        self.gen.manual_seed(step_seed(self.spec.seed, i))
        fn, needs_patch = self.plan.select(i)
        kw = {"patch": self.source} if needs_patch else {}
        with span("step"):
            m = fn(self.state, *self.tables, self.gen, **kw)
        self.bad += (~torch.isfinite(m["loss"])).long()
        if self.i % self.cfg.i_print == 0:
            with span("fetch"):
                self.fetch(m)
        return m

    def first_steps(self, n: int) -> PatchReadings:
        """Steps 1..n: each step's loss and depth term, step 1's gradient
        and each leaf's change after the steps. The last step's gradient,
        terms and VGG19 calls come from :meth:`step_at`."""
        losses, depth_losses, first = [], [], {}
        leaves = _leaves(self.models)
        for k in range(1, n + 1):
            m = self.step()
            losses.append(float(m["loss"]))
            depth_losses.append(float(m.get("depth_loss", 0.0)))
            if k == 1:
                first = _grads(leaves)
        with torch.no_grad():
            change = {name: float(torch.linalg.norm(
                p.detach() - self.init[name.split(".", 1)[0]][name.split(".", 1)[1]]))
                for name, p in leaves}
        return PatchReadings(Readings(losses, depth_losses, {}, change, {}), {}, [],
                             first)

    def step_at(self, prog: PatchReadings, before, n: int) -> PatchReadings:
        """``prog`` with step ``n``'s gradient, patch terms and VGG19 calls,
        that step run by the program from ``before``, the plain reference's
        parameters and Adam moments after step ``n - 1``
        (:func:`yardstick.reference_patch.train_steps`), with step ``n``'s
        seed and function."""
        from depth_lidar_nerf_tpu_torch.train.state import invalidate_packs

        leaves = _leaves(self.models)
        st = self.state.optimizer.state
        with torch.no_grad():
            for name, p in leaves:
                net, key = name.split(".", 1)
                p.copy_(before.params[net][key])
                st[p]["exp_avg"] = before.m[name].clone()
                st[p]["exp_avg_sq"] = before.v[name].clone()
        invalidate_packs(self.models)
        self.state.step = self.state.optimizer.count = n - 1
        calls = []

        def keep(module, args, out):
            calls.append((args[0].detach().float().clone(),
                          {t: v.detach().float().permute(0, 3, 1, 2).clone()
                           for t, v in out.items()}))

        self.gen.manual_seed(step_seed(self.spec.seed, n))
        fn, needs_patch = self.plan.select(n)
        kw = {"patch": self.source} if needs_patch else {}
        hook = self.models.vgg.register_forward_hook(keep)
        try:
            m = fn(self.state, *self.tables, self.gen, **kw)
        finally:
            hook.remove()
        grads = _grads(leaves)
        norms = {name: float(torch.linalg.norm(g)) for name, g in grads.items()}
        r = prog.readings._replace(grad_norms=norms, grads=grads)
        return prog._replace(readings=r, vgg=calls,
                             patch={k: float(m[k]) for k in PATCH_TERMS if k in m})

    def free(self):
        self.source = None
        super().free()


def _patch_split(prof, steps: int, ng_tile: int):
    """The program's patch counters over the window, and the device time
    under each patch span (and VGG19's backward) for the readers; printed
    to standard error. The counters read 0 where the program keeps none."""
    rec = spans.recorder()
    got = rec.counters() if rec is not None else {}
    counted = {k: got.get(f"patch.{k}", 0) for k in ("steps", "rays_ng", "rays_grad")}
    ev = patch_trace.from_profile(prof)
    dev = patch_trace.attribute(ev)
    per = {k: 1e3 * v / max(counted["steps"], 1) for k, v in dev.items()
           if k not in ("device_ops", "matched")}
    print("patch " + json.dumps({"steps": steps, "counters": counted,
                                 "ng_tile": ng_tile,
                                 "device_ops": dev["device_ops"],
                                 "matched": dev["matched"],
                                 "device_ms_per_patch_step": per}), file=sys.stderr)
    return {"patch_steps": counted["steps"], "patch_rays_ng": counted["rays_ng"],
            "patch_rays_grad": counted["rays_grad"], "patch_device_s": dev,
            "patch_spans": patch_trace.span_ranges(ev)}


def run(spec: RunSpec) -> Outcome:
    tr = spec.traffic
    period, n = tr["period"], tr["checked_steps"]
    device = torch.device("cuda", 0) if spec.device_type == "cuda" else torch.device("cpu")
    sess = PatchSession(spec, device)
    prog = sess.first_steps(n)
    m = None
    while sess.i < n + tr["warm_steps"] or sess.i % period:
        m = sess.step()
    sess.fetch(m)
    _sync(device)
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    first, bad0 = sess.i, int(sess.bad)
    with profiler(spec.trace, device) as prof:
        _sync(device)
        t0 = time.time()
        with span("window"):
            end = t0 + spec.seconds
            while True:
                sess.step()
                if sess.i % period == 0 and time.time() >= end:
                    break
            _sync(device)
        t1 = time.time()
    steps = sess.i - first
    bad = int(sess.bad) - bad0
    peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0
    trace_red = prof.reduce() if spec.trace else None
    window = t1 - t0
    counts = {"steps": steps, "n_rays": sess.plain["N_rand"], "window_s": window,
              "chips": 1}
    if spec.trace:
        counts.update(_patch_split(prof.prof, steps, sess.ng_tile))
    plain = sess.plain
    e2e = {"train_rays_per_s": plain["N_rand"] * steps / window,
           "setup_s": t0 - spec.t_start}
    ref, before = reference_patch.train_steps(plain, sess.data, sess.init, sess.vgg,
                                              spec.seed, n, tr["check_block_rays"],
                                              sess.ng_tile)
    prog = sess.step_at(prog, before, n)
    sess.free()
    numbers = check_patch.numbers(prog, ref["reference"], sess.vgg, plain["vgg_layers"])
    _sync(device)
    return Outcome(e2e=e2e, numbers=numbers, attempted=steps, failed=bad,
                   peak=peak, trace=trace_red,
                   rank_traces=[trace_red.summary() if trace_red else None],
                   counts=counts, plain=plain)
