"""The serving traffic: one client in a closed loop, one pose a
``render_path`` call.

Set-up builds the served field from the seed (the benchmark's weights with
the density head scaled and offset and the colour head scaled, so that no
ray is empty), the eval render config and the spiral of poses, and renders
one frame twice to warm its shapes. The window calls ``train/loop.py:
render_path`` with the next pose of the spiral until ``seconds`` have
passed; each frame is timed from the call until its maps are on the host.
After it, a sample of the frames drawn from the seed is rendered again by
the plain reference in float32 and compared.
"""

from __future__ import annotations

import dataclasses
import gc
import statistics
import time

import numpy as np
import torch

from yardstick import reference, scene
from yardstick.check import frame_numbers
from yardstick.run_common import Outcome, RunSpec, profiler, span


class Server:
    def __init__(self, spec: RunSpec, device, render_int8: bool = False):
        from depth_lidar_nerf_tpu_torch.train.config import (TrainConfig,
                                                             eval_render_config,
                                                             render_config_from)
        from depth_lidar_nerf_tpu_torch.train.state import (build_models,
                                                            invalidate_packs)

        plain = spec.plain
        names = {f.name for f in dataclasses.fields(TrainConfig)}
        kw = {k: v for k, v in spec.config.items() if k in names}
        kw.update(dataset_type="llff", use_viewdirs=True, seed=0,
                  render_only=True, render_int8=render_int8)
        self.cfg = TrainConfig(**kw)
        rcfg = render_config_from(self.cfg, 0, 0.0, 1.0)
        self.rcfg = eval_render_config(self.cfg, rcfg)
        self.init = scene.make_weights(plain, spec.seed, device)
        models = build_models(self.cfg, rcfg, device=device, seed=0)
        with torch.no_grad():
            models.coarse.load_state_dict(self.init["coarse"])
            models.fine.load_state_dict(self.init["fine"])
        invalidate_packs(models)
        self.models, self.device = models, device
        self.hwf = (plain["H"], plain["W"], plain["focal"])
        self.poses = scene.spiral_poses(spec.traffic["poses"], spec.seed, device)
        self.poses_np = self.poses.cpu().numpy()

    def frame(self, k: int):
        from depth_lidar_nerf_tpu_torch.train.loop import render_path

        pose = self.poses_np[k % len(self.poses_np)][None]
        with span("render_path"):
            rgbs, disps = render_path(self.models, pose, self.hwf, self.rcfg,
                                      device=self.device)
        return rgbs[0], disps[0]

    def free(self):
        self.models = None
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()


def checked_frames(seed: int, n_frames: int, k: int):
    """The frames the check renders again: ``k`` of the ``n_frames``
    served, drawn from the seed."""
    rng = np.random.default_rng(scene.sub_seed(seed, 20))
    return sorted(rng.choice(n_frames, size=min(k, n_frames), replace=False).tolist())


def reference_frames(spec: RunSpec, init, poses, frames):
    plain = spec.plain
    return [tuple(x.cpu().numpy() for x in reference.render_frame(
        plain, init, poses[f % len(poses)], block=spec.traffic["check_block_rays"]))
        for f in frames]


def run(spec: RunSpec) -> Outcome:
    device = torch.device("cuda", 0) if spec.device_type == "cuda" else torch.device("cpu")
    srv = Server(spec, device)
    for k in range(spec.traffic["warm_frames"]):
        srv.frame(k)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
        torch.cuda.reset_peak_memory_stats(device)
    outs, lat = [], []
    with profiler(spec.trace, device) as prof:
        t0 = time.time()
        with span("window"):
            end = t0 + spec.seconds
            k = 0
            while True:
                ts = time.time()
                outs.append(srv.frame(k))
                lat.append(time.time() - ts)
                k += 1
                if time.time() >= end:
                    break
        t1 = time.time()
    peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0
    tr = prof.reduce() if spec.trace else None
    window = t1 - t0
    failed = sum(1 for r, d in outs if not (np.isfinite(r).all() and np.isfinite(d).all()))
    e2e = {"frames_per_s": len(outs) / window,
           "frame_ms_p95": 1e3 * statistics.quantiles(lat, n=100, method="inclusive")[94]
           if len(lat) > 1 else 1e3 * lat[0],
           "setup_s": t0 - spec.t_start}
    init, poses = srv.init, srv.poses
    srv.free()
    frames = checked_frames(spec.seed, len(outs), spec.traffic["checked_frames"])
    refs = reference_frames(spec, init, poses, frames)
    numbers = frame_numbers([outs[f] for f in frames], refs)
    counts = {"frames": len(outs), "n_rays": spec.plain["H"] * spec.plain["W"],
              "window_s": window, "chips": 1}
    return Outcome(e2e=e2e, numbers=numbers, attempted=len(outs), failed=failed,
                   peak=peak, trace=tr,
                   rank_traces=[tr.summary() if tr else None], counts=counts,
                   plain=spec.plain)
