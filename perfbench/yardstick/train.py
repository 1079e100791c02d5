"""The training traffic: the driver's step loop, timed.

Set-up builds one training state from the seed (the benchmark's scene,
weights and the program's tables), drives it through its first steps with
the window's own call and feed, reads what the correctness check compares
(each step's loss and depth term, the first gradient as the optimizer
holds it, each leaf's change after the steps), warms up, and hands the same state to the
window. The window runs ``train/loop.py:_loop``'s iteration: step ``i``'s
generator seeded with ``step_seed(seed, i)``, the step of
``build_step_fns(...).select(i)``, one fetch of the scalar metrics every
``i_print`` steps. After it, the program's state is freed and the plain
reference repeats the first steps in float32.

Under a mesh (the traffic's ``mesh_shape``) every rank is a process on its
own card, all joined by the program's ``parallel.distributed.launch_local``
over NCCL; the global batch is the configuration's ``N_rand`` times the
ranks; rank 0 times the window and decides, each step, whether it has
closed.
"""

from __future__ import annotations

import dataclasses
import gc
import time
from typing import Optional

import numpy as np
import torch

from yardstick import reference, scene
from yardstick.reference import Readings, step_seed
from yardstick.run_common import Outcome, RunSpec, profiler, span


def _train_config(spec: RunSpec, n_rand: int, mesh_shape):
    from depth_lidar_nerf_tpu_torch.train.config import TrainConfig

    names = {f.name for f in dataclasses.fields(TrainConfig)}
    kw = {k: v for k, v in spec.config.items() if k in names}
    kw.update(N_rand=n_rand, mesh_shape=mesh_shape, dataset_type="llff",
              use_viewdirs=True, seed=0, i_weights=0, i_testset=0, i_img=0,
              i_video=0)
    return TrainConfig(**kw)


def _tables(data, cfg, rcfg, plain, device):
    from depth_lidar_nerf_tpu_torch.train.tables import (build_depth_table,
                                                         build_rgb_table)

    V = data.images.shape[0]
    hwf = (plain["H"], plain["W"], plain["focal"])
    seg = None if data.segmentation is None else data.segmentation.cpu().numpy()
    rgb = build_rgb_table(data.images.cpu().numpy(), data.poses.cpu().numpy(),
                          range(V), *hwf, rcfg, seg, device=device)
    depth = None
    if cfg.colmap_depth:
        gts = [{"coord": c, "depth": d, "weight": w} for c, d, w in zip(
            data.depth_coord.cpu().numpy(), data.depth.cpu().numpy(),
            data.depth_weight.cpu().numpy())]
        depth = build_depth_table(gts, data.poses.cpu().numpy(), range(V),
                                  *hwf, rcfg, device=device)
    return rgb, depth


def _leaves(models):
    return [(f"{net}.{k}", p) for net, m in (("coarse", models.coarse),
                                              ("fine", models.fine))
            for k, p in m.named_parameters()]


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class Session:
    """One rank's training state and its step loop."""

    def __init__(self, spec: RunSpec, device, mesh=None):
        from depth_lidar_nerf_tpu_torch.train.config import render_config_from
        from depth_lidar_nerf_tpu_torch.train.state import (build_models,
                                                            init_train_state,
                                                            invalidate_packs)
        from depth_lidar_nerf_tpu_torch.train.step import build_step_fns

        self.spec, self.device, self.mesh = spec, device, mesh
        world = 1 if mesh is None else mesh.size
        plain = dict(spec.plain, N_rand=spec.plain["N_rand"] * world)
        self.plain = plain
        self.cfg = _train_config(spec, plain["N_rand"],
                                 spec.traffic.get("mesh_shape"))
        self.rcfg = render_config_from(self.cfg, plain["num_classes"], 0.0, 1.0)
        self.data = scene.make_scene(plain, spec.seed, device)
        self.init = scene.make_weights(plain, spec.seed, device)
        models = build_models(self.cfg, self.rcfg, device=device, seed=0)
        with torch.no_grad():
            models.coarse.load_state_dict(self.init["coarse"])
            models.fine.load_state_dict(self.init["fine"])
        invalidate_packs(models)
        self.models = models
        self.state = init_train_state(self.cfg, models)
        self.tables = _tables(self.data, self.cfg, self.rcfg, plain, device)
        hwf = (plain["H"], plain["W"], plain["focal"])
        self.plan = build_step_fns(self.cfg, self.rcfg, models, hwf, mesh=mesh)
        self.gen = torch.Generator(device=device)
        self.bad = torch.zeros((), dtype=torch.int64, device=device)
        self.i = 0

    def step(self):
        """The driver's iteration ``i``: seed, select, step."""
        self.i += 1
        i = self.i
        self.gen.manual_seed(step_seed(self.spec.seed, i))
        fn, needs_patch = self.plan.select(i)
        if needs_patch:
            raise ValueError("the benchmark's training mixes run no patch step")
        with span("step"):
            m = fn(self.state, *self.tables, self.gen)
        self.bad += (~torch.isfinite(m["loss"])).long()
        if self.i % self.cfg.i_print == 0:
            with span("fetch"):
                self.fetch(m)
        return m

    def fetch(self, m):
        """``_loop``'s one device-to-host copy of the scalar metrics."""
        names = [k for k, v in m.items() if v.dim() < 2]
        return torch.stack([m[k].to(self.device, torch.float32)
                            for k in names]).cpu().numpy()

    def first_steps(self, n: int) -> Readings:
        """Steps 1..n, with the readings the check compares."""
        losses, depth_losses, norms, grads = [], [], {}, {}
        leaves = _leaves(self.models)
        for k in range(n):
            m = self.step()
            losses.append(float(m["loss"]))
            # A step without the term reads 0 against the reference's.
            depth_losses.append(float(m.get("depth_loss", 0.0)))
            if k == 0:
                st = self.state.optimizer.state
                grads = {name: (st[p]["exp_avg"] / (1.0 - reference.B1)).detach().clone()
                         for name, p in leaves if p in st}
                norms = {name: float(torch.linalg.norm(g)) for name, g in grads.items()}
        with torch.no_grad():
            change = {name: float(torch.linalg.norm(
                p.detach() - self.init[name.split(".", 1)[0]][name.split(".", 1)[1]]))
                for name, p in leaves}
        return Readings(losses, depth_losses, norms, change, grads)

    def free(self):
        for k in ("plan", "state", "models", "tables"):
            setattr(self, k, None)
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()


def _stop_flag(group, stop: bool) -> bool:
    """Rank 0's decision, the same on every rank (over the host group)."""
    if group is None:
        return stop
    import torch.distributed as dist

    flag = [stop]
    dist.broadcast_object_list(flag, src=0, group=group)
    return bool(flag[0])


def rank_main(spec: RunSpec, device_type: str = "cuda") -> Optional[dict]:
    """One rank's run (rank 0's, or the only one's): set-up, window, and
    what rank 0 needs to report."""
    import torch.distributed as dist

    mesh = host = None
    rank = 0
    device = torch.device(device_type)
    if dist.is_initialized():
        from depth_lidar_nerf_tpu_torch.parallel import distributed as pdist
        from depth_lidar_nerf_tpu_torch.parallel.mesh import make_mesh

        rank = dist.get_rank()
        device = pdist.rank_device(rank, device_type)
        if device.type == "cuda":
            torch.cuda.set_device(device)
        mesh = make_mesh(spec.traffic["mesh_shape"], device=device)
        host = dist.new_group(backend="gloo")
    elif device.type == "cuda":
        device = torch.device("cuda", 0)
    tr = spec.traffic
    sess = Session(spec, device, mesh)
    prog = sess.first_steps(tr["checked_steps"])
    for _ in range(tr["warm_steps"]):
        sess.step()
    sess.fetch(sess.step())
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
                if _stop_flag(host, time.time() >= end):
                    break
            _sync(device)
        t1 = time.time()
    steps = sess.i - first
    bad = int(sess.bad) - bad0
    peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0
    tr_red = prof.reduce() if spec.trace else None
    sess.free()
    out = {"t0": t0, "t1": t1, "steps": steps,
           "bad": bad, "peak": peak, "trace": tr_red, "prog": prog,
           "n_rand": sess.plain["N_rand"], "plain": sess.plain,
           "data": sess.data, "init": sess.init}
    if mesh is not None:
        keep = {k: out[k] for k in ("peak", "trace", "bad")}
        got = [None] * mesh.size
        dist.all_gather_object(got, {k: (v.summary() if k == "trace" and v
                                         else v) for k, v in keep.items()},
                               group=host)
        out["ranks"] = got
        if rank != 0:
            return None
    return out


def run(spec: RunSpec) -> Outcome:
    world = int(np.prod(spec.traffic.get("mesh_shape") or [1]))
    if world > 1:
        from depth_lidar_nerf_tpu_torch.parallel.distributed import launch_local

        r = launch_local(world, rank_main, (spec, spec.device_type),
                         device=spec.device_type)
    else:
        r = rank_main(spec, spec.device_type)
    device = r["data"].images.device
    ranks = r.get("ranks") or [{"peak": r["peak"], "bad": r["bad"],
                                "trace": r["trace"].summary() if r["trace"] else None}]
    window = r["t1"] - r["t0"]
    e2e = {"train_rays_per_s": r["n_rand"] * r["steps"] / window,
           "setup_s": r["t0"] - spec.t_start}
    counts = {"steps": r["steps"], "n_rays": r["n_rand"], "window_s": window,
              "chips": world}
    # The reference, once the program's state is gone.
    ref = reference.train_steps(r["plain"], r["data"], r["init"], spec.seed,
                                n_steps=spec.traffic["checked_steps"],
                                block=spec.traffic["check_block_rays"])
    from yardstick.check import train_numbers

    numbers = train_numbers(r["prog"], ref)
    _sync(device)
    return Outcome(e2e=e2e, numbers=numbers, attempted=r["steps"],
                   failed=r["bad"],
                   peak=max(x["peak"] for x in ranks), trace=r["trace"],
                   rank_traces=[x["trace"] for x in ranks], counts=counts,
                   plain=r["plain"])
