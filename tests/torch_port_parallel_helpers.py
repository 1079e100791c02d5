"""Spawned gloo ranks for the port's data-parallel tests
(``test_torch_port_parallel.py``, ``test_torch_port_multihost.py``).

The ranks import torch, numpy and the port only (no JAX); each runs a
function of this module and saves what it returns to a file, which the test
process reads after joining them. Every rank runs torch on one thread: the
suite's workers share the machine.
"""

import datetime
import multiprocessing
import os

import numpy as np
import torch

TIMEOUT_S = 300


def spawn_group(world, fn, args, outdir):
    """Start ``world`` processes (start method ``spawn``) that join one gloo
    group over ``tcp://127.0.0.1:<free port>`` and run ``fn(rank, *args)``;
    rank r's result goes to ``outdir/rank<r>.pt``. Returns the processes
    and the paths."""
    from depth_lidar_nerf_tpu_torch.parallel.distributed import free_port

    port = free_port()
    ctx = multiprocessing.get_context("spawn")
    paths = [os.path.join(outdir, f"rank{r}.pt") for r in range(world)]
    procs = [ctx.Process(target=_rank_entry,
                         args=(r, world, port, fn, args, paths[r]))
             for r in range(world)]
    for p in procs:
        p.start()
    return procs, paths


def join_group(procs, paths, timeout=TIMEOUT_S):
    """Wait for the ranks (killing them all past ``timeout`` seconds) and
    return their results in rank order; a rank that failed raises."""
    for p in procs:
        p.join(timeout)
    alive = [p for p in procs if p.is_alive()]
    for p in alive:
        p.kill()
        p.join()
    codes = [p.exitcode for p in procs]
    assert not alive and codes == [0] * len(procs), (codes, [
        open(q + ".err").read()[-3000:] for q in paths
        if os.path.exists(q + ".err")])
    return [torch.load(q, weights_only=False) for q in paths]


def _rank_entry(rank, world, port, fn, args, path):
    import traceback

    import torch.distributed as dist

    from depth_lidar_nerf_tpu_torch.parallel.distributed import \
        init_distributed

    torch.set_num_threads(1)
    try:
        init_distributed(f"127.0.0.1:{port}", world, rank, "cpu",
                         timeout=datetime.timedelta(seconds=TIMEOUT_S))
        out = fn(rank, *args)
        torch.save(out, path)
        dist.destroy_process_group()
    except BaseException:
        with open(path + ".err", "w") as f:
            f.write(traceback.format_exc())
        raise


# ---------------------------------------------------------------- step cases

BASE = dict(dataset_type="llff", N_rand=63, N_samples=16, N_importance=16,
            netdepth=2, netwidth=128, netdepth_fine=2, netwidth_fine=128,
            use_viewdirs=True, no_ndc=True, raw_noise_std=1.0,
            colmap_depth=True, depth_loss=True, depth_lambda=0.01,
            multires=4, multires_views=2, seed=0, cull_eps=1e-4,
            datadir="/nonexistent")
PATCH = dict(nH=8, nW=12, gradH=2, gradW=4, feature_start_iteration=1,
             feature_loss_every_n=1, feature_lambda=0.1,
             vgg_layers=["conv1_2", "conv2_2"], vgg_layer_weights=[0.1, 1.0],
             vgg_loss_type="l1", depth_inverse_loss_every_n=1,
             depth_inverse_lambda=0.1, gan_lambda=0.1)
# Each step variant: (config fields over BASE, make_train_step keywords).
VARIANTS = {
    "base": ({}, {}),
    "sigma_loss": (dict(sigma_loss=True, sigma_lambda=0.1), {}),
    "semantic": (dict(semantic_loss=True, semantic_lambda=0.04,
                      N_rand=64), {}),
    "patch_vgg_smooth": (dict(PATCH, feature_loss=True,
                              depth_inverse_loss=True, N_rand=64),
                         dict(feature_on=True, smooth_on=True)),
    # One grad-leg ray: the second rank's shard of that leg is empty.
    "patch_one_grad_ray": (dict(PATCH, depth_inverse_loss=True, gradH=1,
                                gradW=1, N_rand=64), dict(smooth_on=True)),
    "gan": (dict(PATCH, gan_loss=True, N_rand=64), dict(gan_on=True)),
    "grid": (dict(grid_train=True, grid_train_samples=24, N_rand=64),
             dict(grid_mode=True)),
    "no_batching": (dict(no_batching=True, precrop_iters=10,
                         precrop_frac=0.5, colmap_depth=False,
                         depth_loss=False, N_rand=32),
                    dict(precrop_on=True)),
}
STEPS = 2


def _scene(semantic=False):
    from depth_lidar_nerf_tpu_torch.data.synthetic import draw_scene

    return draw_scene(n_images=2, H=12, W=16, focal=14.0, n_depth_points=40,
                      seed=0, backdrop=True,
                      num_classes=19 if semantic else None)


def _snapshot(state):
    models = state.models
    nets = [("coarse", models.coarse), ("fine", models.fine),
            ("disc", models.discriminator)]
    return {f"{n}.{k}": v.detach().clone().numpy() for n, m in nets
            if m is not None for k, v in m.state_dict().items()}


def variant_run(name, mesh):
    """``STEPS`` steps of variant ``name`` from seeded weights and step
    generators, on ``mesh`` (None: one process): the metrics of each step,
    the parameters after them (the discriminator's too) and, for the grid
    variant, the ray CDF baked on the mesh."""
    from depth_lidar_nerf_tpu_torch.ops.ray_cdf import bake_ray_cdf
    from depth_lidar_nerf_tpu_torch.train.config import (TrainConfig,
                                                         render_config_from)
    from depth_lidar_nerf_tpu_torch.train.state import (build_models,
                                                        init_train_state)
    from depth_lidar_nerf_tpu_torch.train.step import (PatchSource,
                                                       make_train_step)
    from depth_lidar_nerf_tpu_torch.train.tables import (build_depth_table,
                                                         build_rgb_table)

    fields, kw = VARIANTS[name]
    cfg = TrainConfig(**{**BASE, **fields})
    sc = _scene(cfg.semantic_loss)
    rcfg = render_config_from(cfg, sc.num_classes if cfg.semantic_loss
                              else 0, sc.near, sc.far)
    models = build_models(cfg, rcfg, device="cpu", seed=0)
    state = init_train_state(cfg, models)
    it = range(2)
    rgb = build_rgb_table(sc.images, sc.poses, it, *sc.hwf, rcfg,
                          segmentation=sc.segmentation if cfg.semantic_loss
                          else None, device="cpu")
    dep = (build_depth_table(sc.depth_gts, sc.poses, it, *sc.hwf, rcfg,
                             device="cpu") if cfg.colmap_depth else None)
    step = make_train_step(cfg, rcfg, models, sc.hwf, mesh=mesh, **kw)
    extra, out = {}, {}
    if kw.get("grid_mode"):
        cdf = bake_ray_cdf(models, rcfg, rgb, dep, cfg.grid_train_samples,
                           mesh=mesh)
        extra["aux"] = cdf
        out["cdf"] = [t.float().numpy() for t in cdf]
    if fields.get("nH"):
        extra["patch"] = PatchSource(torch.from_numpy(sc.images).float(),
                                     torch.from_numpy(sc.poses).float())
    metrics = []
    for i in range(STEPS):
        gen = torch.Generator().manual_seed(1000 + i)
        m = step(state, rgb, dep, gen, **extra)
        metrics.append({k: v.numpy().copy() for k, v in m.items()})
    out.update(metrics=metrics, params=_snapshot(state))
    return out


FRAMES = {
    # (config fields over BASE, eval-config fields)
    "plain": (dict(use_fused_mlp=False), {}),
    "fused": (dict(use_fused_mlp=True), {}),
    "int8": (dict(use_fused_mlp=True), dict(render_int8=True)),
    "coarse_ds": (dict(use_fused_mlp=True),
                  dict(render_coarse_downsample=2)),
}


def frame(name, mesh):
    """A held-out frame of seeded weights through ``render_image`` on
    ``mesh`` (None: one process), in tiles of ``chunk`` 40 (the last one
    ragged)."""
    import dataclasses

    from depth_lidar_nerf_tpu_torch.render.renderer import render_image
    from depth_lidar_nerf_tpu_torch.train.config import (TrainConfig,
                                                         render_config_from)
    from depth_lidar_nerf_tpu_torch.train.state import build_models

    fields, ev = FRAMES[name]
    cfg = TrainConfig(**{**BASE, **fields})
    sc = _scene()
    rcfg = dataclasses.replace(render_config_from(cfg, 0, sc.near, sc.far),
                               chunk=40, **ev)
    models = build_models(cfg, rcfg, device="cpu", seed=0)
    out = render_image(models.coarse, models.fine, 12, 16, 14.0, sc.poses[1],
                       rcfg, device="cpu", mesh=mesh)
    return {k: v.numpy() for k, v in out.items() if k != "weights"}


def density_grid(mesh):
    from depth_lidar_nerf_tpu_torch.ops.density_grid import bake_density_grid
    from depth_lidar_nerf_tpu_torch.train.config import (TrainConfig,
                                                         render_config_from)
    from depth_lidar_nerf_tpu_torch.train.state import build_models

    cfg = TrainConfig(**BASE)
    rcfg = render_config_from(cfg, 0, 2.0, 6.0)
    models = build_models(cfg, rcfg, device="cpu", seed=0)
    grid, _, _ = bake_density_grid(models.fine, rcfg, [-1, -1, -1],
                                   [1, 1, 1], 9, mesh=mesh, chunk=100)
    return grid.numpy()


def jax_base_run(path, mesh):
    """One base step of the JAX-paired inputs saved at ``path``
    (``test_torch_port_parallel.py``): the port's models with JAX's weights,
    the tables and JAX's ray indices."""
    from depth_lidar_nerf_tpu_torch.train.state import (build_models,
                                                        init_train_state)
    from depth_lidar_nerf_tpu_torch.train.step import make_train_step

    d = torch.load(path, weights_only=False)
    tc, tr, hwf = d["cfg"]
    models = build_models(tc, tr, device="cpu")
    models.coarse.load_state_dict(d["coarse"])
    models.fine.load_state_dict(d["fine"])
    state = init_train_state(tc, models)
    step = make_train_step(tc, tr, models, hwf, mesh=mesh)
    m = step(state, *d["tables"], idx=d["idx"], idx_d=d["idx_d"])
    return {"metrics": {k: float(v) for k, v in m.items()},
            "params": _snapshot(state)}


def parallel_cases(rank, jax_inputs):
    """Everything ``test_torch_port_parallel.py`` needs of a 2-rank group:
    each step variant in one process, on the 2-rank mesh and (rank 0) on a
    1-rank mesh over NCCL's stand-in, gloo; the frames and the density grid
    with and without the mesh; the JAX-paired base step on the mesh."""
    import torch.distributed as dist

    from depth_lidar_nerf_tpu_torch.parallel.mesh import make_mesh

    mesh = make_mesh([2], device="cpu")
    one = dist.new_group([0])
    mesh1 = make_mesh([1], device="cpu", group=one) if rank == 0 else None
    out = {"variants": {}, "frames": {}}
    for name in VARIANTS:
        r = {"dp": variant_run(name, mesh)}
        if rank == 0:
            r["one"] = variant_run(name, None)
            r["world1"] = variant_run(name, mesh1)
        out["variants"][name] = r
    for name in FRAMES:
        r = {"dp": frame(name, mesh)}
        if rank == 0:
            r["one"] = frame(name, None)
        out["frames"][name] = r
    out["grid"] = {"dp": density_grid(mesh)}
    if rank == 0:
        out["grid"]["one"] = density_grid(None)
    out["jax_base"] = jax_base_run(jax_inputs, mesh)
    return out


def assert_same(a, b, what):
    """``a`` and ``b`` (nested dicts/lists of arrays) equal bit for bit."""
    if isinstance(a, dict):
        assert set(a) == set(b), (what, set(a) ^ set(b))
        for k in a:
            assert_same(a[k], b[k], f"{what}.{k}")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), what
        for i, (x, y) in enumerate(zip(a, b)):
            assert_same(x, y, f"{what}[{i}]")
    else:
        x, y = np.asarray(a), np.asarray(b)
        assert x.shape == y.shape and x.dtype == y.dtype, what
        assert x.tobytes() == y.tobytes(), (what, np.abs(
            x.astype(np.float64) - y.astype(np.float64)).max())


# ------------------------------------------------------------------ drivers

DRIVER_STEPS = 8  # a run stops at 8 (checkpoint) and resumes to 16


def driver_fields(scene, basedir, **kw):
    """The driver tests' config on ``scene``: 2 training views of 20 x 24
    (960 rgb rays, 160 depth rays: both even, so a row slice needs no
    padding and the batches are one process's), view 2 held out."""
    base = dict(expname="mh", basedir=basedir, datadir=scene,
                dataset_type="llff", factor=0, llffhold=0, test_scene=[2],
                N_rand=64, N_samples=8, N_importance=8, netdepth=2,
                netwidth=128, netdepth_fine=2, netwidth_fine=128,
                use_viewdirs=True, no_ndc=True, multires=4,
                multires_views=2, should_seed=True, colmap_depth=True,
                depth_loss=True, raw_noise_std=1.0, N_iters=2 * DRIVER_STEPS,
                i_print=4, i_weights=DRIVER_STEPS, i_testset=0, i_video=0,
                i_img=0, steps_per_dispatch=1)
    base.update(kw)
    return base


def multihost_driver(rank, scene, basedirs, coordinator):
    """A 2-process ``dist_coordinator`` run (the group is joined already):
    ``DRIVER_STEPS`` steps, then a resumed run to twice that. Each process
    writes under its own ``basedirs[rank]``, as hosts without a shared
    disk. Returns the metrics at each ``i_print``, the parameters, the row
    slices each process kept, and the files under its basedir."""
    from depth_lidar_nerf_tpu_torch.parallel import distributed as pdist
    from depth_lidar_nerf_tpu_torch.train.config import TrainConfig
    from depth_lidar_nerf_tpu_torch.train.loop import train

    os.chdir(basedirs[rank])
    kept = []
    orig = pdist.shard_table_rows

    def spy(local, lo, rows, device=None):
        kept.append((type(local).__name__, lo, local[0].shape[0], rows))
        return orig(local, lo, rows, device)

    pdist.shard_table_rows = spy
    hist = []
    states = []
    for n_iters in (DRIVER_STEPS, 2 * DRIVER_STEPS):
        cfg = TrainConfig(**driver_fields(
            scene, basedirs[rank], N_iters=n_iters,
            dist_coordinator=coordinator))
        st = train(cfg, device="cpu",
                   metrics_hook=lambda i, m: hist.append((i, m)))
        states.append(int(st.step))
    files = sorted(os.path.relpath(os.path.join(d, f), basedirs[rank])
                   for d, _, fs in os.walk(basedirs[rank]) for f in fs)
    return {"metrics": hist, "params": _snapshot(st), "steps": states,
            "kept": kept, "files": files}
