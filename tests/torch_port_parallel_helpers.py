"""Spawned gloo ranks for the port's data- and tensor-parallel tests
(``test_torch_port_parallel.py``, ``test_torch_port_multihost.py``,
``test_torch_port_tensor_parallel.py``).

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
    # The frozen-alpha model: the alpha MLP read from a checkpoint that
    # variant_run writes (ALPHA stands for its path).
    "alpha": (dict(alpha_model_path="ALPHA"), {}),
}
STEPS = 2
# A tensor-parallel run's fields over a variant's: JAX's route under tp > 1.
TP_FIELDS = dict(use_fused_mlp=False, mesh_shape=[2, 2])


def _scene(semantic=False):
    from depth_lidar_nerf_tpu_torch.data.synthetic import draw_scene

    return draw_scene(n_images=2, H=12, W=16, focal=14.0, n_depth_points=40,
                      seed=0, backdrop=True,
                      num_classes=19 if semantic else None)


def _snapshot(state, mesh=None):
    """Every parameter of ``state``, whole (gathered over the model group
    on a tensor-parallel ``mesh``: every rank of it calls this)."""
    from depth_lidar_nerf_tpu_torch.train.checkpoint import full_payload

    models = full_payload(state, {}, mesh)["models"]
    disc = state.models.discriminator
    nets = [("coarse", models["coarse"]), ("fine", models["fine"]),
            ("disc", None if disc is None else disc.state_dict())]
    return {f"{n}.{k}": v.detach().clone().numpy() for n, sd in nets
            if sd is not None for k, v in sd.items()}


def _alpha_checkpoint(cfg, rcfg, directory):
    """A checkpoint of this package holding seed 5's fine MLP of ``cfg``'s
    topology, for ``alpha_model_path``; returns its path."""
    from depth_lidar_nerf_tpu_torch.train import checkpoint
    from depth_lidar_nerf_tpu_torch.train.state import (build_models,
                                                        init_train_state)

    src = cfg.replace(alpha_model_path="", mesh_shape=None)
    state = init_train_state(src, build_models(src, rcfg, device="cpu",
                                               seed=5))
    path = os.path.join(directory, "alpha.pt")
    torch.save(checkpoint.state_payload(
        state, checkpoint.topology(src, rcfg.num_semantic_classes)), path)
    return path


def variant_run(name, mesh, **over):
    """``STEPS`` steps of variant ``name`` (its fields and ``over`` over
    BASE) from seeded weights and step generators, on ``mesh`` (None: one
    process): the metrics of each step, the parameters after them (the
    discriminator's too) and, for the grid variant, the ray CDF baked on
    the mesh. On a tensor-parallel mesh also this rank's parameter shapes
    and the gradients of the parameters that every rank holds whole."""
    import tempfile

    from depth_lidar_nerf_tpu_torch.ops.ray_cdf import bake_ray_cdf
    from depth_lidar_nerf_tpu_torch.train.config import (TrainConfig,
                                                         render_config_from)
    from depth_lidar_nerf_tpu_torch.train.state import (build_models,
                                                        init_train_state,
                                                        shard_train_state)
    from depth_lidar_nerf_tpu_torch.train.step import (PatchSource,
                                                       make_train_step)
    from depth_lidar_nerf_tpu_torch.train.tables import (build_depth_table,
                                                         build_rgb_table)

    fields, kw = VARIANTS[name]
    cfg = TrainConfig(**{**BASE, **fields, **over})
    sc = _scene(cfg.semantic_loss)
    rcfg = render_config_from(cfg, sc.num_classes if cfg.semantic_loss
                              else 0, sc.near, sc.far)
    tmp = tempfile.TemporaryDirectory()
    if cfg.alpha_model_path:
        cfg = cfg.replace(alpha_model_path=_alpha_checkpoint(cfg, rcfg,
                                                             tmp.name))
    # Split as the driver splits (train.checkpoint.broadcast_state).
    state = shard_train_state(init_train_state(
        cfg, build_models(cfg, rcfg, device="cpu", seed=0)), mesh)
    models = state.models
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
    out.update(metrics=metrics, params=_snapshot(state, mesh))
    if mesh is not None and mesh.tp > 1:
        nets = [("coarse", models.coarse), ("fine", models.fine)]
        out["shapes"] = {f"{n}.{k}": tuple(p.shape) for n, m in nets
                         for k, p in m.named_parameters()}
        out["replicated_grads"] = {
            f"{n}.{k}": p.grad.numpy().copy() for n, m in nets
            for k, p in m.named_parameters()
            if k.split(".")[0] not in m.sharded and p.grad is not None}
    tmp.cleanup()
    return out


FRAMES = {
    # (config fields over BASE, eval-config fields)
    "plain": (dict(use_fused_mlp=False), {}),
    "fused": (dict(use_fused_mlp=True), {}),
    "int8": (dict(use_fused_mlp=True), dict(render_int8=True)),
    "coarse_ds": (dict(use_fused_mlp=True),
                  dict(render_coarse_downsample=2)),
}


def frame(name, mesh, **over):
    """A held-out frame of seeded weights through ``render_image`` on
    ``mesh`` (None: one process), in tiles of ``chunk`` 40 (the last one
    ragged); ``over``: config fields over the frame's."""
    import dataclasses

    from depth_lidar_nerf_tpu_torch.render.renderer import render_image
    from depth_lidar_nerf_tpu_torch.train.config import (TrainConfig,
                                                         render_config_from)
    from depth_lidar_nerf_tpu_torch.train.state import (build_models,
                                                        shard_models)

    fields, ev = FRAMES[name]
    cfg = TrainConfig(**{**BASE, **fields, **over})
    sc = _scene()
    rcfg = dataclasses.replace(render_config_from(cfg, 0, sc.near, sc.far),
                               chunk=40, **ev)
    models = shard_models(build_models(cfg, rcfg, device="cpu", seed=0), mesh)
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
                                                        init_train_state,
                                                        shard_train_state)
    from depth_lidar_nerf_tpu_torch.train.step import make_train_step

    d = torch.load(path, weights_only=False)
    tc, tr, hwf = d["cfg"]
    models = build_models(tc, tr, device="cpu")
    models.coarse.load_state_dict(d["coarse"])
    models.fine.load_state_dict(d["fine"])
    state = shard_train_state(init_train_state(tc, models), mesh)
    step = make_train_step(tc, tr, state.models, hwf, mesh=mesh)
    m = step(state, *d["tables"], idx=d["idx"], idx_d=d["idx_d"])
    return {"metrics": {k: float(v) for k, v in m.items()},
            "params": _snapshot(state, mesh)}


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


# ------------------------------------------------------ tensor parallelism

TP_DRIVER = dict(N_rand=64, N_samples=8, N_importance=8, netdepth=2,
                 netwidth=32, netdepth_fine=2, netwidth_fine=32)


def tp_linear(mesh):
    """One ``nn.Linear`` of 12 -> 16 against its column-parallel form
    (``column_parallel_linear``) on this rank, forward and backward, in
    float32 and in bfloat16; and a no-grad call."""
    import torch.nn.functional as F

    from depth_lidar_nerf_tpu_torch.parallel.mesh import shard_rows
    from depth_lidar_nerf_tpu_torch.parallel.tensor import \
        column_parallel_linear

    gen = torch.Generator().manual_seed(0)
    lin = torch.nn.Linear(12, 16)
    with torch.no_grad():
        lin.weight.copy_(torch.randn(16, 12, generator=gen))
        lin.bias.copy_(torch.randn(16, generator=gen))
    x = torch.randn(5, 3, 12, generator=gen)
    g = torch.randn(5, 3, 16, generator=gen)
    out = {}
    for route in ("whole", "column", "column_bf16", "whole_bf16"):
        dtype = torch.bfloat16 if route.endswith("bf16") else torch.float32
        xi = x.to(dtype).clone().requires_grad_()
        w = lin.weight.detach().to(dtype)
        b = lin.bias.detach().to(dtype)
        if not route.startswith("whole"):
            w = shard_rows(w, mesh.tp, mesh.tp_rank)
            b = shard_rows(b, mesh.tp, mesh.tp_rank)
        w, b = w.clone().requires_grad_(), b.clone().requires_grad_()
        if route.startswith("whole"):
            y = F.linear(xi, w, b)
        else:
            y = column_parallel_linear(xi, w, b, mesh.model_group)
        y.backward(g.to(dtype))
        out[route] = {k: v.detach().float().numpy()
                      for k, v in (("y", y), ("dx", xi.grad),
                                   ("dw", w.grad), ("db", b.grad))}
    with torch.no_grad():
        out["no_grad"] = column_parallel_linear(
            x, shard_rows(lin.weight, mesh.tp, mesh.tp_rank),
            shard_rows(lin.bias, mesh.tp, mesh.tp_rank),
            mesh.model_group).numpy()
    return out


def tp_driver(rank, scene, basedir):
    """JAX ``test_cli_train_with_model_parallel_mesh`` on the port: the
    driver with colmap depth on ``mesh_shape [2, 2]`` for 10 steps (a
    checkpoint at 10), then resumed to 15 on the same mesh. Returns this
    rank's trunk shape, the steps, rank 0's printed lines, and (every rank
    gathers) the whole parameters of the final state."""
    import contextlib
    import io

    from depth_lidar_nerf_tpu_torch.parallel.mesh import make_mesh
    from depth_lidar_nerf_tpu_torch.train.config import TrainConfig
    from depth_lidar_nerf_tpu_torch.train.loop import train

    os.chdir(basedir)
    fields = dict(expname="mesh", basedir=basedir, datadir=scene,
                  dataset_type="llff", factor=0, llffhold=0, test_scene=[2],
                  use_viewdirs=True, no_ndc=True, i_print=5, i_testset=0,
                  i_video=0, multires=4, multires_views=2, should_seed=True,
                  colmap_depth=True, depth_loss=True, **TP_DRIVER,
                  **TP_FIELDS)
    text = io.StringIO()
    steps = []
    with contextlib.redirect_stdout(text):
        for n in (10, 15):
            st = train(TrainConfig(**fields, N_iters=n, i_weights=n),
                       device="cpu")
            steps.append(int(st.step))
    return {"steps": steps, "printed": text.getvalue(),
            "trunk": tuple(st.models.coarse.trunk_0.weight.shape),
            "params": _snapshot(st, make_mesh([2, 2], device="cpu"))}


def tensor_parallel_cases(rank, jax_inputs, scene, basedir):
    """Everything ``test_torch_port_tensor_parallel.py`` needs of a 4-rank
    group on a ``[2, 2]`` grid: the layer functions against ``nn.Linear``,
    the JAX-paired base step, every step variant on the grid and (rank 0)
    in one process, a frame on the grid and in one process, and the
    driver."""
    from depth_lidar_nerf_tpu_torch.parallel.mesh import make_mesh

    mesh = make_mesh([2, 2], device="cpu")
    out = {"ray_rank": mesh.rank, "tp_rank": mesh.tp_rank,
           "linear": tp_linear(mesh),
           "jax_base": jax_base_run(jax_inputs, mesh), "variants": {}}
    for name in VARIANTS:
        r = {"tp": variant_run(name, mesh, **TP_FIELDS)}
        if rank == 0:
            r["one"] = variant_run(name, None, use_fused_mlp=False)
        out["variants"][name] = r
    out["frame"] = {"tp": frame("plain", mesh)}
    if rank == 0:
        out["frame"]["one"] = frame("plain", None)
    out["driver"] = tp_driver(rank, scene, basedir)
    return out
