"""Training driver (port of ``train/loop.py``): the equivalent of the
reference's ``train()`` (``run_nerf.py:885-2025``).

:func:`train` loads a scene from disk (:func:`load_scene`), builds the models
and the device-resident ray tables, restores the newest checkpoint (or
``--ft_path``, including a reference ``.tar``), then either serves frames
(``--render_only``) or runs the step loop with the JAX driver's events:
``[TRAIN]`` lines every ``i_print`` steps from one device-to-host copy of the
stacked scalar metrics, a checkpoint every ``i_weights``, held-out views
every ``i_testset``, a held-out frame every ``i_img`` (with a summary
writer) and the spiral every ``i_video``.

Patch losses (``feature_loss``, ``depth_inverse_loss``, ``gan_loss``): every
iteration runs the step variant that :func:`train.step.build_step_fns` picks
for it (past ``gan_start_iteration`` every iteration is a GAN patch
iteration, as in JAX), and a patch iteration draws its crop on the device
from the training images (:class:`train.step.PatchSource`). The metrics of
a GAN iteration carry ``gan_loss`` and ``loss_dis``; they reach the
summary writer, as JAX's do. ``no_batching`` (with ``precrop_iters``) and
the frozen-alpha model (``alpha_model_path``, ``no_coarse``) train through
the same loop. The held-out ``[TEST]`` line carries the
views' mean LPIPS (AlexNet; weights from ``$LPIPS_TORCH_WEIGHTS`` if set,
else seed 0), as JAX's.

Grid training (``--grid_train``): past ``grid_train_after`` the steps are
grid steps (``train/step.py``), fed by a ray CDF baked along every table
ray (``ops/ray_cdf.py``) and rebaked every ``grid_rebake_every`` steps
beside a 3-D sigma grid (``ops/density_grid.py``) through which the eval
renders then go, since the coarse MLP no longer trains. ``--render_only``
with ``--render_grid R``, or of a grid-trained run, bakes a grid and serves
through it. JAX keeps no grid in a checkpoint: a resumed run rebakes at its
first grid step.

Randomness: step ``i`` draws from a ``torch.Generator`` on the tables' device
seeded with :func:`step_seed` ``(seed, i)``, where ``seed`` is ``cfg.seed``
under ``should_seed`` and 0 otherwise, as JAX folds ``i`` into its key; so a
resumed run continues the stream of an uninterrupted one. The host draws
(the ``i_img`` view) come from ``np.random.default_rng``, as in JAX.

JAX batches several steps into one dispatch (``steps_per_dispatch``,
``cycle_dispatch``) with the same trajectory; the port accepts both flags
and runs one step an iteration, the same trajectory (batching dispatches
is speed work, ROADMAP Queue 2, item 1).

Data parallelism over rays (JAX ``train/loop.py:726-807``), one process a
device: with ``mesh_shape [n]`` and no process group, :func:`train` makes
this process rank 0, starts ranks 1..n-1 (``parallel.distributed.
launch_local``) and returns rank 0's state; under torchrun (``RANK`` and
``WORLD_SIZE`` set) each process joins the group; with
``dist_coordinator`` (multi-host; ``python -m depth_lidar_nerf_tpu_torch.
train`` joins first) each process keeps only its row slice of the ray
tables, and the mid-run eval renders are off, as in JAX. Every rank draws
the same batches and takes the same steps (``train/step.py``); rank 0
alone prints, writes logs, images, videos and checkpoints, and a run
starts from rank 0's state. Single-host eval frames are split over the
ranks.

Tensor parallelism (JAX ``loop.py:772-785``): ``mesh_shape [dp, tp]`` with
``tp > 1`` starts ``dp * tp`` ranks on a ``dp x tp`` grid
(``parallel.mesh.make_mesh``); the MLPs' wide layers are split over each
model group (``train.state.shard_models``), the batch and the eval frames
over the ray groups, and the checkpoints hold the whole state. It takes
the plain modules: ``use_fused_mlp`` raises ``ValueError`` before anything
is written, as JAX's ``build_models`` does. "Rank 0" is global rank 0
(``parallel.mesh.is_rank0``). Under ``dist_coordinator`` ``mesh_shape`` is
ignored and the mesh is the ray mesh over every process, as in JAX.
"""

from __future__ import annotations

import contextlib
import dataclasses
import os
import shutil
import time
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

from depth_lidar_nerf_tpu_torch.data.depth import load_lidar_depth
from depth_lidar_nerf_tpu_torch.data.llff import load_llff_data
from depth_lidar_nerf_tpu_torch.data.semantic import load_semantic_data
from depth_lidar_nerf_tpu_torch.device import resolve_device
from depth_lidar_nerf_tpu_torch.evaluation.metrics import psnr as psnr_np
from depth_lidar_nerf_tpu_torch.evaluation.metrics import ssim_np
from depth_lidar_nerf_tpu_torch.models.lpips import init_lpips
from depth_lidar_nerf_tpu_torch.ops.density_grid import (bake_density_grid,
                                                         frustum_bounds)
from depth_lidar_nerf_tpu_torch.ops.ray_cdf import bake_ray_cdf
from depth_lidar_nerf_tpu_torch.ops.rays import rays_by_coord
from depth_lidar_nerf_tpu_torch.parallel import distributed as pdist
from depth_lidar_nerf_tpu_torch.parallel.mesh import is_rank0, make_mesh
from depth_lidar_nerf_tpu_torch.render.renderer import (RenderConfig,
                                                        make_rays,
                                                        render_image)
from depth_lidar_nerf_tpu_torch.train import checkpoint, losses
from depth_lidar_nerf_tpu_torch.train.config import (TrainConfig, dump_args,
                                                     eval_render_config,
                                                     render_config_from)
from depth_lidar_nerf_tpu_torch.train.state import (Models, build_models,
                                                    check_tp_route,
                                                    init_train_state,
                                                    make_optimizer)
from depth_lidar_nerf_tpu_torch.train.step import (PatchBatch, PatchSource,
                                                   build_step_fns)
from depth_lidar_nerf_tpu_torch.train.tables import (build_depth_table,
                                                     build_rgb_table)
from depth_lidar_nerf_tpu_torch.train.torch_import import \
    import_reference_checkpoint
from depth_lidar_nerf_tpu_torch.utils.images import write_png
from depth_lidar_nerf_tpu_torch.utils.tracing import span
from depth_lidar_nerf_tpu_torch.utils.visualization import depth_to_colormap


class Scene:
    """Loaded dataset bundle."""

    def __init__(self, images, poses, bds, render_poses, hwf, i_train, i_test,
                 depth_gts=None, segmentation=None, num_semantic_classes=0,
                 near=0.0, far=1.0):
        self.images = images
        self.poses = poses
        self.bds = bds
        self.render_poses = render_poses
        self.hwf = hwf
        self.i_train = i_train
        self.i_test = i_test
        self.depth_gts = depth_gts
        self.segmentation = segmentation
        self.num_semantic_classes = num_semantic_classes
        self.near = near
        self.far = far


def load_scene(cfg: TrainConfig) -> Scene:
    """Dataset dispatch + train/test split (run_nerf.py:905-982)."""
    if cfg.dataset_type == "llff":
        images, poses, bds, render_poses, i_test = load_llff_data(
            cfg.datadir, cfg.factor, recenter=True, bd_factor=0.75,
            spherify=cfg.spherify,
        )
        hwf = poses[0, :3, -1]
        H, W = int(hwf[0]), int(hwf[1])

        depth_gts = None
        if cfg.colmap_depth:
            depth_gts = load_lidar_depth(
                cfg.datadir, factor=cfg.factor, bd_factor=0.75,
                ndc_depth=not cfg.no_ndc,
            )
        segmentation = None
        num_sem = 0
        if cfg.semantic_loss:
            segmentation, num_sem = load_semantic_data(cfg.datadir, H=H, W=W)

        i_test = [i_test]
        if cfg.llffhold > 0:
            i_test = list(np.arange(images.shape[0])[:: cfg.llffhold])
        if cfg.test_scene is not None:
            i_test = list(cfg.test_scene)
        if i_test and i_test[0] < 0:
            i_test = []
        if cfg.train_scene is None:
            i_train = np.array(
                [i for i in range(images.shape[0]) if i not in i_test])
        else:
            i_train = np.array([i for i in cfg.train_scene if i not in i_test])

        if cfg.no_ndc:
            near, far = float(bds.min() * 0.9), float(bds.max() * 1.0)
        else:
            near, far = 0.0, 1.0

        return Scene(images, poses[:, :3, :4], bds, render_poses,
                     (H, W, float(hwf[2])), i_train, np.array(i_test, int),
                     depth_gts, segmentation, num_sem, near, far)

    if cfg.dataset_type == "dtu":
        from depth_lidar_nerf_tpu_torch.data.dtu import load_dtu_data

        images, poses, hwf = load_dtu_data(cfg.datadir)
        i_test = list(cfg.test_scene) if cfg.test_scene is not None else []
        if cfg.train_scene is None:
            i_train = np.array(
                [i for i in range(images.shape[0]) if i not in i_test])
        else:
            i_train = np.array([i for i in cfg.train_scene if i not in i_test])
        return Scene(images, poses[:, :3, :4], None, poses, tuple(hwf), i_train,
                     np.array(i_test, int), near=0.1, far=5.0)

    raise ValueError(f"unknown dataset_type {cfg.dataset_type!r}")


def _host(t: torch.Tensor) -> np.ndarray:
    return t.float().cpu().numpy()


def _make_patch_batch(cfg: TrainConfig, scene: Scene, host_rng,
                      device=None) -> PatchBatch:
    """A patch iteration's randomness drawn on the host (JAX
    ``_make_patch_batch``, ``run_nerf.py:1557-1568``): a training image, the
    crop's origin and the permutation of its pixels, on ``device`` (the
    card unless given). The driver draws on the device instead
    (:func:`train.step.sample_patch`)."""
    device = resolve_device(device)
    H, W, _ = scene.hwf
    if cfg.nH > H or cfg.nW > W:
        raise ValueError(f"patch {cfg.nH}x{cfg.nW} larger than image {H}x{W}")
    img_i = int(host_rng.choice(scene.i_train))
    start_h = int(host_rng.integers(0, H - cfg.nH + 1))
    start_w = int(host_rng.integers(0, W - cfg.nW + 1))
    perm = host_rng.permutation(cfg.nH * cfg.nW)
    gt = scene.images[img_i][start_h:start_h + cfg.nH,
                             start_w:start_w + cfg.nW]
    # The image's position in i_train, the rgb table's order (grid steps).
    img_pos = int(np.flatnonzero(np.asarray(scene.i_train) == img_i)[0])

    def dev(x, dtype):
        return torch.as_tensor(np.asarray(x), dtype=dtype, device=device)

    return PatchBatch(dev(scene.poses[img_i], torch.float32),
                      dev(gt, torch.float32), dev(start_h, torch.long),
                      dev(start_w, torch.long), dev(perm, torch.long),
                      dev(img_pos, torch.long))


def _test_lpips(model, rgbs, gts, device) -> float:
    """The held-out views' mean LPIPS (JAX ``_test_lpips``,
    ``run_nerf.py:1316,1934``) through ``model``, an :func:`init_lpips`."""
    vals = []
    with torch.no_grad():
        for r, g in zip(rgbs, gts):
            a, b = (torch.as_tensor(np.asarray(x, np.float32),
                                    device=device)[None] for x in (r, g))
            vals.append(model(a, b)[0])
    return float(torch.stack(vals).mean())


def _save_image_outputs(out, savedir, idx):
    """``NNN.png`` (rgb), ``NNN.npz`` (rgb, disp, acc, depth) and
    ``NNN_depth.png`` (jet depth) of one rendered frame (host arrays)."""
    write_png(os.path.join(savedir, f"{idx:03d}.png"),
              losses.to8b(out["rgb_map"]))
    np.savez(os.path.join(savedir, f"{idx:03d}.npz"), rgb=out["rgb_map"],
             disp=out["disp_map"], acc=out["acc_map"], depth=out["depth_map"])
    write_png(os.path.join(savedir, f"{idx:03d}_depth.png"),
              depth_to_colormap(out["depth_map"]))


def render_path(models: Models, render_poses, hwf, cfg_render: RenderConfig,
                render_factor: int = 0, device=None,
                savedir: Optional[str] = None, density_grid=None, mesh=None):
    """Render every pose (``run_nerf.py:268-359``); returns numpy stacks
    ``rgbs [F, H, W, 3]`` and ``disps [F, H, W]``. ``cfg_render`` is the
    eval config, ``train.config.eval_render_config(cfg, rcfg)``, which
    carries the serving modes (int8, fine-only, coarse-downsampled), and
    with a baked ``density_grid`` the grid fields. With ``savedir``, each
    frame's PNG, NPZ and depth PNG are written there. With a ``mesh`` each
    frame's rays are split over the ranks (``render_image``) and every rank
    gets the frames. Each frame is a ``frame`` span (``utils.tracing``), id
    its pose's index, whose copies to the host are a ``frame.to_host``
    span."""
    device = resolve_device(device)
    H, W, focal = hwf
    if render_factor:
        H, W, focal = H // render_factor, W // render_factor, focal / render_factor
    rgbs, disps = [], []
    for i, c2w in enumerate(render_poses):
        with span("frame", i):
            out = render_image(models.coarse, models.fine, int(H), int(W),
                               focal, np.asarray(c2w)[:3, :4], cfg_render,
                               device=device, density_grid=density_grid,
                               mesh=mesh)
            keys = ("rgb_map", "disp_map") + (
                ("acc_map", "depth_map") if savedir is not None else ())
            with span("frame.to_host"):
                maps = {k: _host(out[k]) for k in keys}
        rgbs.append(maps["rgb_map"])
        disps.append(maps["disp_map"])
        if savedir is not None:
            _save_image_outputs(maps, savedir, i)
    return np.stack(rgbs), np.stack(disps)


def grid_bounds_for_poses(rcfg: RenderConfig, poses, hwf,
                          render_factor: int = 0):
    """Bounds of a density-grid bake (JAX ``grid_bounds_for_poses``): the
    corner and centre rays of every pose, in the (possibly NDC-warped)
    space the renderer samples in, through ``frustum_bounds``."""
    H, W, focal = hwf
    if render_factor:
        H, W, focal = H // render_factor, W // render_factor, focal / render_factor
    H, W = int(H), int(W)
    coords = torch.tensor([(0, 0), (W - 1, 0), (0, H - 1), (W - 1, H - 1),
                           (W // 2, H // 2)], dtype=torch.float32)  # (x, y)
    ro_all, rd_all = [], []
    for c2w in np.asarray(poses):
        ro, rd = rays_by_coord(H, W, focal,
                               torch.as_tensor(c2w[:3, :4], dtype=torch.float32),
                               coords)
        ro_all.append(ro)
        rd_all.append(rd)
    rays = make_rays(torch.cat(ro_all), torch.cat(rd_all), rcfg, H, W, focal)
    return frustum_bounds(rays.origins.numpy(), rays.directions.numpy(),
                          rcfg.near, rcfg.far)


def bake_grid(rcfg: RenderConfig, models: Models, lo, hi, resolution: int,
              verbose: bool = True, mesh=None):
    """Bake the fine model's raw sigma (the coarse one's without a fine
    pass) to ``(grid, lo, hi)`` (JAX ``bake_grid``); shared by
    ``--render_grid`` serving and ``--grid_train``. With a ``mesh`` the
    ranks bake shares of the grid and gather them."""
    model = models.fine if models.fine is not None else models.coarse
    t0 = time.time()
    grid3 = bake_density_grid(model, rcfg, lo, hi, resolution, mesh=mesh)
    if grid3[0].device.type == "cuda":
        torch.cuda.synchronize(grid3[0].device)
    if verbose:
        print(f"baked {resolution}^3 density grid in {time.time() - t0:.1f}s"
              f" (bounds {np.round(np.asarray(lo), 2)}"
              f" .. {np.round(np.asarray(hi), 2)})")
    return grid3


def _bake_render_grid(cfg: TrainConfig, rcfg: RenderConfig, models: Models,
                      render_poses, hwf, mesh=None):
    """The ``--render_grid`` serving bake (JAX ``_bake_render_grid``):
    ``(grid3, rcfg with the grid fields)``, bounds from the poses served."""
    lo, hi = grid_bounds_for_poses(rcfg, render_poses, hwf, cfg.render_factor)
    return bake_grid(rcfg, models, lo, hi, cfg.render_grid,
                     verbose=is_rank0(mesh), mesh=mesh), \
        dataclasses.replace(rcfg, render_grid=cfg.render_grid,
                            render_grid_fine_only=cfg.render_grid_fine_only,
                            render_grid_samples=cfg.render_grid_samples)


def _write_videos(outdir, prefix, rgbs, disps):
    """mp4s through imageio, else GIFs through PIL, else a printed skip (JAX
    ``_write_videos``)."""
    try:
        import imageio.v2 as imageio

        imageio.mimwrite(os.path.join(outdir, prefix + "rgb.mp4"),
                         losses.to8b(rgbs), fps=30, quality=8)
        disps = np.nan_to_num(disps)
        imageio.mimwrite(
            os.path.join(outdir, prefix + "disp.mp4"),
            losses.to8b(disps / (np.percentile(disps, 95) + 1e-8)), fps=30,
            quality=8)
    except Exception:
        # No imageio or no mp4 codec in this environment: animated GIFs.
        try:
            from PIL import Image

            for name, stack in (("rgb", losses.to8b(rgbs)),
                                ("disp", losses.to8b(
                                    np.nan_to_num(disps)
                                    / (np.percentile(np.nan_to_num(disps), 95)
                                       + 1e-8)))):
                frames = [Image.fromarray(f if f.ndim == 3 else
                                          np.stack([f] * 3, -1))
                          for f in stack]
                frames[0].save(os.path.join(outdir, prefix + name + ".gif"),
                               save_all=True, append_images=frames[1:],
                               duration=33, loop=0)
        except Exception as e:
            print("video write skipped:", e)


def _validate_flags(cfg: TrainConfig) -> None:
    """Reject / warn on flags that would otherwise silently no-op (JAX
    ``_validate_flags``, with its messages)."""
    if cfg.depth_with_rgb:
        raise ValueError(
            "--depth_with_rgb is unsupported: the reference's own branch is "
            "broken (run_nerf.py:1466 keeps the concatenated-batch depth, so "
            "the depth MSE at :1503-1524 compares a [N_rgb+N_depth] render "
            "against an [N_depth] target and the RGB MSE at :1500 compares "
            "mismatched shapes too). Use the default separate depth-ray "
            "stream (depth_rays_prop).")
    if cfg.feature_loss and cfg.feature_loss_type not in ("vgg", "lpips"):
        # run_nerf.py:1245-1246 exits with the same message.
        raise ValueError("FEATURE LOSS TYPE CAN BE vgg OR lpips")
    if (cfg.feature_loss and cfg.feature_loss_type == "lpips"
            and cfg.lpips_backbone not in ("alex", "vgg", "squeeze")):
        raise ValueError(
            f"lpips_backbone={cfg.lpips_backbone!r} is not implemented; the "
            "Flax LPIPS ships 'alex' (the reference default, "
            "run_nerf.py:1242), 'vgg' (VGG16), and 'squeeze' "
            "(SqueezeNet1.1).")
    if (cfg.feature_loss and cfg.feature_loss_type == "lpips"
            and min(cfg.nH, cfg.nW) < 31):
        raise ValueError(
            f"LPIPS(alex) needs patches >= 31 px per side (the conv/pool "
            f"tap chain collapses below that); got nH={cfg.nH} nW={cfg.nW}. "
            "The torch lpips package fails on such patches too.")
    if cfg.render_grid > 0 and cfg.N_importance <= 0:
        raise ValueError(
            "--render_grid replaces the COARSE pass with a sigma-grid "
            "lookup and renders the image with the fine pass; with "
            "N_importance=0 there is no fine pass and every frame would be "
            "black. Use a fine pass (N_importance > 0) or drop "
            "--render_grid.")
    if cfg.render_grid > 0 and not cfg.render_only:
        print("[config] WARNING: --render_grid only applies to "
              "--render_only serving; training-time eval renders "
              "(i_img/i_testset/i_video) keep the full coarse MLP pass.")
    if (cfg.render_grid_fine_only or cfg.render_grid_samples) \
            and cfg.render_grid <= 0:
        raise ValueError(
            "--render_grid_fine_only / --render_grid_samples refine the "
            "baked-grid serving mode and need --render_grid R to be set.")
    if cfg.render_fine_only and cfg.N_importance <= 0:
        raise ValueError(
            "--render_fine_only renders the image with the fine pass over "
            "the importance samples; with N_importance=0 there is no fine "
            "pass. Use N_importance > 0 or drop --render_fine_only.")
    if cfg.grid_train:
        if cfg.N_importance <= 0:
            raise ValueError(
                "--grid_train replaces the COARSE pass with a baked-grid "
                "lookup; with N_importance=0 there is no fine pass to train. "
                "Use N_importance > 0 or drop --grid_train.")
        if cfg.alpha_model_path or cfg.no_coarse:
            raise ValueError(
                "--grid_train is incompatible with the frozen-alpha paths "
                "(--alpha_model_path / --no_coarse): both already replace "
                "the coarse field with something fixed.")
        if cfg.grid_train_res <= 1 or cfg.grid_rebake_every <= 0:
            raise ValueError(
                "--grid_train needs grid_train_res > 1 and "
                "grid_rebake_every > 0.")
    if ((cfg.grid_train_fine_only or cfg.grid_train_samples
         or cfg.patch_render_samples) and not cfg.grid_train):
        raise ValueError(
            "--grid_train_fine_only / --grid_train_samples / "
            "--patch_render_samples refine --grid_train and need it to "
            "be set.")
    defaults = TrainConfig()
    for name in ("testskip", "shape", "half_res"):
        if getattr(cfg, name) != getattr(defaults, name):
            print(f"[config] WARNING: --{name} is vestigial (it only fed the "
                  "blender/deepvoxels loaders the reference dropped); it has "
                  "no effect.")


def dispatch_k_max(cfg: TrainConfig) -> int:
    """JAX ``dispatch_k_max``: the steps JAX would batch into one dispatch."""
    k_auto = min(32, max(1, 16384 // max(1, cfg.N_rand)))
    return cfg.steps_per_dispatch if cfg.steps_per_dispatch > 0 else k_auto


def step_seed(seed: int, i: int) -> int:
    """The seed of step ``i``'s generator: the first 64-bit word that numpy's
    ``SeedSequence([seed, i])`` generates, a fixed function of both."""
    return int(np.random.SeedSequence([seed, i]).generate_state(1, np.uint64)[0])


def _summary_writer(expname: str):
    """tensorboardX's writer, else torch's, else None (JAX
    ``loop.py:866-872``)."""
    for mod in ("tensorboardX", "torch.utils.tensorboard"):
        try:
            module = __import__(mod, fromlist=["SummaryWriter"])
            return module.SummaryWriter(os.path.join("runs", expname))
        except Exception:
            continue
    return None


def train(cfg: TrainConfig, metrics_hook=None, device=None):
    """Run the training loop on ``device`` (``cuda`` unless given) and return
    the :class:`~train.state.TrainState`. ``metrics_hook(i, metrics_dict)``,
    when given, receives the host-fetched scalar metrics at every
    ``i_print`` boundary (the values printed and logged; in a data-parallel
    run, on every rank that has one). With ``debug``
    or ``debug_nans``, autograd's anomaly detection is on for the run.

    With ``mesh_shape [n]`` (n > 1) or ``dist_coordinator`` the run is data
    parallel, with ``mesh_shape [dp, tp]`` also tensor parallel (the
    module's note): without a process group this process
    joins one (``dist_coordinator``, or torchrun's variables) or, for
    ``mesh_shape``, starts the other ranks itself; on the CPU the ranks
    talk over gloo, on the card over NCCL, one card a rank. The ranks
    that this process starts get no ``metrics_hook``."""
    device_type = resolve_device(device).type
    _validate_flags(cfg)
    check_tp_route(cfg)
    n = int(np.prod(cfg.mesh_shape)) if cfg.mesh_shape else 1
    if (n > 1 or cfg.dist_coordinator) and not dist.is_initialized():
        if cfg.dist_coordinator:
            pdist.init_distributed(cfg.dist_coordinator,
                                   cfg.dist_num_processes,
                                   cfg.dist_process_id, device_type)
        elif "RANK" in os.environ and "WORLD_SIZE" in os.environ:
            pdist.init_distributed(None, device=device_type)
        else:
            return pdist.launch_local(n, _train_rank,
                                      (cfg, None, device_type),
                                      (cfg, metrics_hook, device_type),
                                      device_type)
    return _train_rank(cfg, metrics_hook, device)


def _train_rank(cfg: TrainConfig, metrics_hook, device):
    """:func:`train` on this process, on the mesh of the process group
    when the config asks for one (under ``dist_coordinator`` the ray mesh
    over every process, whatever ``mesh_shape`` says, as in JAX)."""
    mesh = None
    if dist.is_initialized() and (cfg.dist_coordinator or (
            cfg.mesh_shape and int(np.prod(cfg.mesh_shape)) > 1)):
        device = pdist.rank_device(dist.get_rank(),
                                   resolve_device(device).type)
        mesh = make_mesh(None if cfg.dist_coordinator else cfg.mesh_shape,
                         device=device, row_sliced=bool(cfg.dist_coordinator))
    device = resolve_device(device)
    with torch.autograd.set_detect_anomaly(bool(cfg.debug_nans or cfg.debug)):
        return _train(cfg, metrics_hook, device, mesh)


def _row_sliced_table(table, mesh, device):
    """This process's row slice of a table (JAX ``_to_global_table``):
    padded to a multiple of the world size by repeating row 0, sliced,
    moved to ``device``."""
    table, rows = pdist.pad_rows(table, mesh.size)
    lo, hi = pdist.process_row_slice(rows, group=mesh.group)
    local = type(table)(*(None if x is None else x[lo:hi] for x in table))
    return pdist.shard_table_rows(local, lo, rows, device)


def _train(cfg: TrainConfig, metrics_hook, device: torch.device, mesh=None):
    scene = load_scene(cfg)
    H, W, focal = scene.hwf
    rcfg = render_config_from(cfg, scene.num_semantic_classes, scene.near,
                              scene.far)
    # Eval renders (i_img/i_testset/i_video/render_only) take the serving
    # modes; training keeps rcfg.
    rcfg_r = eval_render_config(cfg, rcfg)

    rank0 = is_rank0(mesh)
    expdir = os.path.join(cfg.basedir, cfg.expname)
    if rank0:
        os.makedirs(expdir, exist_ok=True)
        with open(os.path.join(expdir, "args.txt"), "w") as f:
            f.write(dump_args(cfg))
        if cfg.config:
            shutil.copyfile(cfg.config, os.path.join(expdir, "config.txt"))

    seed = cfg.seed if cfg.should_seed else 0
    host_rng = np.random.default_rng(cfg.seed if cfg.should_seed else None)

    models = build_models(cfg, rcfg, device=device, seed=seed)
    state = init_train_state(cfg, models)
    topo = checkpoint.topology(cfg, rcfg.num_semantic_classes)
    ckdir = checkpoint.ckpt_dir(cfg.basedir, cfg.expname)

    start = 0
    # Under a mesh rank 0 restores, and its state goes to every rank below.
    if rank0 and cfg.ft_path:
        # Pin a specific checkpoint (run_nerf.py:449-450) instead of the
        # latest of the experiment: a file of this package or a reference
        # .tar (which also carries a JAX run: export_reference_checkpoint).
        if os.path.isdir(cfg.ft_path):
            raise ValueError(
                f"--ft_path {cfg.ft_path} is a directory (an orbax checkpoint "
                "of the JAX package?); the port reads files: write one with "
                "JAX depth_lidar_nerf_tpu.train.torch_import."
                "export_reference_checkpoint(state, 'run.tar') and pass "
                "--ft_path run.tar")
        ckpt = checkpoint.load_file(cfg.ft_path)
        if "network_fn_state_dict" in ckpt:
            state = import_reference_checkpoint(
                ckpt, state, load_optimizer=not cfg.no_reload_optimizer,
                source=cfg.ft_path)
        else:
            state = checkpoint.restore(ckpt, state, topo, source=cfg.ft_path)
        start = int(state.step)
        print(f"loaded --ft_path checkpoint {cfg.ft_path} (step {start})")
    elif rank0 and not cfg.no_reload:
        last = checkpoint.latest_step(ckdir)
        if last is not None:
            state = checkpoint.restore(
                checkpoint.load_file(checkpoint.path_of(ckdir, last)), state,
                topo, source=checkpoint.path_of(ckdir, last))
            start = int(state.step)
            print(f"resumed from checkpoint at step {start}")
    if mesh is not None:
        # Every rank gets rank 0's state, and on a model axis its part.
        state = checkpoint.broadcast_state(state, topo, mesh)
        models = state.models
        start = int(state.step)
    if start > 0 and cfg.no_reload_optimizer:
        # run_nerf.py:462: keep the freshly initialized optimizer state.
        state.optimizer = make_optimizer(
            cfg, [p for m in models.nerfs() for p in m.parameters()])
        if rank0:
            print("--no_reload_optimizer: optimizer state reset")

    # ---------------- render-only short-circuit (run_nerf.py:1030-1114) ----
    if cfg.render_only:
        if cfg.render_test_ray and not rank0:
            return state
        if cfg.render_test_ray:
            # Depth-ray 3D visualization (run_nerf.py:1048-1101): export the
            # first train view's depth-supervised rays + frusta as PLY.
            from depth_lidar_nerf_tpu_torch.ops.rays import rays_by_coord
            from depth_lidar_nerf_tpu_torch.utils.camera_viz import (
                export_camera_frustums, export_depth_rays)

            savedir = os.path.join(expdir, f"renderonly_rays_{start:06d}")
            os.makedirs(savedir, exist_ok=True)
            idx = int(scene.i_train[0])
            d = scene.depth_gts[idx]
            ro, rd = rays_by_coord(
                H, W, focal, torch.as_tensor(scene.poses[idx], dtype=torch.float32),
                torch.as_tensor(d["coord"], dtype=torch.float32))
            export_depth_rays(ro.numpy(), rd.numpy(), np.asarray(d["depth"]),
                              os.path.join(savedir, "depth_rays.ply"))
            export_camera_frustums(scene.poses,
                                   os.path.join(savedir, "cameras.ply"))
            print("wrote ray visualization to", savedir)
            return state
        if cfg.render_test:
            poses = scene.poses[scene.i_test]
            tag = "test"
        elif cfg.render_train:
            poses = scene.poses[scene.i_train]
            tag = "train"
        elif cfg.render_mypath:
            # run_nerf.py:995: spiral around test pose index 3 (the last
            # available test pose when there are fewer than 4).
            from depth_lidar_nerf_tpu_torch.data.poses import generate_render_path

            pool = scene.poses[scene.i_test] if len(scene.i_test) else \
                scene.poses
            k = min(3, len(pool) - 1)
            poses = generate_render_path(pool[k:k + 1], scene.hwf[2],
                                         sc=1.0)[:, :3, :4]
            tag = "mypath"
        else:
            poses = np.asarray(scene.render_poses)[:, :3, :4]
            tag = "path"
        savedir = os.path.join(expdir, f"renderonly_{tag}_{start:06d}")
        if rank0:
            os.makedirs(savedir, exist_ok=True)
        grid3, rcfg_ro = None, rcfg_r
        if cfg.render_grid > 0 or cfg.grid_train:
            # A grid-trained checkpoint's coarse MLP stopped training at
            # grid_train_after: it is served through a baked grid.
            eff = cfg if cfg.render_grid > 0 else cfg.replace(
                render_grid=cfg.grid_train_res,
                render_grid_fine_only=cfg.grid_train_fine_only,
                render_grid_samples=cfg.grid_train_samples)
            grid3, rcfg_ro = _bake_render_grid(eff, rcfg_r, models, poses,
                                               scene.hwf, mesh)
        rgbs, disps = render_path(models, poses, scene.hwf, rcfg_ro,
                                  cfg.render_factor, device,
                                  savedir if rank0 else None, grid3, mesh)
        if rank0:
            _write_videos(savedir, "", rgbs, disps)
            print("Done rendering", savedir)
        return state

    # ------------------------------ tables --------------------------------
    # Multi-host tables are sliced on the host: a process's device holds
    # only its rows.
    row_sliced = mesh is not None and mesh.row_sliced
    table_device = "cpu" if row_sliced else device
    rgb_table = build_rgb_table(scene.images, scene.poses, scene.i_train,
                                H, W, focal, rcfg, scene.segmentation,
                                device=table_device)
    depth_table = None
    if cfg.colmap_depth:
        depth_table = build_depth_table(scene.depth_gts, scene.poses,
                                        scene.i_train, H, W, focal, rcfg,
                                        device=table_device)
    if row_sliced:
        # Multi-host: each process keeps only its row slice of the tables;
        # a step collects its batch's rows from the others.
        rgb_table = _row_sliced_table(rgb_table, mesh, device)
        if depth_table is not None:
            depth_table = _row_sliced_table(depth_table, mesh, device)
        # Host-divergent mid-run renders would desynchronise the processes
        # (collectives must be entered by all); as JAX, render the saved
        # checkpoints with --render_only instead.
        cfg = dataclasses.replace(cfg, i_testset=0, i_img=0, i_video=0)
        if rank0:
            print(f"multi-host ray-DP mesh: {mesh.size} processes x 1 local "
                  f"device = {mesh.size} global")
    elif mesh is not None and rank0:
        kind = f"ray-DP x {mesh.tp}-way model-TP" if mesh.tp > 1 else "ray-DP"
        print(f"{kind} mesh over {mesh.size * mesh.tp} devices")
    plan = build_step_fns(cfg, rcfg, models, scene.hwf, mesh=mesh)
    patch_source = None
    if cfg.feature_loss or cfg.gan_loss or cfg.depth_inverse_loss:
        patch_source = PatchSource(
            torch.as_tensor(scene.images[scene.i_train], dtype=torch.float32,
                            device=device),
            torch.as_tensor(scene.poses[scene.i_train], dtype=torch.float32,
                            device=device))
    test_lpips = None
    if (rank0 and cfg.i_testset > 0 and len(scene.i_test) > 0
            and min(H, W) >= 31):
        # Built and run once before the loop (JAX warms its jit here).
        # AlexNet's taps vanish below 31 px a side; JAX's LPIPS then fails
        # and its [TEST] line goes without it, as the port's.
        test_lpips = init_lpips(
            weights_path=os.environ.get("LPIPS_TORCH_WEIGHTS"), device=device)
        zero = np.zeros((H, W, 3), np.float32)
        _test_lpips(test_lpips, [zero], [zero], device)
    k_max = dispatch_k_max(cfg)
    if k_max > 1 and rank0:
        print(f"[config] the JAX driver batches up to {k_max} steps into one "
              "dispatch (steps_per_dispatch, cycle_dispatch; same trajectory); "
              "the port runs one step an iteration")

    writer = None
    if rank0:
        print(f"TRAIN views: {list(scene.i_train)}  "
              f"TEST views: {list(scene.i_test)}")
        writer = _summary_writer(cfg.expname)
    profile = bool(cfg.profile_dir) and rank0 and cfg.N_iters > start
    try:
        with (_interval_profiler(cfg, start, device) if profile
              else contextlib.nullcontext()) as prof:
            _loop(cfg, metrics_hook, device, scene, models, state,
                  (plan, patch_source, test_lpips), rgb_table, depth_table,
                  rcfg, rcfg_r, seed, host_rng, writer, expdir, ckdir, topo,
                  start, mesh, prof)
    finally:
        if writer:
            writer.close()
    _save(ckdir, state, cfg.N_iters, topo, mesh)
    return state


def _interval_profiler(cfg: TrainConfig, start: int, device):
    """``torch.profiler`` over one print interval: the run's second (steps
    ``start + i_print + 1`` to ``start + 2 i_print``), or its last when the
    run is shorter. The loop calls its ``step()`` after each iteration; it
    writes ``<profile_dir>/trace.json`` when the interval has ended: the
    program's spans (``utils.tracing``: each step's phases, the driver's
    ``loop.*`` events, the eval frames) above the kernels they launched."""
    n = max(cfg.i_print, 1)
    hi = min(start + 2 * n, cfg.N_iters)
    lo = max(start + 1, hi - n + 1)
    warmup = min(1, lo - start - 1)  # the step before, where there is one
    acts = [torch.profiler.ProfilerActivity.CPU]
    if device.type == "cuda":
        acts.append(torch.profiler.ProfilerActivity.CUDA)

    def write(prof):
        os.makedirs(cfg.profile_dir, exist_ok=True)
        prof.export_chrome_trace(os.path.join(cfg.profile_dir, "trace.json"))

    return torch.profiler.profile(
        activities=acts, on_trace_ready=write,
        schedule=torch.profiler.schedule(
            skip_first=lo - start - 1 - warmup, wait=0, warmup=warmup,
            active=hi - lo + 1, repeat=1))


def _save(ckdir, state, step, topo, mesh=None):
    """Checkpoint ``state`` as ``step`` (a ``loop.save`` span). Every rank
    calls it (a tensor-parallel save gathers)."""
    with span("loop.save", step):
        checkpoint.save_state(ckdir, state, step, topo, mesh=mesh)


class _Grid:
    """Grid training's baked state (JAX ``train/loop.py:811-860``): the ray
    CDF of the steps and the 3-D grid of the eval renders, rebaked together
    from the live fine model when first needed and then every
    ``grid_rebake_every`` steps."""

    def __init__(self, cfg: TrainConfig, rcfg: RenderConfig, rcfg_r, scene,
                 models, rgb_table, depth_table, mesh=None):
        self.cfg, self.rcfg, self.models, self.mesh = cfg, rcfg, models, mesh
        self.tables = (rgb_table, depth_table)
        poses = [scene.poses]
        if scene.render_poses is not None and len(scene.render_poses):
            poses.append(np.asarray(scene.render_poses)[:, :3, :4])
        self.bounds = grid_bounds_for_poses(rcfg, np.concatenate(poses),
                                            scene.hwf)
        # JAX sets only the resolution on the eval config here.
        self.rcfg_eval = dataclasses.replace(rcfg_r,
                                             render_grid=cfg.grid_train_res)
        self.cdf = self.grid3 = None
        self.last = -1

    def due(self, i: int) -> bool:
        return self.cdf is None or i - self.last >= self.cfg.grid_rebake_every

    def rebake(self, i: int):
        cfg = self.cfg
        t0 = time.time()
        self.cdf = bake_ray_cdf(self.models, self.rcfg, *self.tables,
                                cfg.grid_train_samples or cfg.N_samples,
                                mesh=self.mesh)
        dev = self.cdf.z.device
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        t1 = time.time()
        rank0 = is_rank0(self.mesh)
        self.grid3 = bake_grid(self.rcfg, self.models, *self.bounds,
                               cfg.grid_train_res,
                               verbose=self.last < 0 and rank0, mesh=self.mesh)
        if os.environ.get("DLNERF_LOG_REBAKE", "0") == "1" and rank0:
            print(f"[grid] rebake@{i}: cdf {t1 - t0:.2f}s, "
                  f"grid3 {time.time() - t1:.2f}s")
        self.last = i


def _test_report(i, rgbs, gts, test_lpips, device, writer):
    """The ``[TEST]`` line of the held-out views' frames and its scalars."""
    t_psnr = float(np.mean([psnr_np(r, g) for r, g in zip(rgbs, gts)]))
    t_ssim = float(np.mean([ssim_np(r, g) for r, g in zip(rgbs, gts)]))
    t_lpips = (None if test_lpips is None
               else _test_lpips(test_lpips, rgbs, gts, device))
    print(f"[TEST] iter {i} psnr {t_psnr:.2f} ssim {t_ssim:.4f}"
          + (f" lpips {t_lpips:.4f}" if t_lpips is not None else ""))
    if writer:
        writer.add_scalar("Test/psnr", t_psnr, i)
        writer.add_scalar("Test/ssim", t_ssim, i)
        if t_lpips is not None:
            writer.add_scalar("Test/lpips", t_lpips, i)


def _loop(cfg: TrainConfig, metrics_hook, device, scene: Scene, models,
          state, step_fns, rgb_table, depth_table, rcfg, rcfg_r, seed,
          host_rng, writer, expdir, ckdir, topo, start, mesh=None,
          prof=None):
    """Steps ``start + 1 .. N_iters`` with their events. Under a ``mesh``
    every rank takes the steps and renders the eval frames; rank 0 alone
    prints and writes. The metric fetch, the checkpoint saves and the
    held-out evaluation are ``loop.fetch``, ``loop.save`` and ``loop.test``
    spans (``utils.tracing``), id the step. ``prof`` (``--profile_dir``'s
    profiler) is stepped after each iteration."""
    H, W, focal = scene.hwf
    plan, patch_source, test_lpips = step_fns
    rank0 = is_rank0(mesh)
    # Every rank renders the held-out frame when rank 0 has a writer.
    has_writer = pdist.broadcast_object(writer is not None, mesh)
    grid = _Grid(cfg, rcfg, rcfg_r, scene, models, rgb_table,
                 depth_table, mesh) if cfg.grid_train else None

    def eval_view():
        """(density_grid, rcfg) of eval renders: through the grid once one
        is baked, since the coarse MLP no longer trains."""
        if grid is None or grid.grid3 is None:
            return None, rcfg_r
        return grid.grid3, grid.rcfg_eval

    gen = torch.Generator(device=device)
    t0 = time.time()
    rays_done = 0
    for i in range(start + 1, cfg.N_iters + 1):
        gen.manual_seed(step_seed(seed, i))
        grid_on = plan.variant_key(i)[4]
        if grid_on and grid.due(i):
            grid.rebake(i)
        step_fn, needs_patch = plan.select(i)
        metrics = step_fn(state, rgb_table, depth_table, gen,
                          aux=grid.cdf if grid_on else None,
                          patch=patch_source if needs_patch else None)
        rays_done += cfg.N_rand

        if cfg.i_print > 0 and i % cfg.i_print == 0 and (
                rank0 or metrics_hook is not None):
            # The metrics are the same on every rank; rank 0 prints them.
            # ONE device->host copy for all scalar metrics.
            with span("loop.fetch", i):
                # Maps (the LPIPS spatial map) go to the writer as images.
                maps = {k: _host(v) for k, v in metrics.items()
                        if v.dim() >= 2}
                names = [k for k, v in metrics.items() if v.dim() < 2]
                packed = torch.stack([metrics[k].to(device, torch.float32)
                                      for k in names]).cpu().numpy()
            m = {k: float(x) for k, x in zip(names, packed)}
            dt = time.time() - t0
            rps = rays_done / dt if dt > 0 else 0.0
            if rank0:
                print(f"[TRAIN] iter {i} loss {m['loss']:.5f} "
                      f"psnr {m['psnr']:.2f} rays/s {rps:,.0f}")
            if metrics_hook is not None:
                metrics_hook(i, m)
            if writer:
                for k, v in m.items():
                    writer.add_scalar(f"Train/{k}", v, i)
                writer.add_scalar("Train/rays_per_sec", rps, i)
                for k, v in maps.items():
                    # e.g. the LPIPS spatial map (run_nerf.py:1716-1719).
                    writer.add_image(f"Images/{k}", v, i, dataformats="HW")
            t0 = time.time()
            rays_done = 0

        if cfg.i_weights > 0 and i % cfg.i_weights == 0:
            _save(ckdir, state, i, topo, mesh)

        if cfg.i_testset > 0 and i % cfg.i_testset == 0 and len(scene.i_test) > 0:
            with span("loop.test", i):
                testdir = os.path.join(expdir, f"testset_{i:06d}")
                if rank0:
                    os.makedirs(testdir, exist_ok=True)
                grid3, rcfg_e = eval_view()
                rgbs, _ = render_path(models, scene.poses[scene.i_test],
                                      scene.hwf, rcfg_e, device=device,
                                      savedir=testdir if rank0 else None,
                                      density_grid=grid3, mesh=mesh)
                if rank0:
                    _test_report(i, rgbs, scene.images[scene.i_test],
                                 test_lpips, device, writer)

        if (cfg.i_img > 0 and i % cfg.i_img == 0 and has_writer
                and len(scene.i_test) > 0):
            # Validation-view image logging (run_nerf.py:1995-2014).
            img_i = pdist.broadcast_object(
                int(host_rng.choice(scene.i_test)) if rank0 else None, mesh)
            grid3, rcfg_e = eval_view()
            out = render_image(models.coarse, models.fine, H, W, focal,
                               scene.poses[img_i], rcfg_e, device=device,
                               density_grid=grid3, mesh=mesh)
            if rank0:
                rgb = _host(out["rgb_map"])
                writer.add_image("Images/rgb_holdout", losses.to8b(rgb), i,
                                 dataformats="HWC")
                writer.add_image("Images/depth_holdout",
                                 depth_to_colormap(_host(out["depth_map"])),
                                 i, dataformats="HWC")
                writer.add_scalar("Val/psnr_holdout",
                                  psnr_np(rgb, scene.images[img_i]), i)

        if cfg.i_video > 0 and i % cfg.i_video == 0:
            grid3, rcfg_e = eval_view()
            rgbs, disps = render_path(models, scene.render_poses, scene.hwf,
                                      rcfg_e, device=device,
                                      density_grid=grid3, mesh=mesh)
            if rank0:
                _write_videos(expdir, f"{cfg.expname}_spiral_{i:06d}_", rgbs,
                              disps)
        if prof is not None:
            prof.step()
