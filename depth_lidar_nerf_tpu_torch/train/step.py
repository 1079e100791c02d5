"""The training step (port of ``train/step.py``).

One step of the reference's hot loop (``run_nerf.py:1320-1847``) with RGB and
LiDAR-depth supervision: gather a ray batch from the device-resident tables,
render it (coarse + fine) under autograd, the RGB losses of both passes, the
depth loss, with ``sigma_loss`` the DS-NeRF sigma loss of the depth rays,
and with ``semantic_loss`` the semantic cross-entropy of both passes on the
RGB rays, backward, and one Adam step. On the card the MLP passes run the
fused kernels (forward, culled or dense recompute backward, and the
saved-activation pair for the fine pass, or under ``DLNERF_CULL_FWD=1`` the
early-terminating forward; with a semantic head, the semantic
saved-activation pair for both passes), the sigma loss's raw query runs the
packed-lane pair (kernels 12 and 13), and sampling runs its kernel.

Grid training (``grid_mode``, JAX ``--grid_train`` past
``grid_train_after``): the coarse pass becomes a row gather of weights
baked along every table ray (``ops/ray_cdf.py``) and an inverse CDF; no
coarse MLP runs, and the coarse loss terms go.

The patch variants (``feature_on``, ``smooth_on``, ``gan_on``;
``run_nerf.py:1552-1816``) add the losses of a rendered ``nH x nW`` crop of
one training image: the image-aware inverse-depth smoothness, the feature
loss (VGG19 content loss or LPIPS) and the adversarial loss, after whose
NeRF update the discriminator takes its own step on the detached crops.
As the reference (``run_nerf.py:1600-1644``), only
``gradH x gradW`` of the crop's rays, the first of a random permutation,
render under autograd (the grad leg); the rest render under
``torch.no_grad()`` (the no-grad leg: no activations saved, the fused
forward kernels, tiled), and both scatter back into the crop. The driver
picks a variant per iteration (:func:`build_step_fns`).

With ``no_batching`` the RGB rays come from one image, inside its central
``precrop_frac`` window while ``precrop_on`` (``run_nerf.py:1376-1404``).

The JAX step compiles into one XLA program; here each step is eager PyTorch
around the kernels, one step a dispatch (JAX's K-step and period dispatch
give the same trajectory; batching dispatches is speed work, ROADMAP Queue
2, item 1).

Data parallelism (``mesh=``, a :class:`~parallel.mesh.RayMesh`): every rank
draws the same global batch, renders its contiguous shard of each leg's
rays (the step's rays, the sigma term's, the patch's grad and no-grad legs)
drawing for the whole leg, and the per-ray outputs are gathered
(:func:`~parallel.gather.run_sharded`); every loss term then runs on the
gathered batch as in one process, and the gradients are summed over the
ranks before the optimizer's step. The discriminator's step and the Adam
updates run on every rank on the same inputs, unreduced.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Callable, Dict, NamedTuple, Optional

import numpy as np
import torch

from depth_lidar_nerf_tpu_torch.models.vgg import vgg_normalize
from depth_lidar_nerf_tpu_torch.ops.ray_cdf import RayCDF
from depth_lidar_nerf_tpu_torch.ops.rays import patch_ray_dirs
from depth_lidar_nerf_tpu_torch.ops.sampling import (draw_rows, sample_pdf,
                                                     stratified_z_vals)
from depth_lidar_nerf_tpu_torch.ops.sampling_cuda import sample_pdf_cuda
from depth_lidar_nerf_tpu_torch.parallel.distributed import (RowShard,
                                                             table_rows,
                                                             take_rows)
from depth_lidar_nerf_tpu_torch.parallel.gather import (all_reduce_grads,
                                                        run_sharded)
from depth_lidar_nerf_tpu_torch.render.renderer import (RenderConfig, Rays,
                                                        _composite_from_z,
                                                        _rows, make_rays,
                                                        pick_render_tile,
                                                        query_network,
                                                        render_rays,
                                                        render_rays_tiled)
from depth_lidar_nerf_tpu_torch.train import losses
from depth_lidar_nerf_tpu_torch.train.config import TrainConfig
from depth_lidar_nerf_tpu_torch.train.state import (Models, TrainState,
                                                    invalidate_packs)
from depth_lidar_nerf_tpu_torch.train.tables import (DepthRayTable,
                                                     RgbRayTable, gather_rays)
from depth_lidar_nerf_tpu_torch.utils.tracing import span

# The no-grad patch leg's ray tiles (JAX ``ng_render``): the fused forward
# keeps no activations, so a tile may be 16,384 rays; a pass that misses the
# kernels takes the plain module, whose activations cap it at 4,096.
NG_FUSED_CAP, NG_PLAIN_CAP = 16384, 4096

# The per-ray outputs that a sharded leg gathers: those the losses read.
GATHERED = ("rgb_map", "depth_map", "acc_map", "rgb0", "depth_map0",
            "sem_preds", "sem_preds0")


class PatchBatch(NamedTuple):
    """One patch iteration's crop and grad/no-grad split (JAX
    ``PatchBatch``), on the tables' device."""

    c2w: torch.Tensor  # [3, 4] pose of the image
    gt_patch: torch.Tensor  # [nH, nW, 3]
    start_h: torch.Tensor  # 0-d crop origin, row
    start_w: torch.Tensor  # 0-d crop origin, column
    perm: torch.Tensor  # [nH * nW] int64; the first gradH * gradW get grads
    # The image's position in i_train, the order of the rgb table's images:
    # the grid step maps the crop's pixels to the table's rows with it.
    img: Optional[torch.Tensor] = None  # 0-d int64


class PatchSource(NamedTuple):
    """The training images and poses on the tables' device, from which
    :func:`sample_patch` draws a patch iteration's crop on the device (JAX
    ``PatchSource``)."""

    images: torch.Tensor  # [N_train, H, W, 3] float32, i_train order
    poses: torch.Tensor  # [N_train, 3, 4] float32


def sample_patch(src: PatchSource, nH: int, nW: int,
                 generator: torch.Generator | None) -> PatchBatch:
    """Draw a patch iteration's randomness on the device, in this order: the
    image, the crop's row, its column, the permutation of its pixels (the
    reference draws them on the host, ``run_nerf.py:1557-1568``; matched in
    distribution). Nothing is copied to the host."""
    dev = src.images.device
    n_img, H, W, _ = src.images.shape
    img = torch.randint(0, n_img, (1,), device=dev, generator=generator)
    sh = torch.randint(0, H - nH + 1, (), device=dev, generator=generator)
    sw = torch.randint(0, W - nW + 1, (), device=dev, generator=generator)
    perm = torch.randperm(nH * nW, device=dev, generator=generator)
    rows = sh + torch.arange(nH, device=dev)
    cols = sw + torch.arange(nW, device=dev)
    gt = src.images.index_select(0, img)[0][rows[:, None], cols[None, :]]
    return PatchBatch(src.poses.index_select(0, img)[0], gt, sh, sw, perm,
                      img[0])


def _patch_rows(patch: PatchBatch, H: int, W: int, nH: int,
               nW: int) -> torch.Tensor:
    """The rgb table's rows of the crop's pixels, in the permutation's order
    (JAX ``_patch_rows``)."""
    dev = patch.perm.device
    rr = torch.arange(nH, device=dev)[:, None]
    cc = torch.arange(nW, device=dev)[None, :]
    rows = (patch.img * (H * W) + (patch.start_h + rr) * W
            + (patch.start_w + cc))
    return rows.reshape(-1)[patch.perm]


def _assemble_patch(values_grad: torch.Tensor, values_ng: torch.Tensor,
                   perm: torch.Tensor, n_grad: int, nH: int,
                   nW: int) -> torch.Tensor:
    """Scatter the grad leg's ``[B, n_grad, C]`` and the no-grad leg's
    ``[B, n - n_grad, C]`` values back into scan-line order, ``[B, nH, nW,
    C]`` (JAX ``_assemble_patch``): out of place into fresh zeros, the no-grad
    values detached, so that only the grad leg's entries carry a graph."""
    B, _, C = values_grad.shape
    full = values_grad.new_zeros((B, nH * nW, C))
    full = full.index_copy(1, perm[:n_grad], values_grad)
    full = full.index_copy(1, perm[n_grad:], values_ng.detach())
    return full.reshape(B, nH, nW, C)


def _clip01(x: torch.Tensor) -> torch.Tensor:
    """``jnp.clip(x, 0, 1)``, which is ``minimum(maximum(x, 0), 1)``: at a
    tie each of the two passes half the gradient (``torch.clamp`` would pass
    all of it)."""
    return torch.minimum(torch.maximum(x, x.new_zeros(())), x.new_ones(()))


GAN_NOISES = ("noise", "noise0", "noise_real", "noise_fake", "noise_f0")


@contextlib.contextmanager
def _no_param_grad(module: torch.nn.Module):
    """``module``'s parameters as constants of the graph built within (JAX's
    ``stop_gradient(disc_params)``): no gradient reaches them from it."""
    params = [p for p in module.parameters() if p.requires_grad]
    for p in params:
        p.requires_grad_(False)
    try:
        yield
    finally:
        for p in params:
            p.requires_grad_(True)


def _take(rays: Rays, sel: torch.Tensor) -> Rays:
    return Rays(*(None if x is None else x[sel] for x in rays))


@contextlib.contextmanager
def _deterministic_cudnn():
    """cuDNN's deterministic algorithms for the perceptual model's and the
    discriminator's convolutions within a step, the caller's setting back
    after it. The default ones accumulate the input gradient with atomics,
    so two runs from one state drift apart from their first feature-loss
    step (on an H100, ``scripts/torch_patch_determinism.py``: 28 of 48
    tensors differ after 5 such steps; none with this), and a resumed run
    would not continue an uninterrupted one as JAX's does."""
    cudnn = torch.backends.cudnn
    prev = cudnn.deterministic
    cudnn.deterministic = True
    try:
        yield
    finally:
        cudnn.deterministic = prev


def _sigma_loss_term(cfg: TrainConfig, rcfg: RenderConfig, models: Models,
                     rays: Rays, target_depth: torch.Tensor,
                     generator: torch.Generator | None) -> torch.Tensor:
    """DS-NeRF sigma loss (JAX ``_sigma_loss_term``, ``loss.py:15-44``):
    ``N_samples`` stratified depths on ``[near, gt_depth]``, the fine field
    (the coarse one without a fine pass) queried there through
    :func:`query_network` (kernels 12 and 13 on the card where it routes
    there), sigma noise added before the ReLU, the mean of
    :func:`losses.sigma_loss_from_sigma`. ``generator`` draws the
    stratified jitter, then the noise."""
    return torch.mean(losses.sigma_loss_from_sigma(
        _sigma_term_sigma(cfg, rcfg, models, rays, target_depth, generator)))


def _sigma_term_sigma(cfg, rcfg, models, rays, target_depth, generator):
    """The sigma term's post-ReLU sigma ``[N, N_samples]`` (the per-ray part
    of :func:`_sigma_loss_term`, which a sharded step gathers)."""
    z = stratified_z_vals(rays.near, target_depth[:, None], cfg.N_samples,
                          perturb=rcfg.perturb, generator=generator)
    pts = (rays.origins[..., None, :]
           + rays.directions[..., None, :] * z[..., :, None])
    net = models.fine if models.fine is not None else models.coarse
    raw = query_network(net, pts, rays.viewdirs, rcfg)
    sigma_raw = raw[..., 3].float()
    if rcfg.raw_noise_std > 0:
        sigma_raw = sigma_raw + draw_rows(
            sigma_raw.shape, generator, normal=True,
            device=sigma_raw.device) * rcfg.raw_noise_std
    return torch.relu(sigma_raw)


def _cdf_render(cfg: TrainConfig, rcfg: RenderConfig, models: Models,
                rays: Rays, w: torch.Tensor, z_grid: torch.Tensor,
                generator: torch.Generator | None, n_imp: int = 0,
                save_acts: bool = True) -> Dict[str, torch.Tensor]:
    """The grid step's render (JAX ``_cdf_render``): the fine pass only, its
    importance samples (``n_imp``, or ``N_importance`` when 0: the patch
    legs pass ``patch_render_samples``) drawn from the rays' baked weight
    rows ``w [N, S]`` (bfloat16, widened to float32) over the bins ``0.5
    (z[1:] + z[:-1])`` of the bake grid, shared by every ray (row stride 0).
    On the card the inverse CDF runs kernel 14; on the CPU JAX's
    ``sample_pdf``. With ``grid_train_fine_only`` the fine pass evaluates
    the sorted samples, else their union with ``N_samples`` stratified
    depths. ``generator`` draws the stratified jitter (union only), the
    importance draws, then the fine pass's sigma noise. ``save_acts`` asks a
    differentiated fused pass to save its activations."""
    n = w.shape[0]
    w32 = w.float()
    z_mid = 0.5 * (z_grid[1:] + z_grid[:-1])
    bins = z_mid.expand(n, z_mid.shape[0])
    z_vals = None
    if not cfg.grid_train_fine_only:
        z_vals = stratified_z_vals(rays.near, rays.far, cfg.N_samples,
                                   lindisp=rcfg.lindisp, perturb=rcfg.perturb,
                                   generator=generator)
    sampler = sample_pdf_cuda if w32.device.type == "cuda" else sample_pdf
    z_samples = sampler(bins, w32[:, 1:-1], n_imp or cfg.N_importance,
                        det=not rcfg.perturb, generator=generator).detach()
    if z_vals is None:
        z_all = torch.sort(z_samples, dim=-1).values
    else:
        z_all = torch.sort(torch.cat([z_vals, z_samples], dim=-1),
                           dim=-1).values
    # The early-terminating forward's sort key, as render_rays' from the
    # coarse pass: the baked weights' termination depth, unterminated last.
    fine_key = None
    if rcfg.cull_eps > 0.0:
        acc = w32.sum(-1)
        depth_est = (w32 * z_grid).sum(-1) / torch.clamp(acc, min=1e-6)
        fine_key = depth_est + (1.0 - acc) * 1e6
    fm = models.fine if models.fine is not None else models.coarse
    fine = _composite_from_z(fm, rays, z_all, rcfg, generator,
                             save_acts=save_acts, fwd_sort_key=fine_key)
    out = {"rgb_map": fine.rgb, "disp_map": fine.disp, "acc_map": fine.acc,
           "depth_map": fine.depth, "weights": fine.weights}
    if fine.semantic is not None:
        out["sem_preds"] = fine.semantic
    return out


def make_train_step(cfg: TrainConfig, rcfg: RenderConfig, models: Models,
                    hwf, grid_mode: bool = False, *, feature_on: bool = False,
                    gan_on: bool = False, smooth_on: bool = False,
                    precrop_on: bool = False, mesh=None):
    """The step function of one loss-schedule variant (JAX
    ``make_train_step`` with ``k_steps=1``), with or without the sigma and
    the semantic terms, with ``grid_mode`` the grid step, with
    ``feature_on``/``smooth_on``/``gan_on`` the patch losses, and with
    ``precrop_on`` (under ``no_batching``) the central crop::

        metrics = step(state, rgb_table, depth_table, generator)

    ``generator`` (a ``torch.Generator`` on the tables' device) draws the
    RGB ray indices (with ``no_batching``: the image, the rows, the
    columns, with replacement; while ``precrop_on`` within the central
    ``precrop_frac`` window), then the depth ray indices, then the render's
    jitter, sigma noise and importance draws, then, with ``sigma_loss``, the sigma
    loss's stratified jitter and its sigma noise. ``idx``/``idx_d`` give the
    ray indices instead (a parity test hands JAX's). The metrics (``loss``,
    ``img_loss``, ``psnr``, ``depth_importance``, and ``img_loss0``/
    ``psnr0``/``depth_loss`` where the step has them) are detached
    tensors; reading them is left to the caller, so the step does not wait
    for the device. With ``sigma_loss`` they also hold ``sigma_loss``; with
    ``semantic_loss``, ``semantic_loss`` and, with a coarse pass,
    ``semantic_loss0``.

    The grid step takes ``aux=``, the :class:`~ops.ray_cdf.RayCDF` that the
    driver baked: the rays' weight rows are gathered with their indices
    and :func:`_cdf_render` renders them, drawing after the ray indices.
    Its metrics lack ``img_loss0``, ``psnr0`` and ``semantic_loss0``.

    A patch step takes ``patch=``, a :class:`PatchSource` (the crop is then
    drawn from ``generator`` by :func:`sample_patch`, before anything else)
    or a fixed :class:`PatchBatch`. It renders the no-grad leg next (in
    ``ng`` tiles of :func:`~render.renderer.pick_render_tile` with caps
    16,384 and 4,096; with ``patch_ng_int8`` through the int8 kernels;
    drawing its jitter, noise and importance samples tile by tile), then
    draws and renders as the base step, then renders the grad leg. Both
    legs render both passes (the fine pass only in grid mode, from the
    crop's baked rows, with ``patch_render_samples`` importance samples),
    and the losses see the clipped crop of each pass. ``inv_loss`` (with
    ``smooth_on``, weighted by ``depth_inverse_lambda`` and the depth
    importance), ``feature_loss`` and with a coarse pass ``feature_loss0``
    (with ``feature_on``) join the metrics, and with ``lpips_spatial`` the
    fine pass's LPIPS map ``lpips_spatial [nH, nW]``. A feature-loss step
    runs cuDNN's deterministic algorithms (:func:`_deterministic_cudnn`).

    With ``gan_on`` the discriminator sees the fine pass's clipped crop plus
    noise (and the coarse pass's, with a coarse leg), its parameters
    constants there; ``gan_loss`` (weighted by ``gan_lambda``) joins the
    total. After the NeRF optimizer's step, :func:`disc_step`'s one
    discriminator step on the real crop and the detached fake crops, each
    plus noise, gives ``loss_dis``. Both legs take the noise std of
    :func:`losses.gan_noise_std_at` at the step count before the update,
    and draw their standard normal noise from ``generator`` after
    everything else, in :data:`GAN_NOISES`' order; ``gan_noise=`` (a dict
    of those names, ``[1, nH, nW, 3]`` each) gives them instead, as
    ``idx`` gives the rays. Every GAN step, like a feature-loss step, runs
    cuDNN's deterministic algorithms.

    With ``mesh`` the step is data parallel (the module's note); its tables
    (and the grid step's baked rows) are whole on every rank or
    :class:`~parallel.distributed.RowShard` slices, whose batch rows are
    collected by ``gather_table_rows``. Its metrics are the same on every
    rank."""
    if cfg.semantic_loss and not rcfg.num_semantic_classes:
        raise ValueError("semantic_loss needs num_semantic_classes > 0")
    if grid_mode and cfg.N_importance <= 0:
        raise ValueError("grid_train needs a fine pass (N_importance > 0)")
    H, W, focal = int(hwf[0]), int(hwf[1]), float(hwf[2])
    nH, nW = cfg.nH, cfg.nW
    patch_mode = feature_on or smooth_on or gan_on
    if patch_mode and (nH > H or nW > W):
        raise ValueError(f"patch {nH}x{nW} larger than image {H}x{W}")
    if gan_on and getattr(models, "discriminator", None) is None:
        raise ValueError("a GAN step needs the discriminator (build_models "
                         "with gan_loss)")
    feature_model = None
    if feature_on:
        feature_model = (models.lpips if cfg.feature_loss_type == "lpips"
                         else models.vgg)
        if feature_model is None:
            raise ValueError("a feature-loss step needs the perceptual model "
                             "(build_models with feature_loss)")
    n_depth = int(cfg.N_rand * cfg.depth_rays_prop) if cfg.colmap_depth else 0
    n_rgb = cfg.N_rand - n_depth
    n_grad = cfg.gradH * cfg.gradW
    # The patch losses take both passes' crops (JAX's stack_fc); the RGB loss
    # of the coarse pass goes with no_coarse, whose coarse field is frozen.
    two_pass = cfg.N_importance > 0 and not grid_mode
    coarse_on = two_pass and not cfg.no_coarse
    # The no-grad leg renders only forward, so the int8 kernels may take it.
    rcfg_ng = (dataclasses.replace(rcfg, render_int8=True)
               if cfg.patch_ng_int8 else rcfg)
    group = None if mesh is None else mesh.group

    def table_device(table):
        return (table.local if isinstance(table, RowShard)
                else table).origins.device

    def draw(n, table, generator, given):
        dev = table_device(table)
        if given is not None:
            return torch.tensor(np.asarray(given), dtype=torch.long, device=dev)
        return torch.randint(0, table_rows(table), (n,), device=dev,
                             generator=generator)

    def batch_of(table, idx):
        """A table holding the batch's rows and their indices in it: the
        table and ``idx``, or for a row-sliced table the batch's rows
        collected from every process and ``arange``."""
        if isinstance(table, RowShard):
            return (take_rows(table, idx, group),
                    torch.arange(idx.shape[0], device=idx.device))
        return table, idx

    def render_leg(n, rays, w, generator, fn, keys=GATHERED):
        """``fn(rays, w, gen)`` over an ``n``-ray leg: on this rank's rows of
        ``rays`` (and of the baked rows ``w``, where given) under a mesh,
        the outputs gathered."""
        return run_sharded(mesh, n, lambda lo, hi, g: fn(
            _rows(rays, lo, hi), None if w is None else w[lo:hi], g),
            generator, keys)

    def draw_one_image(table, generator, given):
        """JAX's ``no_batching`` draw (``run_nerf.py:1376-1404``): one image,
        then ``n_rgb`` rows and columns with replacement (the reference
        draws without), within the central window while ``precrop_on``."""
        dev = table_device(table)
        if given is not None:
            return torch.tensor(np.asarray(given), dtype=torch.long, device=dev)
        n_img = table_rows(table) // (H * W)
        img = torch.randint(0, n_img, (), device=dev, generator=generator)
        if precrop_on:
            dH = int(H // 2 * cfg.precrop_frac)
            dW = int(W // 2 * cfg.precrop_frac)
            r0, r1 = H // 2 - dH, max(H // 2 + dH, H // 2 - dH + 1)
            c0, c1 = W // 2 - dW, max(W // 2 + dW, W // 2 - dW + 1)
        else:
            r0, r1, c0, c1 = 0, H, 0, W
        rows = torch.randint(r0, r1, (n_rgb,), device=dev, generator=generator)
        cols = torch.randint(c0, c1, (n_rgb,), device=dev, generator=generator)
        return img * (H * W) + rows * W + cols

    def stack_fc(o, key, key0):
        # Grid mode has no coarse leg in the patch losses: [1, ...].
        if two_pass:
            return torch.stack([o[key], o[key0]])
        return o[key][None]

    def noise(name, generator, given, std, like):
        """Standard normal ``[1, nH, nW, 3]`` noise times ``std``."""
        if given is not None:
            z = torch.tensor(np.asarray(given[name]), dtype=torch.float32,
                             device=like.device)
        else:
            z = torch.randn((1, nH, nW, 3), dtype=torch.float32,
                            device=like.device, generator=generator)
        return z * std

    def gan_term(acc_rgb, std, generator, given):
        """The generator's adversarial loss (JAX ``loss_fn``'s GAN branch):
        the discriminator's parameters are constants here."""
        disc = models.discriminator
        with _no_param_grad(disc):
            pred = disc(acc_rgb[0:1] + noise("noise", generator, given, std,
                                             acc_rgb))
            gan_loss = losses.gan_mse(pred, 1.0)
            if two_pass:
                pred0 = disc(acc_rgb[1:2] + noise("noise0", generator, given,
                                                  std, acc_rgb))
                gan_loss = gan_loss + losses.gan_mse(pred0, 1.0)
        return gan_loss

    def disc_step(state, gt_patch, fake, std, generator, given):
        """One discriminator step on the real crop and the detached fake
        crops (JAX ``disc_step``, ``run_nerf.py:1779-1816``)."""
        disc = models.discriminator
        fake = fake.detach()
        pred_real = disc(gt_patch[None] + noise("noise_real", generator,
                                                given, std, fake))
        pred_fake = disc(fake[0:1] + noise("noise_fake", generator, given,
                                           std, fake))
        loss_real = losses.gan_mse(pred_real, 1.0)
        loss_fake = losses.gan_mse(pred_fake, 0.0)
        if two_pass:
            pred_f0 = disc(fake[1:2] + noise("noise_f0", generator, given,
                                             std, fake))
            loss_fake = 0.5 * (loss_fake + losses.gan_mse(pred_f0, 0.0))
        loss_dis = loss_fake + loss_real
        state.disc_optimizer.zero_grad(set_to_none=True)
        loss_dis.backward()
        state.disc_optimizer.step()
        return loss_dis

    def ng_render(prays, patch, rows, generator, aux):
        """The no-grad leg (JAX ``ng_render``); under a mesh each tile is
        split over the ranks."""
        rays = _take(prays, patch.perm[n_grad:])
        if grid_mode:
            return render_leg(
                rays.origins.shape[0], rays,
                take_rows(aux.w_rgb, rows[n_grad:], group), generator,
                lambda r, w, g: _cdf_render(
                    cfg, rcfg_ng, models, r, w, aux.z, g,
                    n_imp=cfg.patch_render_samples, save_acts=False))
        tile = pick_render_tile(models.coarse, models.fine, rcfg_ng,
                                rays.origins.shape[0],
                                fused_cap=NG_FUSED_CAP, flax_cap=NG_PLAIN_CAP)
        return render_rays_tiled(models.coarse, models.fine, rays, rcfg_ng,
                                 generator, tile=tile, mesh=mesh)

    def patch_terms(loss, metrics, patch, prays, rows, ng, generator, aux,
                    imp, gan_std, gan_noise):
        """The grad leg; adds the patch losses to ``loss``, in JAX's order.
        Returns the total and the assembled crops."""
        with span("step.render"):
            rays = _take(prays, patch.perm[:n_grad])
            if grid_mode:
                g_out = render_leg(
                    n_grad, rays, take_rows(aux.w_rgb, rows[:n_grad], group),
                    generator, lambda r, w, g: _cdf_render(
                        cfg, rcfg, models, r, w, aux.z, g,
                        n_imp=cfg.patch_render_samples))
            else:
                g_out = render_leg(n_grad, rays, None, generator,
                                   lambda r, w, g: render_rays(
                                       models.coarse, models.fine, r, rcfg, g))
        with span("step.loss"):
            acc_rgb = _assemble_patch(  # [B, nH, nW, 3]
                _clip01(stack_fc(g_out, "rgb_map", "rgb0")),
                _clip01(stack_fc(ng, "rgb_map", "rgb0")),
                patch.perm, n_grad, nH, nW)
            if smooth_on:
                acc_depth = _assemble_patch(
                    stack_fc(g_out, "depth_map", "depth_map0")[..., None],
                    stack_fc(ng, "depth_map", "depth_map0")[..., None],
                    patch.perm, n_grad, nH, nW)
                inv_loss = losses.inverse_depth_smoothness_loss(acc_depth,
                                                                acc_rgb)
                metrics["inv_loss"] = inv_loss
                loss = loss + inv_loss * cfg.depth_inverse_lambda * imp
            if feature_on:
                loss = feature_terms(loss, metrics, patch, acc_rgb)
            if gan_on:
                gan_loss = gan_term(acc_rgb, gan_std, generator, gan_noise)
                metrics["gan_loss"] = gan_loss
                loss = loss + gan_loss * cfg.gan_lambda
        return loss, acc_rgb

    def feature_terms(loss, metrics, patch, acc_rgb):
        """The feature loss of both passes' crops."""
        gt = patch.gt_patch[None]
        fl0 = None
        if cfg.feature_loss_type == "lpips":
            # run_nerf.py:1708-1721; one call for both passes' crops.
            d = feature_model(gt.expand(acc_rgb.shape), acc_rgb,
                              normalize=True)
            if cfg.lpips_spatial:
                metrics["lpips_spatial"] = d[0, ..., 0].detach()
                feature_loss = torch.mean(d[0:1])
                if two_pass:
                    fl0 = torch.mean(d[1:2])
            else:
                feature_loss = d[0]
                if two_pass:
                    fl0 = d[1]
        else:
            names = tuple(cfg.vgg_layers or ())
            with torch.no_grad():
                feats_gt = feature_model(vgg_normalize(gt))
            feats = feature_model(vgg_normalize(acc_rgb))
            feature_loss = losses.vgg_feature_distance(
                {k: v[0:1] for k, v in feats.items()}, feats_gt, names,
                cfg.vgg_layer_weights, cfg.vgg_loss_type)
            if two_pass:
                fl0 = losses.vgg_feature_distance(
                    {k: v[1:2] for k, v in feats.items()}, feats_gt, names,
                    cfg.vgg_layer_weights, cfg.vgg_loss_type)
        if fl0 is not None:
            metrics["feature_loss0"] = fl0
            feature_loss = feature_loss + fl0
        metrics["feature_loss"] = feature_loss
        return loss + feature_loss * cfg.feature_lambda

    def step(state: TrainState, rgb_table: RgbRayTable,
             depth_table: Optional[DepthRayTable],
             generator: torch.Generator | None = None, idx=None,
             idx_d=None, aux: Optional[RayCDF] = None, patch=None,
             gan_noise=None) -> Dict[str, torch.Tensor]:
        # The step's spans (utils.tracing): "step", id the step number, and
        # in it one a phase: draw, render, loss, backward, optimizer (a
        # patch step's legs fall in render and loss).
        with span("step", state.step + 1), (
                _deterministic_cudnn() if feature_on or gan_on
                else contextlib.nullcontext()):
            return run(state, rgb_table, depth_table, generator, idx, idx_d,
                       aux, patch, gan_noise)

    def run(state, rgb_table, depth_table, generator, idx, idx_d, aux,
            patch, gan_noise):
        if grid_mode and aux is None:
            raise ValueError("a grid step needs the baked RayCDF (aux)")
        metrics = {}
        if patch_mode:
            if patch is None:
                raise ValueError("a patch step needs patch= (a PatchSource "
                                 "or a PatchBatch)")
            with span("step.render"):
                if isinstance(patch, PatchSource):
                    patch = sample_patch(patch, nH, nW, generator)
                ro, rd = patch_ray_dirs(H, W, focal, patch.c2w, patch.start_h,
                                        patch.start_w, nH, nW)
                prays = make_rays(ro, rd, rcfg, H, W, focal)
                rows = _patch_rows(patch, H, W, nH, nW) if grid_mode else None
                with torch.no_grad():
                    ng = ng_render(prays, patch, rows, generator, aux)
        with span("step.draw"):
            idx = (draw_one_image(rgb_table, generator, idx) if cfg.no_batching
                   else draw(n_rgb, rgb_table, generator, idx))
            tab, at = batch_of(rgb_table, idx)
            rays = gather_rays(tab, at, rcfg)
            target_s = tab.rgb[at]
            target_sem = tab.semantic[at] if cfg.semantic_loss else None
            if n_depth > 0:
                idx_d = draw(n_depth, depth_table, generator, idx_d)
                tab_d, at_d = batch_of(depth_table, idx_d)
                rays_depth = gather_rays(tab_d, at_d, rcfg)
                target_depth = tab_d.depth[at_d]
                ray_weights = tab_d.weight[at_d]
                rays = Rays(*(None if a is None else torch.cat([a, b])
                              for a, b in zip(rays, rays_depth)))

        with span("step.render"):
            if grid_mode:
                w_all = take_rows(aux.w_rgb, idx, group)
                if n_depth > 0:
                    w_all = torch.cat([w_all, take_rows(aux.w_depth, idx_d,
                                                        group)])
                out = render_leg(rays.origins.shape[0], rays, w_all, generator,
                                 lambda r, w, g: _cdf_render(cfg, rcfg, models,
                                                             r, w, aux.z, g))
            else:
                out = render_leg(rays.origins.shape[0], rays, None, generator,
                                 lambda r, w, g: render_rays(
                                     models.coarse, models.fine, r, rcfg, g))
        with span("step.loss"):
            img_loss = losses.img2mse(out["rgb_map"][:n_rgb], target_s)
            metrics["img_loss"] = img_loss
            metrics["psnr"] = losses.mse2psnr(img_loss)
            loss = img_loss
            imp = losses.depth_importance(state.step, cfg.lrate_decay)
            metrics["depth_importance"] = torch.tensor(imp)
            if cfg.depth_loss and n_depth > 0:
                d_loss = losses.depth_loss(
                    out["depth_map"][n_rgb:], target_depth, ray_weights,
                    weighted=cfg.weighted_loss, normalize=cfg.normalize_depth,
                    relative=cfg.relative_loss)
                metrics["depth_loss"] = d_loss
                loss = loss + cfg.depth_lambda * imp * d_loss
            if cfg.sigma_loss and n_depth > 0:
                sigma = run_sharded(mesh, n_depth, lambda lo, hi, g: {
                    "sigma": _sigma_term_sigma(cfg, rcfg, models,
                                               _rows(rays_depth, lo, hi),
                                               target_depth[lo:hi], g)},
                    generator)["sigma"]
                s_loss = torch.mean(losses.sigma_loss_from_sigma(sigma))
                metrics["sigma_loss"] = s_loss
                loss = loss + cfg.sigma_lambda * s_loss
            if cfg.semantic_loss:
                sem_loss = losses.semantic_cross_entropy(
                    out["sem_preds"][:n_rgb], target_sem)
                metrics["semantic_loss"] = sem_loss
                sem_loss0 = 0.0
                if "sem_preds0" in out:
                    sem_loss0 = losses.semantic_cross_entropy(
                        out["sem_preds0"][:n_rgb], target_sem)
                    metrics["semantic_loss0"] = sem_loss0
                loss = loss + cfg.semantic_lambda * (sem_loss + sem_loss0)
            if coarse_on:
                img_loss0 = losses.img2mse(out["rgb0"][:n_rgb], target_s)
                metrics["img_loss0"] = img_loss0
                metrics["psnr0"] = losses.mse2psnr(img_loss0)
                loss = loss + img_loss0
        # Both GAN legs take the noise std at the count before the update.
        gan_std = (losses.gan_noise_std_at(state.step, cfg.gan_noise_std)
                   if gan_on else None)
        if patch_mode:
            loss, acc_rgb = patch_terms(loss, metrics, patch, prays, rows, ng,
                                        generator, aux, imp, gan_std,
                                        gan_noise)
        metrics["loss"] = loss

        with span("step.backward"):
            state.optimizer.zero_grad(set_to_none=True)
            loss.backward()
            all_reduce_grads((p for g in state.optimizer.param_groups
                              for p in g["params"]), mesh)
        with span("step.optimizer"):
            state.optimizer.step()
            invalidate_packs(models)
            state.step += 1
            if gan_on:
                metrics["loss_dis"] = disc_step(state, patch.gt_patch, acc_rgb,
                                                gan_std, generator, gan_noise)
        return {k: v.detach() if torch.is_tensor(v) else torch.tensor(v)
                for k, v in metrics.items()}

    return step


class StepPlan(NamedTuple):
    """What :func:`build_step_fns` hands the driver (JAX ``StepPlan``
    without the K-step and period dispatch, which the port does not run)."""

    select: Callable  # i -> (step, needs_patch)
    variant_key: Callable  # i -> (feature_on, gan_on, smooth_on, precrop_on, grid_on)


def build_step_fns(cfg: TrainConfig, rcfg: RenderConfig, models: Models,
                   hwf, mesh=None) -> StepPlan:
    """The step variants of the loss schedule, built when first selected
    and cached by key (JAX ``build_step_fns``). At iteration ``i``: feature
    on iff ``feature_loss and i >= feature_start_iteration and i %
    feature_loss_every_n == 0``; GAN on iff ``gan_loss and i >=
    gan_start_iteration``; smoothness on iff ``depth_inverse_loss and i %
    depth_inverse_loss_every_n == 0``; precrop on iff ``no_batching and i <
    precrop_iters``; grid on iff ``grid_train and i > grid_train_after``.
    An oversized patch is refused here, before the first step. ``mesh``
    makes every variant data parallel (:func:`make_train_step`)."""
    H, W = int(hwf[0]), int(hwf[1])
    if ((cfg.feature_loss or cfg.gan_loss or cfg.depth_inverse_loss)
            and (cfg.nH > H or cfg.nW > W)):
        raise ValueError(f"patch {cfg.nH}x{cfg.nW} larger than image {H}x{W}")
    variants = {}

    def variant_key(i: int):
        feature_on = bool(cfg.feature_loss and i >= cfg.feature_start_iteration
                          and i % cfg.feature_loss_every_n == 0)
        gan_on = bool(cfg.gan_loss and i >= cfg.gan_start_iteration)
        smooth_on = bool(cfg.depth_inverse_loss
                         and i % cfg.depth_inverse_loss_every_n == 0)
        precrop_on = bool(cfg.no_batching and i < cfg.precrop_iters)
        grid_on = bool(cfg.grid_train and i > cfg.grid_train_after)
        return (feature_on, gan_on, smooth_on, precrop_on, grid_on)

    def select(i: int):
        key = variant_key(i)
        if key not in variants:
            feature_on, gan_on, smooth_on, precrop_on, grid_on = key
            variants[key] = make_train_step(
                cfg, rcfg, models, hwf, grid_mode=grid_on,
                feature_on=feature_on, gan_on=gan_on, smooth_on=smooth_on,
                precrop_on=precrop_on, mesh=mesh)
        return variants[key], any(key[:3])

    return StepPlan(select, variant_key)
