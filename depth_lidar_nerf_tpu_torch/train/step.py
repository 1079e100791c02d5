"""The training step (port of the base variant of ``train/step.py``).

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

The JAX step compiles into one XLA program; here each step is eager PyTorch
around the kernels. Step variants that the port does not run yet (patch
losses, GAN, grid training, single-image batching, K-step dispatch) raise
``NotImplementedError``.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from depth_lidar_nerf_tpu_torch.ops.sampling import stratified_z_vals
from depth_lidar_nerf_tpu_torch.render.renderer import (RenderConfig, Rays,
                                                        query_network,
                                                        render_rays)
from depth_lidar_nerf_tpu_torch.train import losses
from depth_lidar_nerf_tpu_torch.train.config import TrainConfig
from depth_lidar_nerf_tpu_torch.train.state import Models, TrainState
from depth_lidar_nerf_tpu_torch.train.tables import (DepthRayTable,
                                                     RgbRayTable, gather_rays)

_UNPORTED = ("no_batching", "feature_loss", "gan_loss",
             "depth_inverse_loss", "grid_train", "patch_ng_int8")


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
    z = stratified_z_vals(rays.near, target_depth[:, None], cfg.N_samples,
                          perturb=rcfg.perturb, generator=generator)
    pts = (rays.origins[..., None, :]
           + rays.directions[..., None, :] * z[..., :, None])
    net = models.fine if models.fine is not None else models.coarse
    raw = query_network(net, pts, rays.viewdirs, rcfg)
    sigma_raw = raw[..., 3].float()
    if rcfg.raw_noise_std > 0:
        sigma_raw = sigma_raw + torch.randn(
            sigma_raw.shape, dtype=torch.float32, device=sigma_raw.device,
            generator=generator) * rcfg.raw_noise_std
    return torch.mean(losses.sigma_loss_from_sigma(torch.relu(sigma_raw)))


def make_train_step(cfg: TrainConfig, rcfg: RenderConfig, models: Models,
                    hwf):
    """The step function of the base variant (JAX ``make_train_step`` with
    no patch, GAN or grid term and ``k_steps=1``), with or without the
    sigma and the semantic terms::

        metrics = step(state, rgb_table, depth_table, generator)

    ``generator`` (a ``torch.Generator`` on the tables' device) draws the
    RGB ray indices, then the depth ray indices, then the render's jitter,
    sigma noise and importance draws, then, with ``sigma_loss``, the sigma
    loss's stratified jitter and its sigma noise. ``idx``/``idx_d`` give the
    ray indices instead (a parity test hands JAX's). The metrics (``loss``,
    ``img_loss``, ``psnr``, ``depth_importance``, and ``img_loss0``/
    ``psnr0``/``depth_loss`` where the step has them) are detached 0-d
    tensors; reading them is left to the caller, so the step does not wait
    for the device. With ``sigma_loss`` they also hold ``sigma_loss``; with
    ``semantic_loss``, ``semantic_loss`` and, with a coarse pass,
    ``semantic_loss0``.
    """
    unported = [n for n in _UNPORTED if getattr(cfg, n)]
    if unported:
        raise NotImplementedError(
            f"training step variants not ported to PyTorch yet: {unported}")
    if cfg.semantic_loss and not rcfg.num_semantic_classes:
        raise ValueError("semantic_loss needs num_semantic_classes > 0")
    del hwf  # only the patch and single-image variants need the frame size
    n_depth = int(cfg.N_rand * cfg.depth_rays_prop) if cfg.colmap_depth else 0
    n_rgb = cfg.N_rand - n_depth
    coarse_on = cfg.N_importance > 0

    def draw(n, table, generator, given):
        dev = table.origins.device
        if given is not None:
            return torch.tensor(np.asarray(given), dtype=torch.long, device=dev)
        return torch.randint(0, table.origins.shape[0], (n,), device=dev,
                             generator=generator)

    def step(state: TrainState, rgb_table: RgbRayTable,
             depth_table: Optional[DepthRayTable],
             generator: torch.Generator | None = None, idx=None,
             idx_d=None) -> Dict[str, torch.Tensor]:
        metrics = {}
        idx = draw(n_rgb, rgb_table, generator, idx)
        rays = gather_rays(rgb_table, idx, rcfg)
        target_s = rgb_table.rgb[idx]
        target_sem = rgb_table.semantic[idx] if cfg.semantic_loss else None
        if n_depth > 0:
            idx_d = draw(n_depth, depth_table, generator, idx_d)
            rays_depth = gather_rays(depth_table, idx_d, rcfg)
            target_depth = depth_table.depth[idx_d]
            ray_weights = depth_table.weight[idx_d]
            rays = Rays(*(None if a is None else torch.cat([a, b])
                          for a, b in zip(rays, rays_depth)))

        out = render_rays(models.coarse, models.fine, rays, rcfg, generator)
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
            s_loss = _sigma_loss_term(cfg, rcfg, models, rays_depth,
                                      target_depth, generator)
            metrics["sigma_loss"] = s_loss
            loss = loss + cfg.sigma_lambda * s_loss
        if cfg.semantic_loss:
            sem_loss = losses.semantic_cross_entropy(out["sem_preds"][:n_rgb],
                                                     target_sem)
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
        metrics["loss"] = loss

        state.optimizer.zero_grad(set_to_none=True)
        loss.backward()
        state.optimizer.step()
        for m in models:
            if hasattr(m, "invalidate_pack"):
                m.invalidate_pack()
        state.step += 1
        return {k: v.detach() for k, v in metrics.items()}

    return step
