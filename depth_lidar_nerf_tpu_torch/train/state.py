"""Model factory (port of the model half of ``train/state.py``).

Builds the coarse and fine NeRF MLPs of ``create_nerf`` (``run_nerf.py:389-517``)
as ``nn.Module``s on one device, with weights drawn from a seeded
``torch.Generator``. :class:`FusedMLP` dispatches covered topologies to the
fused forward kernel. The optimizer and training state come with the
training slice.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch
from torch import nn

from depth_lidar_nerf_tpu_torch.device import resolve_device
from depth_lidar_nerf_tpu_torch.models.nerf_mlp import NeRFMLP
from depth_lidar_nerf_tpu_torch.ops import fused_mlp_t
from depth_lidar_nerf_tpu_torch.ops.embedding import embedding_dim
from depth_lidar_nerf_tpu_torch.render.renderer import RenderConfig
from depth_lidar_nerf_tpu_torch.train.config import TrainConfig


class FusedMLP(NeRFMLP):
    """A :class:`NeRFMLP` (same parameters, same plain ``forward``) whose
    per-ray evaluation goes through the fused forward kernel
    (:func:`ops.fused_mlp_t.fused_nerf_apply_rays`) when the topology is
    covered."""

    def supports_rays_path(self, cfg: RenderConfig) -> bool:
        return fused_mlp_t.supports_rays(
            dict(self.named_parameters()), self.use_viewdirs,
            self.num_semantic_classes, self.depth, self.width, cfg.multires,
            cfg.multires_views, skips=self.skips)

    def packed(self, device: torch.device) -> fused_mlp_t.PackedParams:
        """The weights in the kernel's layout on ``device``, packed again
        only after a parameter changed: in-place updates and
        ``load_state_dict`` bump each tensor's version counter."""
        params = dict(self.named_parameters())
        key = (self.dtype, device,
               tuple((p.data_ptr(), p._version) for p in params.values()))
        if getattr(self, "_packed_key", None) != key:
            self._packed = fused_mlp_t.pack_params(params, self.depth,
                                                   self.dtype, device)
            self._packed_key = key
        return self._packed

    def apply_rays(self, rays, z_vals, cfg: RenderConfig) -> torch.Tensor:
        """Rays + per-ray depths -> channel-major raw ``[4, N, S]``."""
        packed = (self.packed(z_vals.device) if z_vals.device.type == "cuda"
                  else None)
        return fused_mlp_t.fused_nerf_apply_rays(
            dict(self.named_parameters()), rays.origins, rays.directions,
            rays.viewdirs, z_vals, depth=self.depth, width=self.width,
            multires=cfg.multires, multires_views=cfg.multires_views,
            dtype=self.dtype, skips=self.skips, packed=packed)


class Models(NamedTuple):
    coarse: nn.Module
    fine: Optional[nn.Module]


def build_models(cfg: TrainConfig, rcfg: RenderConfig, device=None,
                 seed: int | None = None) -> Models:
    """Coarse and fine MLPs on ``device`` (``cuda`` unless given), weights
    from ``torch.Generator().manual_seed(seed)`` (default ``cfg.seed``)."""
    device = resolve_device(device)
    if cfg.alpha_model_path or cfg.no_coarse:
        raise NotImplementedError("the frozen alpha model is not ported yet")
    if cfg.mesh_shape and any(s > 1 for s in cfg.mesh_shape):
        raise NotImplementedError("multi-device meshes are not ported yet")
    gen = torch.Generator().manual_seed(cfg.seed if seed is None else seed)
    pts_dim = embedding_dim(3, rcfg.multires)
    views_dim = embedding_dim(3, rcfg.multires_views) if cfg.use_viewdirs else 0
    dtype = torch.bfloat16 if cfg.compute_dtype == "bfloat16" else torch.float32
    output_ch = 5 if cfg.N_importance > 0 else 4  # run_nerf.py:398

    # On the card a covered topology always takes the kernel; the flag
    # picks the plain module on the CPU only.
    cls = FusedMLP if cfg.use_fused_mlp or device.type == "cuda" else NeRFMLP

    def mlp(depth, width):
        return cls(depth=depth, width=width, in_channels=pts_dim,
                   in_channels_views=views_dim, use_viewdirs=cfg.use_viewdirs,
                   num_semantic_classes=rcfg.num_semantic_classes,
                   output_ch=output_ch, dtype=dtype, generator=gen).to(device)

    coarse = mlp(cfg.netdepth, cfg.netwidth)
    fine = mlp(cfg.netdepth_fine, cfg.netwidth_fine) if cfg.N_importance > 0 \
        else None
    return Models(coarse, fine)
