"""Model + optimizer factory and the train state (port of ``train/state.py``).

Builds the coarse and fine NeRF MLPs of ``create_nerf`` (``run_nerf.py:389-517``)
as ``nn.Module``s on one device, with weights drawn from a seeded
``torch.Generator``. :class:`FusedMLP` dispatches covered topologies to the
fused kernels. The optimizer is Adam with the reference's continuous
exponential LR decay ``lrate * 0.1^(step / (lrate_decay * 1000))``
(``run_nerf.py:1843-1847``), as the JAX package's optax schedule: the rate
of a step is read at the step count before the update.
"""

from __future__ import annotations

import dataclasses
import os
from typing import NamedTuple, Optional

import torch
from torch import nn

from depth_lidar_nerf_tpu_torch.device import resolve_device
from depth_lidar_nerf_tpu_torch.models.nerf_mlp import NeRFMLP
from depth_lidar_nerf_tpu_torch.ops import fused_mlp, fused_mlp_t
from depth_lidar_nerf_tpu_torch.ops.embedding import embedding_dim
from depth_lidar_nerf_tpu_torch.render.renderer import RenderConfig
from depth_lidar_nerf_tpu_torch.train.config import TrainConfig


class FusedMLP(NeRFMLP):
    """A :class:`NeRFMLP` (same parameters, same plain ``forward``) whose
    per-ray evaluation goes through the fused kernels
    (:func:`ops.fused_mlp_t.fused_nerf_apply_rays`) when the topology is
    covered, and whose raw queries at arbitrary points go through the
    packed-lane kernels 12 and 13 (:func:`ops.fused_mlp.fused_nerf_apply_raw`)
    where :meth:`supports_raw` holds. On CUDA tensors the kernels run; on
    CPU tensors their plain twins."""

    def supports_raw(self, cfg: RenderConfig) -> bool:
        """JAX ``FusedMLP.supports_raw``: the packed-lane kernels cover this
        model (``fused_mlp.supports``, the sample count checked by the
        caller)."""
        return fused_mlp.supports(
            dict(self.named_parameters()), self.use_viewdirs,
            self.num_semantic_classes, self.depth, self.width, S=-1,
            multires=cfg.multires, multires_views=cfg.multires_views,
            skips=self.skips)

    def apply_raw(self, pts, viewdirs, cfg: RenderConfig) -> torch.Tensor:
        """Raw queries: ``pts [N, S, 3]``, unit ``viewdirs [N, 3]`` -> raw
        ``[N, S, 4]`` float32 through kernels 12 and 13."""
        return fused_mlp.fused_nerf_apply_raw(
            dict(self.named_parameters()), pts, viewdirs, depth=self.depth,
            width=self.width, multires=cfg.multires,
            multires_views=cfg.multires_views, dtype=self.dtype)

    def supports_rays_path(self, cfg: RenderConfig) -> bool:
        return fused_mlp_t.supports_rays(
            dict(self.named_parameters()), self.use_viewdirs,
            self.num_semantic_classes, self.depth, self.width, cfg.multires,
            cfg.multires_views, skips=self.skips)

    def supports_raw_semantic(self, cfg: RenderConfig, n_points: int = 0,
                              S: int = 0) -> bool:
        """Whether the semantic kernels (6-8) take this call, as the JAX
        ``FusedMLP.supports_raw_semantic`` decides: the topology with a
        semantic head, and ``n_points`` (rays x samples; with ``S``, counted
        after JAX's ray padding) within the saved-activation cap. JAX checks
        the cap for no-grad renders too, so a pass beyond it takes the plain
        module in both packages."""
        if n_points and S:
            n_points = fused_mlp_t.semantic_padded_rays(
                -(-n_points // S), S, self.depth, self.width, self.dtype) * S
        if n_points > fused_mlp_t.acts_points_cap(self.depth, self.width,
                                                   self.dtype):
            return False
        return fused_mlp_t.supports_semantic(
            dict(self.named_parameters()), self.use_viewdirs, self.depth,
            self.width, cfg.multires, cfg.multires_views, skips=self.skips)

    def _pack_key(self, device, params):
        return (self.dtype, device,
                tuple((p.data_ptr(), p._version) for p in params.values()))

    def packed(self, device: torch.device) -> fused_mlp_t.PackedParams:
        """The weights (and the semantic head, where there is one) in the
        kernels' layout on ``device`` for passes without a gradient, packed
        again after a parameter changed
        (in-place updates and ``load_state_dict`` bump each tensor's version
        counter) or after :meth:`invalidate_pack`. Differentiated passes
        pack from the live parameters on every call."""
        params = dict(self.named_parameters())
        key = self._pack_key(device, params)
        if getattr(self, "_packed_key", None) != key:
            self._packed = fused_mlp_t.pack_params(params, self.depth,
                                                   self.dtype, device)
            self._packed_key = key
        return self._packed

    def packed_q8(self, device: torch.device) -> fused_mlp_t.PackedQ8:
        """The int8 serving pack (:func:`ops.fused_mlp_t.pack_params_q8`) on
        ``device``, cached as :meth:`packed` caches its pack, so that a
        served frame quantizes the weights once, not once per tile."""
        params = dict(self.named_parameters())
        key = self._pack_key(device, params)
        if getattr(self, "_packed_q8_key", None) != key:
            self._packed_q8 = fused_mlp_t.pack_params_q8(
                params, self.depth, self.dtype, device, self.skips)
            self._packed_q8_key = key
        return self._packed_q8

    def _nograd_pack(self, params, device):
        """:meth:`packed` for a pass without a gradient on the card; None
        under autograd (the Functions pack the live parameters) or on the
        CPU (the twins read ``params``)."""
        grad = torch.is_grad_enabled() and any(p.requires_grad
                                               for p in params.values())
        return self.packed(device) if device.type == "cuda" and not grad \
            else None

    def invalidate_pack(self) -> None:
        """Forget the packed weights; the training step calls this after
        every optimizer step rather than trust that the optimizer bumped
        every parameter's version counter."""
        self._packed_key = self._packed_q8_key = None

    @staticmethod
    def _cull_bwd(cfg: RenderConfig) -> bool:
        """JAX ``FusedMLP.apply_rays``: the cotangent-culled backward under
        ``cull_eps > 0``, unless ``DLNERF_NO_BWD_CULL=1`` (read at call
        time) asks for the dense one."""
        return cfg.cull_eps > 0 and \
            os.environ.get("DLNERF_NO_BWD_CULL", "0") != "1"

    def apply_rays(self, rays, z_vals, cfg: RenderConfig,
                   save_acts: bool = False, fwd_cull=None) -> torch.Tensor:
        """Rays + per-ray depths -> channel-major raw ``[4, N, S]``. Under
        autograd the backward is culled as :meth:`_cull_bwd` says, and
        ``save_acts`` asks for the saved-activation route; ``fwd_cull`` asks
        for the early-terminating forward (kernel 9) under
        ``DLNERF_CULL_FWD=1``."""
        params = dict(self.named_parameters())
        return fused_mlp_t.fused_nerf_apply_rays(
            params, rays.origins, rays.directions, rays.viewdirs, z_vals,
            depth=self.depth, width=self.width, multires=cfg.multires,
            multires_views=cfg.multires_views, dtype=self.dtype,
            skips=self.skips, cull_bwd=self._cull_bwd(cfg),
            save_acts=save_acts, fwd_cull=fwd_cull,
            packed=self._nograd_pack(params, z_vals.device))

    def apply_rays_semantic(self, rays, z_vals, cfg: RenderConfig):
        """Rays + per-ray depths -> (raw ``[4, N, S]``, the ray-summed
        semantic logits ``[N, C]``) through kernels 6-8."""
        params = dict(self.named_parameters())
        return fused_mlp_t.fused_nerf_apply_rays_semantic(
            params, rays.origins, rays.directions, rays.viewdirs, z_vals,
            depth=self.depth, width=self.width, multires=cfg.multires,
            multires_views=cfg.multires_views, dtype=self.dtype,
            skips=self.skips, packed=self._nograd_pack(params, z_vals.device))

    def _q8_kw(self, z_vals, cfg: RenderConfig):
        return dict(params=dict(self.named_parameters()), depth=self.depth, width=self.width,
                    multires=cfg.multires, multires_views=cfg.multires_views,
                    dtype=self.dtype, skips=self.skips,
                    packed=self.packed_q8(z_vals.device))

    def apply_rays_q8(self, rays, z_vals, cfg: RenderConfig) -> torch.Tensor:
        """The W8A8 serving forward (kernel 10): raw ``[4, N, S]``. Eval
        renders only: raises under autograd (JAX defines no VJP)."""
        kw = self._q8_kw(z_vals, cfg)
        return fused_mlp_t.fused_nerf_apply_rays_q8(
            rays_o=rays.origins, rays_d=rays.directions,
            viewdirs=rays.viewdirs, z_vals=z_vals, **kw)

    def apply_rays_semantic_q8(self, rays, z_vals, cfg: RenderConfig):
        """The W8A8 semantic serving forward (kernel 11): raw ``[4, N, S]``
        and the ray-summed logits ``[N, C]``. Eval renders only."""
        kw = self._q8_kw(z_vals, cfg)
        return fused_mlp_t.fused_nerf_apply_rays_semantic_q8(
            rays_o=rays.origins, rays_d=rays.directions,
            viewdirs=rays.viewdirs, z_vals=z_vals, **kw)


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


def _pow(base: float, n: int) -> torch.Tensor:
    """``base ** n`` as the jitted JAX step evaluates a bias correction:
    float32 ``pow`` with the count as a float (``torch.pow`` with a Python
    int exponent multiplies out instead, a few ulps apart)."""
    f32 = torch.float32
    return torch.tensor(base, dtype=f32) ** torch.tensor(float(n), dtype=f32)


class OptaxAdam(torch.optim.Optimizer):
    """optax ``adam(schedule, b1, b2, eps)`` in float32, operation for
    operation, so that a run follows the JAX package's trajectory: moments
    ``(1 - b) g + b m``, bias correction by ``1 - b^t`` at the incremented
    count ``t``, ``eps`` outside the square root, and the update scaled by
    ``-schedule(count)`` read at the count before the step. (torch's
    ``Adam`` rounds differently: ``lerp`` moments and
    ``sqrt(v) / sqrt(1 - b2^t)``; a few ulps apart after a few steps.)"""

    def __init__(self, params, schedule, b1=0.9, b2=0.999, eps=1e-8):
        super().__init__(params, dict(b1=b1, b2=b2, eps=eps))
        self.schedule = schedule
        self.count = 0

    @torch.no_grad()
    def step(self, closure=None):
        if closure is not None:
            raise ValueError("OptaxAdam takes no closure")
        step_size = -self.schedule(self.count)
        self.count += 1
        for group in self.param_groups:
            b1, b2 = group["b1"], group["b2"]
            # Float32 scalars as 0-d tensors on the parameters' device: a CPU
            # scalar divisor would make CUDA multiply by its reciprocal.
            scal = torch.stack([1.0 - _pow(b1, self.count),
                                1.0 - _pow(b2, self.count), step_size])
            on = {}
            for p in group["params"]:
                if p.grad is None:
                    continue
                if p.device not in on:
                    on[p.device] = scal.to(p.device).unbind()
                bc1, bc2, lr = on[p.device]
                g = p.grad
                st = self.state[p]
                if not st:
                    st["exp_avg"] = torch.zeros_like(p)
                    st["exp_avg_sq"] = torch.zeros_like(p)
                mu = (1 - b1) * g + b1 * st["exp_avg"]
                nu = (1 - b2) * (g * g) + b2 * st["exp_avg_sq"]
                st["exp_avg"], st["exp_avg_sq"] = mu, nu
                p.add_((mu / bc1) / (torch.sqrt(nu / bc2) + group["eps"]) * lr)


@dataclasses.dataclass
class TrainState:
    """The models, their optimizer and the step count (the JAX
    ``TrainState`` holds the same as a pytree)."""

    models: Models
    optimizer: OptaxAdam
    step: int = 0


def lr_schedule(cfg: TrainConfig):
    """Learning rate at a step count (JAX ``lr_schedule``), in float32 as
    JAX evaluates it on the int32 count."""
    f32 = torch.float32
    lrate = torch.tensor(cfg.lrate, dtype=f32)
    decay_steps = torch.tensor(cfg.lrate_decay * 1000, dtype=f32)
    base = torch.tensor(0.1, dtype=f32)
    return lambda step: lrate * base ** (torch.tensor(step, dtype=f32)
                                         / decay_steps)


def make_optimizer(cfg: TrainConfig, params) -> OptaxAdam:
    """JAX ``make_optimizer``: ``adam(lr_schedule(cfg), b1=0.9, b2=0.999,
    eps=1e-8)``."""
    return OptaxAdam(params, lr_schedule(cfg), b1=0.9, b2=0.999, eps=1e-8)


def init_train_state(cfg: TrainConfig, models: Models) -> TrainState:
    """Optimizer state over every parameter of the coarse and fine MLPs."""
    params = [p for m in models if m is not None for p in m.parameters()]
    return TrainState(models, make_optimizer(cfg, params), 0)
