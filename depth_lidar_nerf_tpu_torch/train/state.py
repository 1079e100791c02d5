"""Model + optimizer factory and the train state (port of ``train/state.py``).

Builds the coarse and fine NeRF MLPs of ``create_nerf`` (``run_nerf.py:389-517``)
as ``nn.Module``s on one device, with weights drawn from a seeded
``torch.Generator``, the frozen perceptual model of the feature loss
(VGG19 or LPIPS), whose weights are read from disk where a file is found,
and with ``gan_loss`` the discriminator (``run_nerf.py:1253-1264``) with its
own Adam at the constant rate ``gan_disc_lrate``. With ``alpha_model_path``
the density comes from a frozen pretrained fine MLP
(:class:`FrozenAlphaMLP`, :class:`FrozenModel`; ``run_nerf.py:400-431``).
:class:`FusedMLP` dispatches covered topologies to the fused kernels. On a
mesh with a model axis (``mesh_shape [dp, tp]``, ``tp > 1``) the MLPs are
column-parallel plain modules (:func:`shard_models`), JAX's Flax route
under tensor parallelism; the fused kernels are per-device there, in both
packages. The optimizer is Adam with the reference's continuous
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
from depth_lidar_nerf_tpu_torch.models.discriminator import ESRDiscriminator
from depth_lidar_nerf_tpu_torch.models.lpips import init_lpips
from depth_lidar_nerf_tpu_torch.models.nerf_mlp import (ColumnParallelNeRFMLP,
                                                        NeRFMLP)
from depth_lidar_nerf_tpu_torch.models.vgg import (VGG19Features,
                                                   load_torch_vgg19)
from depth_lidar_nerf_tpu_torch.ops import fused_mlp, fused_mlp_t
from depth_lidar_nerf_tpu_torch.ops.embedding import embedding_dim
from depth_lidar_nerf_tpu_torch.parallel.mesh import model_parallel_size
from depth_lidar_nerf_tpu_torch.render.renderer import RenderConfig
from depth_lidar_nerf_tpu_torch.train.config import TrainConfig
from depth_lidar_nerf_tpu_torch.weights import shard_mlp_state_dict


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


class FrozenAlphaMLP(NeRFMLP):
    """The ``NeRF_RGB`` variant (``run_nerf_helpers.py:176-260``; JAX
    ``FrozenAlphaMLP``): a :class:`NeRFMLP` whose density comes from a
    frozen pretrained alpha model. Its forward evaluates ``alpha_module``
    under ``torch.no_grad()`` and passes column 3 of that raw output as
    ``frozen_sigma``, so only the colour branch trains and the density head
    gets no gradient. The alpha model is held outside the module's
    parameters: it is neither optimized nor checkpointed, as in JAX. The
    parameter names are :class:`NeRFMLP`'s, so checkpoints and weight
    conversions treat it as one."""

    def __init__(self, alpha_module: nn.Module, **kw):
        super().__init__(**kw)
        object.__setattr__(self, "alpha_module", alpha_module)

    def forward(self, pts_embed, views_embed=None):
        with torch.no_grad():
            fs = self.alpha_module(pts_embed, views_embed)[..., 3:4]
        return super().forward(pts_embed, views_embed, frozen_sigma=fs)


class ColumnParallelFrozenAlphaMLP(FrozenAlphaMLP, ColumnParallelNeRFMLP):
    """A :class:`FrozenAlphaMLP` whose trained layers are column-parallel
    (:class:`~models.nerf_mlp.ColumnParallelNeRFMLP`); the frozen alpha
    model is whole on every rank, as JAX keeps its parameters outside the
    sharded state."""


class FrozenModel(nn.Module):
    """A wholly frozen field (the ``--no_coarse`` path, ``run_nerf.py:417-419,
    606-616``; JAX ``FrozenModel``): the coarse pass queries the pretrained
    alpha model under ``torch.no_grad()``. It has no parameters of its own
    (JAX keeps an unused tree for its optimizer), so nothing of it trains or
    is checkpointed."""

    def __init__(self, module: nn.Module):
        super().__init__()
        object.__setattr__(self, "module", module)
        self.dtype = getattr(module, "dtype", torch.float32)

    def forward(self, pts_embed, views_embed=None):
        with torch.no_grad():
            return self.module(pts_embed, views_embed)


class Models(NamedTuple):
    """The trained NeRF MLPs, the frozen perceptual model of the feature
    loss (``vgg`` with ``feature_loss_type = vgg``, ``lpips`` with
    ``lpips``; None otherwise) and with ``gan_loss`` the discriminator."""

    coarse: nn.Module
    fine: Optional[nn.Module]
    vgg: Optional[nn.Module] = None
    lpips: Optional[nn.Module] = None
    discriminator: Optional[nn.Module] = None

    def nerfs(self):
        """The trained MLPs: the coarse one, and the fine one if any."""
        return [m for m in (self.coarse, self.fine) if m is not None]


def invalidate_packs(models: Models) -> None:
    """Forget every ``FusedMLP``'s packed weights (after an optimizer step
    or a load), so that no pack of earlier weights survives."""
    for m in models.nerfs():
        if hasattr(m, "invalidate_pack"):
            m.invalidate_pack()


def _weight_file(env: str, path: str) -> Optional[str]:
    """``$env`` if it names a file, else ``path`` if it exists, else None
    (JAX ``init_vgg_params``' search order)."""
    for cand in (os.environ.get(env), path):
        if cand and os.path.exists(cand):
            return cand
    return None


def build_perceptual(cfg: TrainConfig, device):
    """The feature loss's frozen model (JAX ``build_models`` +
    ``init_vgg_params``): ``(vgg, lpips)``, one of them or neither built.

    VGG19 (``feature_loss_type = vgg``) up to the deepest of ``vgg_layers``
    (``conv1_2``, ``conv2_2`` when none are given), with torchvision's
    weights from ``$VGG19_TORCH_WEIGHTS``, else ``<datadir>/vgg19.pth``;
    LPIPS (``lpips``, ``lpips_backbone``, ``lpips_spatial``) with an
    ``lpips`` package state dict from ``$LPIPS_TORCH_WEIGHTS``, else
    ``<datadir>/lpips_<backbone>.pth``. Without a file the weights are drawn
    from a ``torch.Generator`` seeded 0, Flax's rule but not Flax's numbers,
    so such a run's feature loss differs from JAX's. Nothing is downloaded.
    The weights are frozen (``requires_grad=False``, eval mode): they are
    not trained, not in the optimizer and not in checkpoints, as in JAX."""
    if not cfg.feature_loss:
        return None, None
    if cfg.feature_loss_type == "lpips":
        return None, init_lpips(
            cfg.lpips_backbone, spatial=cfg.lpips_spatial, device=device,
            weights_path=_weight_file("LPIPS_TORCH_WEIGHTS", os.path.join(
                cfg.datadir, f"lpips_{cfg.lpips_backbone}.pth")))
    if cfg.feature_loss_type != "vgg":
        raise ValueError("FEATURE LOSS TYPE CAN BE vgg OR lpips")
    model = VGG19Features(taps=tuple(cfg.vgg_layers or ("conv1_2", "conv2_2")),
                          generator=torch.Generator().manual_seed(0))
    path = _weight_file("VGG19_TORCH_WEIGHTS",
                        os.path.join(cfg.datadir, "vgg19.pth"))
    if path:
        load_torch_vgg19(model, torch.load(path, map_location="cpu",
                                           weights_only=True))
    return model.requires_grad_(False).eval().to(device), None


def check_tp_route(cfg: TrainConfig) -> None:
    """JAX ``build_models``' refusal of the fused kernels on a mesh with a
    model axis: they are per-device, and tensor parallelism takes the plain
    modules. A frozen-alpha run takes them anyway (JAX's alpha branch
    returns before the check)."""
    if cfg.use_fused_mlp and not cfg.alpha_model_path and cfg.mesh_shape \
            and len(cfg.mesh_shape) == 2 and cfg.mesh_shape[1] > 1:
        raise ValueError(
            "use_fused_mlp with a model-TP mesh (mesh_shape=[dp, tp], "
            "tp > 1) is unsupported; the fused kernels are per-device. "
            "Use the plain modules (--use_fused_mlp False) for tensor "
            "parallelism.")


def build_models(cfg: TrainConfig, rcfg: RenderConfig, device=None,
                 seed: int | None = None) -> Models:
    """Coarse and fine MLPs on ``device`` (``cuda`` unless given), weights
    from ``torch.Generator().manual_seed(seed)`` (default ``cfg.seed``), with
    ``feature_loss`` the frozen perceptual model (:func:`build_perceptual`),
    and with ``gan_loss`` an :class:`~models.discriminator.ESRDiscriminator`
    for the ``nH x nW`` crop, drawn from the same generator after the MLPs.

    With ``alpha_model_path`` (JAX ``build_models``' alpha branch): the
    alpha model, a fine-width MLP without a semantic head, is read by
    :func:`load_alpha_params`; the fine MLP (and the coarse one, unless
    ``no_coarse`` makes the coarse pass a :class:`FrozenModel` of it) becomes
    a :class:`FrozenAlphaMLP`.

    ``use_fused_mlp`` with ``mesh_shape [dp, tp]``, ``tp > 1``, raises
    ``ValueError`` (:func:`check_tp_route`). The MLPs are whole; a
    tensor-parallel run splits them with its state
    (:func:`shard_train_state`)."""
    device = resolve_device(device)
    check_tp_route(cfg)
    gen = torch.Generator().manual_seed(cfg.seed if seed is None else seed)
    pts_dim = embedding_dim(3, rcfg.multires)
    views_dim = embedding_dim(3, rcfg.multires_views) if cfg.use_viewdirs else 0
    dtype = torch.bfloat16 if cfg.compute_dtype == "bfloat16" else torch.float32
    output_ch = 5 if cfg.N_importance > 0 else 4  # run_nerf.py:398
    kw = dict(in_channels=pts_dim, in_channels_views=views_dim,
              use_viewdirs=cfg.use_viewdirs, output_ch=output_ch, dtype=dtype)

    # On the card a covered topology takes the kernel; the flag picks the
    # plain module on the CPU only. JAX's alpha branch returns before it
    # wraps the MLPs in its FusedMLP, so a frozen-alpha run evaluates plain
    # modules in both packages (sampling still takes kernel 14): that is
    # the reference package's route, not a fallback. So is tensor
    # parallelism's (shard_models).
    alpha = None
    if cfg.alpha_model_path:
        alpha = NeRFMLP(depth=cfg.netdepth_fine, width=cfg.netwidth_fine,
                        generator=torch.Generator().manual_seed(0), **kw)
        load_alpha_params(cfg, alpha)
        alpha = alpha.requires_grad_(False).eval().to(device)
    cls = FusedMLP if cfg.use_fused_mlp or device.type == "cuda" else NeRFMLP

    def mlp(depth, width):
        sem = rcfg.num_semantic_classes
        if alpha is not None:
            return FrozenAlphaMLP(alpha, depth=depth, width=width,
                                  num_semantic_classes=sem, generator=gen,
                                  **kw).to(device)
        return cls(depth=depth, width=width, num_semantic_classes=sem,
                   generator=gen, **kw).to(device)

    coarse = mlp(cfg.netdepth, cfg.netwidth)
    fine = mlp(cfg.netdepth_fine, cfg.netwidth_fine) if cfg.N_importance > 0 \
        else None
    if alpha is not None and cfg.no_coarse:
        coarse = FrozenModel(alpha)
    disc = None
    if cfg.gan_loss:
        disc = ESRDiscriminator((cfg.nH, cfg.nW), generator=gen).to(device)
    return Models(coarse, fine, *build_perceptual(cfg, device), disc)


def _column_parallel(module, mesh):
    """``module`` (a whole MLP) as this rank's column-parallel part of it;
    a :class:`FrozenModel` or None as it is."""
    if not isinstance(module, NeRFMLP):
        return module
    if isinstance(module, FrozenAlphaMLP):
        return ColumnParallelFrozenAlphaMLP(module.alpha_module, whole=module,
                                            mesh=mesh)
    return ColumnParallelNeRFMLP(whole=module, mesh=mesh)


def shard_models(models: Models, mesh) -> Models:
    """``models`` with each trained MLP split over the model group of
    ``mesh`` (:class:`~models.nerf_mlp.ColumnParallelNeRFMLP`, this rank's
    rows of the wide layers; JAX ``shard_params``). The discriminator and
    the perceptual model stay whole: JAX's rule also places the
    discriminator's 1-D biases on the model axis, which moves bytes, not
    results. Without a mesh, or at ``tp`` 1, ``models`` as they are."""
    if model_parallel_size(mesh) <= 1:
        return models
    return models._replace(coarse=_column_parallel(models.coarse, mesh),
                           fine=_column_parallel(models.fine, mesh))


def shard_train_state(state: TrainState, mesh) -> TrainState:
    """``state`` (whole MLPs) split over the model group of ``mesh``:
    :func:`shard_models`, and the MLPs' Adam moments split as their
    parameters, the count kept. The discriminator and its optimizer are
    kept. Without a model axis, ``state`` as it is."""
    if model_parallel_size(mesh) <= 1:
        return state
    old = state.optimizer
    models = shard_models(state.models, mesh)
    params = []
    for whole, part in zip(state.models.nerfs(), models.nerfs()):
        moments = {}
        for name, p in whole.named_parameters():
            if old.state.get(p):  # the moments have the parameter's shape
                moments[name] = shard_mlp_state_dict(old.state[p], mesh.tp,
                                                     mesh.tp_rank)
        params.extend((p, moments.get(name))
                      for name, p in part.named_parameters())
    opt = OptaxAdam([p for p, _ in params], old.schedule,
                    **{k: old.defaults[k] for k in ("b1", "b2", "eps")})
    for p, st in params:
        if st:
            opt.state[p] = {k: v.clone() for k, v in st.items()}
    opt.count = old.count
    state.models, state.optimizer = models, opt
    return state


def load_alpha_params(cfg: TrainConfig, alpha_module: nn.Module) -> nn.Module:
    """Load the frozen alpha model's weights into ``alpha_module`` (JAX
    ``load_alpha_params``, which reads its own orbax step directory): the
    fine MLP of a checkpoint of this package, ``alpha_model_path`` naming
    its ``<step>.pt`` file or a directory of them (the newest is taken). The
    file's topology must be the alpha model's (the fine widths, the
    encodings, no semantic head), else the load is refused with the message
    of ``checkpoint.restore``."""
    from depth_lidar_nerf_tpu_torch.train import checkpoint

    path = cfg.alpha_model_path
    if os.path.isdir(path):
        last = checkpoint.latest_step(path)
        if last is None:
            raise FileNotFoundError(f"no checkpoint (<step>.pt) in {path}")
        path = checkpoint.path_of(path, last)
    ckpt = checkpoint.load_file(path)
    if ckpt.get("format") != checkpoint.FORMAT:
        raise ValueError(f"{path} is not a checkpoint of this package "
                         f"(format {checkpoint.FORMAT!r})")
    topo = checkpoint.topology(cfg.replace(N_importance=1), 0)
    topo = {k: topo[k] for k in ("netdepth_fine", "netwidth_fine",
                                 "use_viewdirs", "multires", "multires_views",
                                 "num_semantic_classes")}
    checkpoint.check_topology(ckpt["topology"], topo, path)
    if ckpt["models"]["fine"] is None:
        raise ValueError(f"{path} has no fine MLP to take the density from")
    alpha_module.load_state_dict(ckpt["models"]["fine"])
    return alpha_module


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
    ``sqrt(v) / sqrt(1 - b2^t)``; a few ulps apart after a few steps.)

    optax updates every parameter: a parameter without a gradient in a step
    (the coarse MLP of a grid step) takes a zero gradient, so its moments
    decay and it still moves by its first moment. One that has never had a
    gradient has zero moments and an update of exactly 0, so it is left
    without state."""

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
                if p.grad is None and not self.state.get(p):
                    continue
                st = self.state[p]
                if p.device not in on:
                    on[p.device] = scal.to(p.device).unbind()
                bc1, bc2, lr = on[p.device]
                g = p.grad if p.grad is not None else torch.zeros_like(p)
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
    # The discriminator's Adam (JAX ``disc_opt_state``); None without the GAN.
    disc_optimizer: Optional[OptaxAdam] = None


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


def make_disc_optimizer(cfg: TrainConfig, params) -> OptaxAdam:
    """JAX ``make_disc_optimizer``: ``adam(gan_disc_lrate, b1=0.9,
    b2=0.999, eps=1e-8)``, a constant rate."""
    lr = torch.tensor(cfg.gan_disc_lrate, dtype=torch.float32)
    return OptaxAdam(params, lambda step: lr, b1=0.9, b2=0.999, eps=1e-8)


def init_train_state(cfg: TrainConfig, models: Models) -> TrainState:
    """Optimizer state over every parameter of the coarse and fine MLPs, and
    with a discriminator its own optimizer over its parameters."""
    params = [p for m in models.nerfs() for p in m.parameters()]
    disc_opt = None
    if models.discriminator is not None:
        disc_opt = make_disc_optimizer(cfg, models.discriminator.parameters())
    return TrainState(models, make_optimizer(cfg, params), 0,
                      disc_optimizer=disc_opt)
