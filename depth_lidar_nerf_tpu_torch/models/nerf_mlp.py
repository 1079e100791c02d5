"""The NeRF radiance-field MLP as an ``nn.Module`` (port of ``models/nerf_mlp.py``).

Architecture parity with the reference ``NeRF`` (``run_nerf_helpers.py:77-174``)
and with the Flax module, layer for layer and name for name (``trunk_i``,
``sigma``, ``feature``, ``views_0``, ``rgb``, ``output``, ``semantic_0/1``):

- ``depth`` trunk layers of width ``width`` with ReLU; after layer ``i in
  skips`` the encoded position is concatenated IN FRONT, ``[x, h]``;
- with view directions: a 1-channel density head, a linear ``width``
  feature layer, one ``width // 2`` view layer with ReLU, a 3-channel head;
- an optional semantic head ``Linear(width // 2) -> Linear(C)`` off the
  feature vector;
- output ``[rgb(3), sigma(1), semantic(C)]``.

The frozen-alpha ``NeRF_RGB`` variant (``run_nerf_helpers.py:176-260``) is
expressed as in JAX: ``forward(..., frozen_sigma=s)`` puts ``s`` (the frozen
alpha model's density, computed without a gradient) in place of the density
head's output, and the head is not evaluated, so its parameters get no
gradient.

:class:`ColumnParallelNeRFMLP` splits the wide layers over a model group
(tensor parallelism, ``mesh_shape [dp, tp]``) as JAX's ``shard_params``
splits the Flax kernels.

Parameters are float32; ``dtype`` is the compute type (bfloat16 rounds the
operands of every layer, as Flax ``Dense(dtype=bfloat16)`` does). Weights
initialise as Flax ``Dense`` does: LeCun-normal kernel (a normal truncated at
two standard deviations, rescaled to unit variance over ``fan_in``), zero
bias.
"""

from __future__ import annotations

import math
from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from depth_lidar_nerf_tpu_torch.parallel.mesh import shard_rows, tp_spec
from depth_lidar_nerf_tpu_torch.parallel.tensor import column_parallel_linear

# Standard deviation of a unit normal truncated to [-2, 2] (the constant
# jax.nn.initializers.variance_scaling divides by).
_TRUNC_STD = 0.87962566103423978


def lecun_normal_(weight: torch.Tensor, generator: torch.Generator | None):
    """Flax ``lecun_normal`` on a torch ``[out, in]`` weight."""
    std = math.sqrt(1.0 / weight.shape[1]) / _TRUNC_STD
    with torch.no_grad():
        nn.init.trunc_normal_(weight, 0.0, std, -2.0 * std, 2.0 * std,
                              generator=generator)
    return weight


class NeRFMLP(nn.Module):
    def __init__(self, depth: int = 8, width: int = 256, in_channels: int = 63,
                 in_channels_views: int = 27, skips: Sequence[int] = (4,),
                 use_viewdirs: bool = True, num_semantic_classes: int = 0,
                 output_ch: int = 4, dtype: torch.dtype = torch.float32,
                 generator: torch.Generator | None = None):
        super().__init__()
        self.depth, self.width = depth, width
        self.in_channels, self.in_channels_views = in_channels, in_channels_views
        self.skips = tuple(skips)
        self.use_viewdirs = use_viewdirs
        self.num_semantic_classes = num_semantic_classes
        self.output_ch = output_ch
        self.dtype = dtype

        def dense(name, fan_in, fan_out):
            layer = nn.Linear(fan_in, fan_out)
            lecun_normal_(layer.weight, generator)
            nn.init.zeros_(layer.bias)
            self.add_module(name, layer)

        h_dim = in_channels
        for i in range(depth):
            dense(f"trunk_{i}", h_dim, width)
            h_dim = width + (in_channels if i in self.skips else 0)
        if not use_viewdirs:
            dense("output", h_dim, output_ch)
            return
        dense("sigma", h_dim, 1)
        dense("feature", h_dim, width)
        if num_semantic_classes > 0:
            dense("semantic_0", width, width // 2)
            dense("semantic_1", width // 2, num_semantic_classes)
        dense("views_0", width + in_channels_views, width // 2)
        dense("rgb", width // 2, 3)

    def init_kwargs(self) -> dict:
        """The keywords that build a module of this topology."""
        return dict(depth=self.depth, width=self.width,
                    in_channels=self.in_channels,
                    in_channels_views=self.in_channels_views,
                    skips=self.skips, use_viewdirs=self.use_viewdirs,
                    num_semantic_classes=self.num_semantic_classes,
                    output_ch=self.output_ch, dtype=self.dtype)

    def _dense(self, name: str, x: torch.Tensor) -> torch.Tensor:
        layer = getattr(self, name)
        return F.linear(x, layer.weight.to(self.dtype), layer.bias.to(self.dtype))

    def forward(self, pts_embed: torch.Tensor,
                views_embed: torch.Tensor | None = None,
                frozen_sigma: torch.Tensor | None = None) -> torch.Tensor:
        x = pts_embed.to(self.dtype)
        h = x
        for i in range(self.depth):
            h = torch.relu(self._dense(f"trunk_{i}", h))
            if i in self.skips:
                h = torch.cat([x, h], dim=-1)
        if not self.use_viewdirs:
            return self._dense("output", h)

        sigma = (self._dense("sigma", h) if frozen_sigma is None
                 else frozen_sigma.to(self.dtype))
        feature = self._dense("feature", h)
        semantic = None
        if self.num_semantic_classes > 0:
            semantic = self._dense("semantic_1",
                                   self._dense("semantic_0", feature))
        h = torch.cat([feature, views_embed.to(self.dtype)], dim=-1)
        h = torch.relu(self._dense("views_0", h))
        rgb = self._dense("rgb", h)
        out = torch.cat([rgb, sigma], dim=-1)
        if semantic is not None:
            out = torch.cat([out, semantic], dim=-1)
        return out


class ColumnParallelNeRFMLP(NeRFMLP):
    """A :class:`NeRFMLP` whose wide layers are split by output over the
    model group of ``mesh`` (a :class:`~parallel.mesh.RayMesh` with ``tp >
    1``): a layer whose weight :func:`~parallel.mesh.tp_spec` splits holds
    model rank ``t``'s rows of its weight and bias and runs as
    :func:`~parallel.tensor.column_parallel_linear`; the narrow heads are
    whole on every rank. At W=256 and tp=2 the trunk, ``feature`` (256
    outputs), ``views_0`` and ``semantic_0`` (128) are split; ``sigma``,
    ``rgb``, ``semantic_1`` and ``output`` are not.

    It is made from ``whole``, a :class:`NeRFMLP` of one process: this
    rank's rows of the split layers, copies of the others, so that a run
    from a seed starts from one process's weights (JAX's
    ``init_train_state`` + ``shard_params``). ``full_shapes`` holds each
    state-dict entry's shape in one process."""

    def __init__(self, *, whole: NeRFMLP, mesh):
        with torch.device("meta"):  # the topology; the values are whole's
            super().__init__(**whole.init_kwargs())
        self.tp, self.tp_rank = mesh.tp, mesh.tp_rank
        self.model_group = mesh.model_group
        self.full_shapes = {k: tuple(v.shape)
                            for k, v in whole.state_dict().items()}
        self.sharded = {name for name, layer in self.named_children()
                        if tp_spec(layer.weight.shape, self.tp) is not None}
        for name, layer in list(self.named_children()):
            for kind in ("weight", "bias"):
                src = getattr(getattr(whole, name), kind)
                part = shard_rows(src.detach(), self.tp, self.tp_rank)
                setattr(layer, kind, nn.Parameter(
                    part.clone(), requires_grad=src.requires_grad))
            layer.out_features = layer.weight.shape[0]

    def _dense(self, name: str, x: torch.Tensor) -> torch.Tensor:
        if name not in self.sharded:
            return super()._dense(name, x)
        layer = getattr(self, name)
        return column_parallel_linear(x, layer.weight.to(self.dtype),
                                      layer.bias.to(self.dtype),
                                      self.model_group)
