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

    def _dense(self, name: str, x: torch.Tensor) -> torch.Tensor:
        layer = getattr(self, name)
        return F.linear(x, layer.weight.to(self.dtype), layer.bias.to(self.dtype))

    def forward(self, pts_embed: torch.Tensor,
                views_embed: torch.Tensor | None = None) -> torch.Tensor:
        x = pts_embed.to(self.dtype)
        h = x
        for i in range(self.depth):
            h = torch.relu(self._dense(f"trunk_{i}", h))
            if i in self.skips:
                h = torch.cat([x, h], dim=-1)
        if not self.use_viewdirs:
            return self._dense("output", h)

        sigma = self._dense("sigma", h)
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
