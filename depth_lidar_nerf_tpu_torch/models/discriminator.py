"""Patch discriminators of the adversarial loss as ``nn.Module``s (port of
``models/discriminator.py``).

Parity targets: ``discriminator.py:19-61`` (ESRGAN-style, the one the train
loop builds, ``run_nerf.py:1253``), ``:64-91`` (LS), ``:93-117`` (Basic) and
``:118-151`` (DC-GAN style; dead code upstream, kept for symbol parity).

Images are ``[B, H, W, C]`` at the API, as in the JAX package, and are
permuted to NCHW for ``F.conv2d``. The modules carry the reference's
parameter names (``model.{i}``, ``classifier.0``, ``adv_layer``,
``blocks.{i}``, ``conv_out``) and flatten the feature map in NCHW order, as
the reference does, so that a reference ``state_dict`` loads by key. Flax
flattens NHWC instead; ``weights.disc_state_dict`` carries a Flax tree
across. LeakyReLU's slope is 0.2 throughout. Weights initialise as Flax's
defaults do: a LeCun-normal kernel over ``fan_in`` (``in * kh * kw`` for a
convolution), zero bias, drawn from the generator given.

Flax's ``padding=((1, 1), (1, 1))`` at stride 2 is ``padding=1`` here: a 3x3
convolution then maps ``n`` rows to ``ceil(n / 2)``, so the classifier's
input size comes from the convolutions' own arithmetic
(:func:`conv_out_size`), never from ``n // 4``.
"""

from __future__ import annotations

import math
from typing import Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from depth_lidar_nerf_tpu_torch.models.nerf_mlp import lecun_normal_
from depth_lidar_nerf_tpu_torch.models.vgg import conv2d, nchw

SLOPE = 0.2


def conv_out_size(n: int, k: int = 3, stride: int = 2,
                  padding: int = 1) -> int:
    """Output rows of a convolution over ``n`` rows."""
    return (n + 2 * padding - k) // stride + 1


def feature_hw(patch_hw: Sequence[int], n_stride2: int) -> Tuple[int, int]:
    """The feature map's ``(h, w)`` after ``n_stride2`` 3x3 stride-2
    convolutions with padding 1 (the stride-1 ones keep the size)."""
    h, w = int(patch_hw[0]), int(patch_hw[1])
    for _ in range(n_stride2):
        h, w = conv_out_size(h), conv_out_size(w)
    return h, w


def _dense(fan_in: int, fan_out: int, generator) -> nn.Linear:
    layer = nn.Linear(fan_in, fan_out)
    lecun_normal_(layer.weight, generator)
    nn.init.zeros_(layer.bias)
    return layer


def _conv_stack(specs, generator) -> nn.Sequential:
    """``Sequential(conv, LeakyReLU, conv, LeakyReLU, ...)``: the convolutions
    at the even indices, as the reference's ``model``."""
    layers = []
    for cin, cout, stride in specs:
        layers += [conv2d(cin, cout, 3, stride=stride, padding=1,
                          generator=generator),
                   nn.LeakyReLU(SLOPE)]
    return nn.Sequential(*layers)


class ESRDiscriminator(nn.Module):
    """Two blocks of 16 and 32 filters, each a stride-1 then a stride-2 3x3
    convolution, then one linear logit over the flattened feature map of a
    ``patch_hw`` crop. ``classifier`` is registered before ``model``, as in
    the reference, so ``parameters()`` runs in the reference's order (its
    Adam moments import by position)."""

    def __init__(self, patch_hw: Sequence[int] = (32, 32),
                 generator: torch.Generator | None = None):
        super().__init__()
        self.patch_hw = tuple(int(x) for x in patch_hw)
        h, w = feature_hw(self.patch_hw, 2)
        self.classifier = nn.Sequential(_dense(32 * h * w, 1, generator))
        self.model = _conv_stack(((3, 16, 1), (16, 16, 2), (16, 32, 1),
                                  (32, 32, 2)), generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:  # [B, H, W, 3]
        return self.classifier(torch.flatten(self.model(nchw(x)), 1))


class LSDiscriminator(nn.Module):
    """Four stride-2 3x3 convolutions (16, 32, 64, 128 filters) and a linear
    logit (``adv_layer``)."""

    def __init__(self, patch_hw: Sequence[int] = (32, 32),
                 generator: torch.Generator | None = None):
        super().__init__()
        self.patch_hw = tuple(int(x) for x in patch_hw)
        self.model = _conv_stack(((3, 16, 2), (16, 32, 2), (32, 64, 2),
                                  (64, 128, 2)), generator)
        h, w = feature_hw(self.patch_hw, 4)
        self.adv_layer = _dense(128 * h * w, 1, generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.adv_layer(torch.flatten(self.model(nchw(x)), 1))


class DCDiscriminator(nn.Module):
    """DC-GAN style (``discriminator.py:118-151``): ``log2(img_size) - 2``
    bias-free 4x4 stride-2 convolutions doubling the features up to
    ``n_feat``, then a bias-free 4x4 VALID convolution to one logit. The
    input is square, of side ``img_size`` a power of two; channels beyond
    ``in_dim`` are sliced off, as the reference's forward does."""

    def __init__(self, in_dim: int = 3, n_feat: int = 512, img_size: int = 32,
                 generator: torch.Generator | None = None):
        super().__init__()
        self.in_dim = in_dim
        n_layers = int(math.log2(img_size) - 2)
        feats = [n_feat // (2 ** (n_layers - 1 - i)) for i in range(n_layers)]
        cins = [in_dim] + feats[:-1]
        self.blocks = nn.ModuleList(
            conv2d(cin, cout, 4, stride=2, padding=1, bias=False,
                   generator=generator) for cin, cout in zip(cins, feats))
        self.conv_out = conv2d(feats[-1] if feats else in_dim, 1, 4,
                               bias=False, generator=generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:  # [B, H, W, C]
        if x.shape[-1] != self.in_dim:
            x = x[..., :self.in_dim]
        h = nchw(x)
        for conv in self.blocks:
            h = F.leaky_relu(conv(h), SLOPE)
        return self.conv_out(h).reshape(x.shape[0], 1)


class BasicDiscriminator(nn.Module):
    """One stride-2 3x3 convolution of 16 filters, dropout, a linear logit.

    ``F.dropout`` takes no generator, so the dropout mask is drawn here from
    the one given to ``forward`` (keep probability ``1 - dropout_rate``, the
    kept values scaled by its inverse, as Flax's ``Dropout``);
    ``deterministic=True`` (the default, as in JAX) applies none."""

    def __init__(self, patch_hw: Sequence[int] = (32, 32),
                 dropout_rate: float = 0.25,
                 generator: torch.Generator | None = None):
        super().__init__()
        self.patch_hw = tuple(int(x) for x in patch_hw)
        self.dropout_rate = dropout_rate
        self.model = _conv_stack(((3, 16, 2),), generator)
        h, w = feature_hw(self.patch_hw, 1)
        self.adv_layer = _dense(16 * h * w, 1, generator)

    def forward(self, x: torch.Tensor, *, deterministic: bool = True,
                generator: torch.Generator | None = None) -> torch.Tensor:
        h = self.model(nchw(x))
        if not deterministic and self.dropout_rate > 0:
            keep = 1.0 - self.dropout_rate
            mask = torch.rand(h.shape, device=h.device,
                              generator=generator) < keep
            h = torch.where(mask, h / keep, torch.zeros_like(h))
        return self.adv_layer(torch.flatten(h, 1))
