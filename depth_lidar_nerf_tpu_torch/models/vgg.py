"""VGG19 feature extractor of the content (perceptual) loss (port of
``models/vgg.py``).

torchvision's VGG19 ``features`` truncated at the deepest requested tap,
returning the post-ReLU activations named ``conv{block}_{idx}`` as the
reference's layer map (``vgg19_feature_model.py:9-64``). Images are NHWC at
the API, as in the JAX package; the convolutions run in NCHW.

Precision: the convolutions are ``torch.nn.functional.conv2d`` on float32
tensors (cuDNN on the card). cuDNN runs them in TF32 when
``torch.backends.cudnn.allow_tf32`` is set, which is PyTorch's default; the
module leaves that flag to its caller, who may clear it for full float32.

Weights: :func:`load_torch_vgg19` reads a torchvision ``state_dict``
(``features.{idx}.weight``/``bias``); without one the module keeps the
initialisation drawn from the generator it was built with (Flax's
LeCun-normal rule, but not Flax's numbers: torch's generator draws other
values than JAX's).
"""

from __future__ import annotations

import math
from typing import Dict, Mapping, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from depth_lidar_nerf_tpu_torch.models.nerf_mlp import _TRUNC_STD

# VGG19 topology: (block, n_convs, filters)
_VGG19_BLOCKS = ((1, 2, 64), (2, 2, 128), (3, 4, 256), (4, 4, 512), (5, 4, 512))

#: All tap names in forward order, e.g. "conv1_1", ..., "conv5_4".
VGG19_TAPS = tuple(
    f"conv{b}_{i + 1}" for b, n, _ in _VGG19_BLOCKS for i in range(n))

# ImageNet normalisation of the reference (vgg19_feature_model.py:60-64).
IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)


def vgg_normalize(images: torch.Tensor) -> torch.Tensor:
    """ImageNet-normalise NHWC images in [0, 1]."""
    mean = images.new_tensor(IMAGENET_MEAN)
    std = images.new_tensor(IMAGENET_STD)
    return (images - mean) / std


def conv2d(in_ch: int, out_ch: int, k: int, stride: int = 1,
           padding: int = 0, bias: bool = True,
           generator: torch.Generator | None = None) -> nn.Conv2d:
    """An ``nn.Conv2d`` initialised as Flax ``Conv``: a LeCun-normal kernel
    over ``fan_in = in_ch * k * k`` (a normal truncated at two standard
    deviations), zero bias."""
    conv = nn.Conv2d(in_ch, out_ch, k, stride=stride, padding=padding,
                     bias=bias)
    std = math.sqrt(1.0 / (in_ch * k * k)) / _TRUNC_STD
    with torch.no_grad():
        nn.init.trunc_normal_(conv.weight, 0.0, std, -2.0 * std, 2.0 * std,
                              generator=generator)
        if bias:
            conv.bias.zero_()
    return conv


def nhwc(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 2, 3, 1)


def nchw(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 3, 1, 2)


class VGG19Features(nn.Module):
    """Runs VGG19 up to the deepest layer in ``taps`` and returns those taps
    (NHWC in, a dict of NHWC activations out)."""

    def __init__(self, taps: Sequence[str] = ("conv1_2", "conv2_2"),
                 generator: torch.Generator | None = None):
        super().__init__()
        unknown = set(taps) - set(VGG19_TAPS)
        if unknown:
            raise ValueError(f"unknown VGG19 taps: {sorted(unknown)}")
        self.taps = tuple(taps)
        self.last = max(VGG19_TAPS.index(t) for t in self.taps)
        in_ch, tap_i = 3, 0
        for block, n_convs, filters in _VGG19_BLOCKS:
            for ci in range(n_convs):
                if tap_i > self.last:
                    break
                self.add_module(f"conv{block}_{ci + 1}",
                                conv2d(in_ch, filters, 3, padding=1,
                                       generator=generator))
                in_ch, tap_i = filters, tap_i + 1

    def forward(self, x: torch.Tensor) -> Dict[str, torch.Tensor]:
        x = nchw(x)
        feats: Dict[str, torch.Tensor] = {}
        tap_i = 0
        for _, n_convs, _ in _VGG19_BLOCKS:
            for _ in range(n_convs):
                name = VGG19_TAPS[tap_i]
                x = F.relu(getattr(self, name)(x))
                if name in self.taps:
                    feats[name] = nhwc(x)
                if tap_i == self.last:
                    return feats
                tap_i += 1
            x = F.max_pool2d(x, 2)  # floors odd sizes, as Flax's VALID pool
        return feats


def _torch_conv_indices():
    """torchvision ``features`` indices of VGG19's convs, in forward order."""
    idx, i = [], 0
    for _, n_convs, _ in _VGG19_BLOCKS:
        for _ in range(n_convs):
            idx.append(i)
            i += 2  # conv, relu
        i += 1  # maxpool
    return idx


def load_torch_vgg19(module: VGG19Features,
                     state_dict: Mapping[str, torch.Tensor]) -> VGG19Features:
    """Copy torchvision ``vgg19().features`` weights into ``module``, the
    layers it has (the truncated network) only."""
    with torch.no_grad():
        for name, idx in zip(VGG19_TAPS, _torch_conv_indices()):
            conv = getattr(module, name, None)
            if conv is None:
                continue
            conv.weight.copy_(torch.as_tensor(state_dict[f"features.{idx}.weight"]))
            conv.bias.copy_(torch.as_tensor(state_dict[f"features.{idx}.bias"]))
    return module
