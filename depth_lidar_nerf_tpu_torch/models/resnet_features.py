"""Truncated ResNet-18 feature extractor, an alternative perceptual backbone
(port of ``models/resnet_features.py``).

Parity: ``external_models_resnet.py:17-40`` — torchvision resnet18 cut at a
named layer, used as a drop-in alternative to VGG19 for the content loss.
Images are NHWC at the API, as in the JAX package; the convolutions run in
NCHW. The parameter names are the JAX module's (``stem``, ``stem_bn``,
``layer{i}_{j}.conv1`` ... ``proj``, ``bn_proj``); :func:`load_torch_resnet18`
maps a torchvision ``state_dict`` onto them. BatchNorm uses its running
statistics in eval mode (JAX ``train=False``) and the batch's in train mode.
"""

from __future__ import annotations

from typing import Mapping

import torch
import torch.nn.functional as F
from torch import nn

from depth_lidar_nerf_tpu_torch.models.vgg import nchw, nhwc


class BasicBlock(nn.Module):
    """Two 3x3 convolutions with explicit padding 1 (JAX's ``BasicBlock``
    pads as torch does: "SAME" would align a stride-2 window otherwise on an
    even input), and a 1x1 projection where the shape changes."""

    def __init__(self, in_ch: int, filters: int, strides: int = 1):
        super().__init__()
        self.conv1 = nn.Conv2d(in_ch, filters, 3, strides, 1, bias=False)
        self.bn1 = nn.BatchNorm2d(filters)
        self.conv2 = nn.Conv2d(filters, filters, 3, 1, 1, bias=False)
        self.bn2 = nn.BatchNorm2d(filters)
        self.proj = self.bn_proj = None
        if in_ch != filters or strides != 1:
            self.proj = nn.Conv2d(in_ch, filters, 1, strides, bias=False)
            self.bn_proj = nn.BatchNorm2d(filters)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.relu(self.bn1(self.conv1(x)))
        y = self.bn2(self.conv2(y))
        if self.proj is not None:
            x = self.bn_proj(self.proj(x))
        return F.relu(x + y)


_STAGES = (("layer1", 64, 1), ("layer2", 128, 2), ("layer3", 256, 2),
           ("layer4", 512, 2))


class ResNet18Features(nn.Module):
    """Runs resnet18 up to ``output_layer`` ('layer1'..'layer4'); NHWC in
    and out."""

    def __init__(self, output_layer: str = "layer1"):
        super().__init__()
        self.output_layer = output_layer
        self.stem = nn.Conv2d(3, 64, 7, 2, 3, bias=False)
        self.stem_bn = nn.BatchNorm2d(64)
        in_ch = 64
        for name, filters, stride in _STAGES:
            setattr(self, f"{name}_0", BasicBlock(in_ch, filters, stride))
            setattr(self, f"{name}_1", BasicBlock(filters, filters, 1))
            in_ch = filters
            if name == output_layer:
                break

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = F.relu(self.stem_bn(self.stem(nchw(x))))
        x = F.max_pool2d(x, 3, 2, 1)
        for name, _, _ in _STAGES:
            x = getattr(self, f"{name}_1")(getattr(self, f"{name}_0")(x))
            if name == self.output_layer:
                break
        return nhwc(x)


def _torch_key(key: str) -> str:
    """A parameter or buffer name of :class:`ResNet18Features` -> its
    torchvision ``resnet18`` name."""
    head, rest = key.split(".", 1)
    if head == "stem":
        return f"conv1.{rest}"
    if head == "stem_bn":
        return f"bn1.{rest}"
    layer, block = head.split("_")
    mod, leaf = rest.split(".", 1)
    mod = {"proj": "downsample.0", "bn_proj": "downsample.1"}.get(mod, mod)
    return f"{layer}.{block}.{mod}.{leaf}"


def load_torch_resnet18(module: ResNet18Features,
                        state_dict: Mapping[str, torch.Tensor]
                        ) -> ResNet18Features:
    """Copy a torchvision ``resnet18()`` state_dict into ``module`` (JAX
    ``load_torch_resnet18``): only the layers the truncated network has are
    read; the convolutions keep torch's OIHW layout, BatchNorm's weight,
    bias and running statistics map one to one. Returns ``module``."""
    module.load_state_dict({
        k: v if k.endswith("num_batches_tracked")
        else torch.as_tensor(state_dict[_torch_key(k)])
        for k, v in module.state_dict().items()})
    return module
