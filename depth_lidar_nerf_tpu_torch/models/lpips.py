"""LPIPS perceptual distance with the AlexNet, VGG16 and SqueezeNet1.1
backbones (port of ``models/lpips.py``).

The reference uses the ``lpips`` package as a train-time feature loss and as
a test metric (``run_nerf.py:1240-1246,1316``). The recipe: backbone
features at the canonical taps, unit-normalised over channels, squared
difference, a 1x1 linear head per tap, the spatial mean (or with
``spatial`` the map upsampled bilinearly to the image), summed over taps.
Images are NHWC at the API, as in the JAX package.

Precision: the convolutions are ``torch.nn.functional.conv2d`` on float32
tensors; cuDNN runs them in TF32 when ``torch.backends.cudnn.allow_tf32`` is
set (PyTorch's default), a flag this module leaves to its caller.

Weights: :func:`load_torch_lpips` reads an ``lpips`` package
``state_dict`` (or torchvision's ``features.{idx}`` names); without one the
module keeps the initialisation drawn from its generator (Flax's rule, not
Flax's numbers), with :func:`abs_lin_heads` making the distance
non-negative.
"""

from __future__ import annotations

from typing import Dict, Mapping

import torch
import torch.nn.functional as F
from torch import nn

from depth_lidar_nerf_tpu_torch.device import resolve_device
from depth_lidar_nerf_tpu_torch.models.vgg import conv2d, nchw, nhwc

# LPIPS input normalisation (the lpips package's scaling layer).
_SHIFT = (-0.030, -0.088, -0.188)
_SCALE = (0.458, 0.448, 0.450)


class AlexNetFeatures(nn.Module):
    """AlexNet's conv trunk returning the 5 LPIPS taps (relu1..relu5)."""

    def __init__(self, generator: torch.Generator | None = None):
        super().__init__()
        g = generator
        self.conv1 = conv2d(3, 64, 11, 4, 2, generator=g)
        self.conv2 = conv2d(64, 192, 5, 1, 2, generator=g)
        self.conv3 = conv2d(192, 384, 3, 1, 1, generator=g)
        self.conv4 = conv2d(384, 256, 3, 1, 1, generator=g)
        self.conv5 = conv2d(256, 256, 3, 1, 1, generator=g)

    def forward(self, x) -> Dict[str, torch.Tensor]:  # NCHW
        taps = {}
        x = taps["relu1"] = F.relu(self.conv1(x))
        x = F.relu(self.conv2(F.max_pool2d(x, 3, 2)))
        taps["relu2"] = x
        x = F.relu(self.conv3(F.max_pool2d(x, 3, 2)))
        taps["relu3"] = x
        x = taps["relu4"] = F.relu(self.conv4(x))
        taps["relu5"] = F.relu(self.conv5(x))
        return taps


ALEX_TAP_CHANNELS = {"relu1": 64, "relu2": 192, "relu3": 384, "relu4": 256,
                     "relu5": 256}

# (n_convs, channels, tap) of VGG16's blocks.
_VGG16_PLAN = ((2, 64, "relu1"), (2, 128, "relu2"), (3, 256, "relu3"),
               (3, 512, "relu4"), (3, 512, "relu5"))


class VGG16Features(nn.Module):
    """VGG16's conv trunk returning the 5 LPIPS taps (relu1_2..relu5_3):
    3x3 convs with padding 1, 2x2 max-pools between blocks."""

    def __init__(self, generator: torch.Generator | None = None):
        super().__init__()
        in_ch = 3
        for bi, (n_convs, ch, _) in enumerate(_VGG16_PLAN, start=1):
            for ci in range(1, n_convs + 1):
                self.add_module(f"conv{bi}_{ci}", conv2d(
                    in_ch, ch, 3, 1, 1, generator=generator))
                in_ch = ch

    def forward(self, x) -> Dict[str, torch.Tensor]:  # NCHW
        taps = {}
        for bi, (n_convs, _, tap) in enumerate(_VGG16_PLAN, start=1):
            if bi > 1:
                x = F.max_pool2d(x, 2)
            for ci in range(1, n_convs + 1):
                x = F.relu(getattr(self, f"conv{bi}_{ci}")(x))
            taps[tap] = x
        return taps


VGG_TAP_CHANNELS = {"relu1": 64, "relu2": 128, "relu3": 256, "relu4": 512,
                    "relu5": 512}


def _ceil_max_pool(x: torch.Tensor, k: int = 3, s: int = 2) -> torch.Tensor:
    """torch ``MaxPool2d(k, s, ceil_mode=True)``: a last window that starts
    in bounds but runs over the edge is kept and pools the values in bounds
    (JAX pads with -inf to the same effect)."""
    return F.max_pool2d(x, k, s, ceil_mode=True)


class Fire(nn.Module):
    """SqueezeNet's Fire: a 1x1 squeeze with ReLU, then 1x1 and 3x3 expands
    with ReLU, concatenated over channels (the 1x1 first, as torchvision)."""

    def __init__(self, in_ch: int, squeeze_ch: int, expand_ch: int,
                 generator: torch.Generator | None = None):
        super().__init__()
        g = generator
        self.squeeze = conv2d(in_ch, squeeze_ch, 1, generator=g)
        self.expand1x1 = conv2d(squeeze_ch, expand_ch, 1, generator=g)
        self.expand3x3 = conv2d(squeeze_ch, expand_ch, 3, 1, 1, generator=g)

    def forward(self, x):  # NCHW
        s = F.relu(self.squeeze(x))
        return torch.cat([F.relu(self.expand1x1(s)), F.relu(self.expand3x3(s))],
                         dim=1)


# torchvision squeezenet1_1 ``features`` indices of the Fire modules and
# their (squeeze, expand) channels; the modules are named ``fire_{idx}``.
_SQUEEZE_FIRES = ((3, 16, 64), (4, 16, 64), (6, 32, 128), (7, 32, 128),
                  (9, 48, 192), (10, 48, 192), (11, 64, 256), (12, 64, 256))


class SqueezeNetFeatures(nn.Module):
    """SqueezeNet1.1's conv trunk returning the 7 LPIPS taps: a 3x3 stride-2
    stem, ceil-mode 3x3 stride-2 max-pools, eight Fire modules; taps at the
    lpips package's slice boundaries (after features 1, 4, 7, 9-12)."""

    def __init__(self, generator: torch.Generator | None = None):
        super().__init__()
        self.conv1 = conv2d(3, 64, 3, 2, 0, generator=generator)
        in_ch = 64
        for idx, sq, ex in _SQUEEZE_FIRES:
            self.add_module(f"fire_{idx}", Fire(in_ch, sq, ex, generator))
            in_ch = 2 * ex

    def forward(self, x) -> Dict[str, torch.Tensor]:  # NCHW
        fire = {idx: getattr(self, f"fire_{idx}") for idx, _, _ in _SQUEEZE_FIRES}
        taps = {}
        x = taps["relu1"] = F.relu(self.conv1(x))
        x = taps["relu2"] = fire[4](fire[3](_ceil_max_pool(x)))
        x = taps["relu3"] = fire[7](fire[6](_ceil_max_pool(x)))
        x = taps["relu4"] = fire[9](_ceil_max_pool(x))
        x = taps["relu5"] = fire[10](x)
        x = taps["relu6"] = fire[11](x)
        taps["relu7"] = fire[12](x)
        return taps


SQUEEZE_TAP_CHANNELS = {"relu1": 64, "relu2": 128, "relu3": 256,
                        "relu4": 384, "relu5": 384, "relu6": 512,
                        "relu7": 512}

_BACKBONES = {
    "alex": (AlexNetFeatures, ALEX_TAP_CHANNELS),
    "vgg": (VGG16Features, VGG_TAP_CHANNELS),
    "squeeze": (SqueezeNetFeatures, SQUEEZE_TAP_CHANNELS),
}


def _unit_normalize(x: torch.Tensor, eps: float = 1e-10) -> torch.Tensor:
    """Divide by the channel norm (dim 1, NCHW) plus ``eps``."""
    return x / (torch.sqrt(torch.sum(x**2, dim=1, keepdim=True)) + eps)


class LPIPS(nn.Module):
    """LPIPS distance (``backbone`` alex, vgg or squeeze). ``forward(img0,
    img1)`` takes NHWC images in [0, 1] (``normalize=True``, the lpips
    package's) or in [-1, 1] (``normalize=False``) and returns ``[B]``, or
    with ``spatial`` the ``[B, H, W, 1]`` map."""

    def __init__(self, spatial: bool = False, backbone: str = "alex",
                 generator: torch.Generator | None = None):
        super().__init__()
        if backbone not in _BACKBONES:
            raise ValueError(f"unknown LPIPS backbone {backbone!r}")
        self.spatial, self.backbone_name = spatial, backbone
        net_cls, self.tap_channels = _BACKBONES[backbone]
        self.backbone = net_cls(generator)
        for tap, ch in self.tap_channels.items():
            self.add_module(f"lin_{tap}", conv2d(ch, 1, 1, bias=False,
                                                 generator=generator))

    def forward(self, img0: torch.Tensor, img1: torch.Tensor,
                normalize: bool = True) -> torch.Tensor:
        if normalize:  # [0, 1] -> [-1, 1]
            img0, img1 = img0 * 2.0 - 1.0, img1 * 2.0 - 1.0
        shift, scale = img0.new_tensor(_SHIFT), img0.new_tensor(_SCALE)
        n = img0.shape[0]
        x = nchw((torch.cat([img0, img1]) - shift) / scale)
        feats = self.backbone(x)
        total = 0.0
        for tap in self.tap_channels:
            f = _unit_normalize(feats[tap])
            d = getattr(self, f"lin_{tap}")((f[:n] - f[n:]) ** 2)  # [B,1,h,w]
            if self.spatial:
                total = total + nhwc(F.interpolate(
                    d, size=img0.shape[1:3], mode="bilinear",
                    align_corners=False))
            else:
                total = total + torch.mean(d, dim=(1, 2, 3))
        return total


def abs_lin_heads(module: LPIPS) -> LPIPS:
    """The abs of the linear heads' weights only (torch lpips trains them
    non-negative, so this leaves loaded heads as they are); the backbone
    keeps its signs."""
    with torch.no_grad():
        for tap in module.tap_channels:
            w = getattr(module, f"lin_{tap}").weight
            w.copy_(w.abs())
    return module


def init_lpips(backbone: str = "alex", weights_path: str | None = None,
               spatial: bool = False, device=None) -> LPIPS:
    """An LPIPS module on ``device`` (the card unless given): weights from
    ``weights_path`` when given, else drawn from a generator seeded 0; the
    heads made non-negative; frozen (``requires_grad=False``, eval mode)."""
    device = resolve_device(device)
    model = LPIPS(spatial=spatial, backbone=backbone,
                  generator=torch.Generator().manual_seed(0))
    if weights_path:
        load_torch_lpips(model, torch.load(weights_path, map_location="cpu",
                                           weights_only=True))
    return abs_lin_heads(model).requires_grad_(False).eval().to(device)


# torchvision ``features`` indices of the tapped convs per backbone.
_TORCH_CONV_IDX = {
    "alex": (("conv1", 0), ("conv2", 3), ("conv3", 6), ("conv4", 8),
             ("conv5", 10)),
    "vgg": (("conv1_1", 0), ("conv1_2", 2), ("conv2_1", 5), ("conv2_2", 7),
            ("conv3_1", 10), ("conv3_2", 12), ("conv3_3", 14),
            ("conv4_1", 17), ("conv4_2", 19), ("conv4_3", 21),
            ("conv5_1", 24), ("conv5_2", 26), ("conv5_3", 28)),
}


def _find_by_suffix(state_dict: Mapping, suffix: str) -> torch.Tensor:
    """The first tensor whose key ends with ``suffix``: the lpips package's
    ``net.slice{n}.{idx}...`` and torchvision's ``net.features.{idx}...``
    both keep the module index."""
    for k in state_dict:
        if k.endswith(suffix):
            return torch.as_tensor(state_dict[k])
    raise KeyError(f"no state_dict key ends with {suffix!r}")


def load_torch_lpips(module: LPIPS, state_dict: Mapping) -> LPIPS:
    """Copy a torch ``lpips.LPIPS(net=alex|vgg|squeeze)`` state_dict (the
    backbone and the linear heads) into ``module``."""

    def set_conv(conv, base):
        conv.weight.copy_(_find_by_suffix(state_dict, f"{base}.weight"))
        conv.bias.copy_(_find_by_suffix(state_dict, f"{base}.bias"))

    net = module.backbone
    with torch.no_grad():
        if module.backbone_name == "squeeze":
            set_conv(net.conv1, ".0")
            for idx, _, _ in _SQUEEZE_FIRES:
                fire = getattr(net, f"fire_{idx}")
                for sub in ("squeeze", "expand1x1", "expand3x3"):
                    set_conv(getattr(fire, sub), f".{idx}.{sub}")
        else:
            for name, idx in _TORCH_CONV_IDX[module.backbone_name]:
                set_conv(getattr(net, name), f".{idx}")
        for i, tap in enumerate(module.tap_channels):
            getattr(module, f"lin_{tap}").weight.copy_(
                torch.as_tensor(state_dict[f"lins.{i}.model.1.weight"]))
    return module
