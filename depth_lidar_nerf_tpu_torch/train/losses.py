"""The loss terms of the base training step (port of part of ``train/losses.py``).

Parity targets (the reference train loop):

- RGB MSE and PSNR: ``run_nerf_helpers.py:19-21``;
- LiDAR depth loss variants (weighted / normalized / relative / plain):
  ``run_nerf.py:1503-1524``;
- depth-importance decay ``0.1^(step / (lrate_decay * 1000))``:
  ``run_nerf.py:1531-1536``;
- semantic cross-entropy on the ray-summed logits (``F.cross_entropy``, as
  the JAX ``semantic_cross_entropy``);
- the DS-NeRF sigma loss's per-ray term (``loss.py:15-44``);
- the image-aware inverse-depth smoothness of a rendered patch
  (``loss.py:55-133``);
- the VGG feature distance (``run_nerf.py:1692-1700``);
- SSIM, the train-time metric (``loss.py:143-212``);
- the GAN criterion, plain MSE (``run_nerf.py:1263``), and the decaying
  input-noise std of the discriminator (``run_nerf.py:1860-1862``).

Images are NHWC, as in the JAX package.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F


def img2mse(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    return torch.mean((x - y) ** 2)


def mse2psnr(mse: torch.Tensor) -> torch.Tensor:
    return -10.0 * torch.log(mse) / math.log(10.0)


def to8b(x: np.ndarray) -> np.ndarray:
    return (255 * np.clip(x, 0, 1)).astype(np.uint8)


def depth_importance(step, lrate_decay: int) -> float:
    """Exponential decay multiplier on the depth-supervision terms."""
    return 0.1 ** (step / (lrate_decay * 1000.0))


def depth_loss(rendered: torch.Tensor, target: torch.Tensor,
               weights: torch.Tensor | None = None, *, weighted: bool = False,
               normalize: bool = False, relative: bool = False) -> torch.Tensor:
    """Depth supervision on the rendered expected depth of the depth rays."""
    if weighted:
        if normalize:
            err = ((rendered - target) / torch.max(target)) ** 2
        else:
            err = (rendered - target) ** 2
        return torch.mean(err * weights)
    if relative:
        return torch.mean(((rendered - target) / (target + 1e-16)) ** 2)
    return img2mse(rendered, target)


def sigma_loss_from_sigma(sigma: torch.Tensor) -> torch.Tensor:
    """DS-NeRF's KL surrogate (JAX ``sigma_loss_from_sigma``) for post-ReLU
    ``sigma [N_rays, N_samples]`` sampled on ``[near, gt_depth]``, the last
    sample at the LiDAR depth: per ray ``-exp(s_last) / (sum exp(s) + 1)``
    (``loss.py:43``), evaluated with a row-max shift so that a large sigma
    cannot overflow ``exp``."""
    m = sigma.amax(1, keepdim=True)
    num = torch.exp(sigma[:, -1] - m[:, 0])
    den = torch.exp(sigma - m).sum(1) + torch.exp(-m[:, 0])
    return -num / den


def semantic_cross_entropy(logits: torch.Tensor,
                           labels: torch.Tensor) -> torch.Tensor:
    """Mean over rays of ``-log_softmax(logits)`` at the integer label."""
    logp = torch.log_softmax(logits.float(), dim=-1)
    return -torch.mean(torch.gather(logp, -1, labels.long()[..., None]))


# --------------------------------------------------------------- smoothness

def _grad_x(img: torch.Tensor) -> torch.Tensor:  # [B, H, W, C]
    return img[:, :, :-1, :] - img[:, :, 1:, :]


def _grad_y(img: torch.Tensor) -> torch.Tensor:
    return img[:, :-1, :, :] - img[:, 1:, :, :]


def inverse_depth_smoothness_loss(depth: torch.Tensor,
                                  image: torch.Tensor) -> torch.Tensor:
    """Image-aware smoothness of a rendered patch: ``depth [B, H, W, 1]``,
    ``image [B, H, W, 3]``; ``|dx d| e^{-mean|dx I|} + |dy d| e^{-mean|dy
    I|}``, each averaged over the patch."""
    wx = torch.exp(-torch.mean(torch.abs(_grad_x(image)), -1, keepdim=True))
    wy = torch.exp(-torch.mean(torch.abs(_grad_y(image)), -1, keepdim=True))
    return (torch.mean(torch.abs(_grad_x(depth) * wx))
            + torch.mean(torch.abs(_grad_y(depth) * wy)))


# --------------------------------------------------------------------- SSIM

def _gaussian_window(window_size: int, sigma: float) -> np.ndarray:
    g = np.exp(-((np.arange(window_size) - window_size // 2) ** 2)
               / (2 * sigma**2))
    g = g / g.sum()
    return np.outer(g, g).astype(np.float32)


def ssim(img1: torch.Tensor, img2: torch.Tensor, window_size: int = 11,
         size_average: bool = True) -> torch.Tensor:
    """Gaussian-window SSIM of NHWC images (or one HWC pair): a grouped
    ``window_size``-square sigma-1.5 window with SAME padding, C1 = 0.01^2,
    C2 = 0.03^2. The mean, or with ``size_average=False`` one per image."""
    if img1.dim() == 3:
        img1, img2 = img1[None], img2[None]
    a, b = img1.permute(0, 3, 1, 2), img2.permute(0, 3, 1, 2)
    channels = a.shape[1]
    w = torch.from_numpy(_gaussian_window(window_size, 1.5)).to(a.device,
                                                                a.dtype)
    kernel = w.expand(channels, 1, window_size, window_size)

    def filt(x):
        return F.conv2d(x, kernel, padding=window_size // 2, groups=channels)

    mu1, mu2 = filt(a), filt(b)
    mu1_sq, mu2_sq, mu1_mu2 = mu1**2, mu2**2, mu1 * mu2
    sigma1_sq = filt(a * a) - mu1_sq
    sigma2_sq = filt(b * b) - mu2_sq
    sigma12 = filt(a * b) - mu1_mu2
    C1, C2 = 0.01**2, 0.03**2
    ssim_map = ((2 * mu1_mu2 + C1) * (2 * sigma12 + C2)) / (
        (mu1_sq + mu2_sq + C1) * (sigma1_sq + sigma2_sq + C2))
    if size_average:
        return torch.mean(ssim_map)
    return torch.mean(ssim_map, dim=(1, 2, 3))


# ---------------------------------------------------------------------- GAN

def gan_mse(pred: torch.Tensor, target_value: float) -> torch.Tensor:
    """The reference's adversarial criterion is plain MSE."""
    return torch.mean((pred - target_value) ** 2)


def gan_noise_std_at(step, start_std: float) -> torch.Tensor:
    """``start_std * 0.9 ** (step / 5000)``, the discriminator's input-noise
    std at a step count, as a float32 0-d tensor on the CPU, evaluated as
    JAX's jitted step evaluates it on the int32 count, so that the two agree
    bit for bit: XLA turns the division by the constant into a product with
    its float32 reciprocal, then takes ``pow`` and the product in float32.
    (Dividing instead rounds otherwise at about a quarter of the counts,
    123,457 among them.)"""
    f32 = torch.float32
    x = torch.tensor(float(step), dtype=f32) * (
        torch.tensor(1.0, dtype=f32) / torch.tensor(5000.0, dtype=f32))
    return (torch.tensor(start_std, dtype=f32)
            * torch.tensor(0.9, dtype=f32) ** x)


# --------------------------------------------------------------- VGG feature

def vgg_feature_distance(feats_a, feats_b, layer_names, layer_weights,
                         loss_type: str = "l2"):
    """Weighted per-layer L1 or L2 distance between two dicts of VGG taps."""
    total = 0.0
    for name, w in zip(layer_names, layer_weights):
        d = feats_a[name] - feats_b[name]
        if loss_type == "l1":
            total = total + torch.mean(torch.abs(d)) * w
        elif loss_type == "l2":
            total = total + torch.mean(d**2) * w
        else:
            raise ValueError(f"vgg_loss_type must be l1 or l2, got {loss_type}")
    return total
