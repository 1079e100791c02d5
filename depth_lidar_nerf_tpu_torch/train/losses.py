"""The loss terms of the base training step (port of part of ``train/losses.py``).

Parity targets (the reference train loop):

- RGB MSE and PSNR: ``run_nerf_helpers.py:19-21``;
- LiDAR depth loss variants (weighted / normalized / relative / plain):
  ``run_nerf.py:1503-1524``;
- depth-importance decay ``0.1^(step / (lrate_decay * 1000))``:
  ``run_nerf.py:1531-1536``;
- semantic cross-entropy on the ray-summed logits (``F.cross_entropy``, as
  the JAX ``semantic_cross_entropy``);
- the DS-NeRF sigma loss's per-ray term (``loss.py:15-44``).

The smoothness, VGG, GAN and SSIM terms come with the slices that port
their step variants.
"""

from __future__ import annotations

import math

import numpy as np
import torch


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
