"""Alpha compositing of raw MLP outputs into per-ray maps
(port of ``ops/compositing.py``).

Parity target: ``raw2outputs`` (``run_nerf_helpers.py:542-595``) with its
load-bearing quirks: the ``1e10`` last interval, intervals scaled by
``|rays_d|``, optional Gaussian sigma noise before the ReLU, the exclusive
cumprod of ``1 - alpha + 1e-10``, ``disp = 1 / max(1e-10, depth / acc)`` and
the UNWEIGHTED semantic sum. Accumulations run in float32.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from depth_lidar_nerf_tpu_torch.ops.sampling import base_generator, draw_rows


class RayOutputs(NamedTuple):
    rgb: torch.Tensor  # [N, 3]
    disp: torch.Tensor  # [N]
    acc: torch.Tensor  # [N]
    weights: torch.Tensor  # [N, S]
    depth: torch.Tensor  # [N]
    semantic: Optional[torch.Tensor]  # [N, C] or None


def composit_dists(z_vals: torch.Tensor, rays_d: torch.Tensor) -> torch.Tensor:
    """Per-sample distance terms ``dists * |rays_d|`` ``[N, S]``."""
    z_vals = z_vals.float()
    dists = z_vals[..., 1:] - z_vals[..., :-1]
    dists = torch.cat([dists, torch.full_like(dists[..., :1], 1e10)], dim=-1)
    return dists * torch.linalg.norm(rays_d.float(), dim=-1, keepdim=True)


def _sigma_noise(sigma, raw_noise_std, generator, noise):
    if noise is not None:
        return sigma + noise.float()
    if raw_noise_std > 0.0:
        if base_generator(generator) is None:
            raise ValueError("raw_noise_std > 0 requires a generator")
        return sigma + draw_rows(sigma.shape, generator, normal=True,
                                 dtype=sigma.dtype,
                                 device=sigma.device) * raw_noise_std
    return sigma


def _weights(sigma, dists, cull_eps):
    alpha = 1.0 - torch.exp(-torch.relu(sigma) * dists)
    trans = torch.cumprod(
        torch.cat([torch.ones_like(alpha[..., :1]), 1.0 - alpha + 1e-10],
                  dim=-1), dim=-1)[..., :-1]
    weights = alpha * trans
    if cull_eps > 0.0:
        # Exact-zero weights (and cotangents) for occluded samples.
        weights = torch.where(trans >= cull_eps, weights,
                              torch.zeros_like(weights))
    return weights


def _maps(weights, rgb_map, z_vals, white_bkgd):
    depth_map = (weights * z_vals).sum(-1)
    acc_map = weights.sum(-1)
    disp_map = 1.0 / torch.clamp(depth_map / acc_map, min=1e-10)
    if white_bkgd:
        rgb_map = rgb_map + (1.0 - acc_map[..., None])
    return rgb_map, disp_map, acc_map, depth_map


def raw2outputs(raw: torch.Tensor, z_vals: torch.Tensor, rays_d: torch.Tensor,
                *, raw_noise_std: float = 0.0, white_bkgd: bool = False,
                generator: torch.Generator | None = None,
                num_semantic_classes: int = 0,
                cull_eps: float = 0.0) -> RayOutputs:
    """Composite ``raw [N, S, 4 + C]`` along ``z_vals [N, S]``."""
    raw = raw.float()
    z_vals = z_vals.float()
    dists = composit_dists(z_vals, rays_d)
    rgb = torch.sigmoid(raw[..., :3])  # [N, S, 3]
    sigma = _sigma_noise(raw[..., 3], raw_noise_std, generator, None)
    weights = _weights(sigma, dists, cull_eps)
    rgb_map = (weights[..., None] * rgb).sum(-2)
    rgb_map, disp_map, acc_map, depth_map = _maps(weights, rgb_map, z_vals,
                                                  white_bkgd)
    semantic = None
    if num_semantic_classes > 0:
        semantic = raw[..., 4:4 + num_semantic_classes].sum(-2)
    return RayOutputs(rgb_map, disp_map, acc_map, weights, depth_map, semantic)


def raw2outputs_t(raw_t: torch.Tensor, z_vals: torch.Tensor,
                  rays_d: torch.Tensor, *, raw_noise_std: float = 0.0,
                  white_bkgd: bool = False,
                  generator: torch.Generator | None = None,
                  cull_eps: float = 0.0,
                  noise: torch.Tensor | None = None) -> RayOutputs:
    """Channel-major compositing of the fused kernel's ``raw_t [4, N, S]``
    (rgb 0:3, sigma 3); mathematically identical to :func:`raw2outputs`.

    ``noise`` optionally supplies the pre-scaled additive sigma noise.
    """
    raw_t = raw_t.float()
    z_vals = z_vals.float()
    dists = composit_dists(z_vals, rays_d)
    rgb = torch.sigmoid(raw_t[:3])  # [3, N, S]
    sigma = _sigma_noise(raw_t[3], raw_noise_std, generator, noise)
    weights = _weights(sigma, dists, cull_eps)
    rgb_map = (weights[None] * rgb).sum(-1).T  # [N, 3]
    rgb_map, disp_map, acc_map, depth_map = _maps(weights, rgb_map, z_vals,
                                                  white_bkgd)
    return RayOutputs(rgb_map, disp_map, acc_map, weights, depth_map, None)
