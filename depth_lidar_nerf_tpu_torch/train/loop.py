"""Render a pose list (port of ``render_path``, ``train/loop.py:168``).

The rest of the JAX training loop (data loading, checkpoints, the
``--render_only`` CLI, training) is not ported yet; image and video writing
comes with it.
"""

from __future__ import annotations

import numpy as np

from depth_lidar_nerf_tpu_torch.device import resolve_device
from depth_lidar_nerf_tpu_torch.render.renderer import RenderConfig, render_image
from depth_lidar_nerf_tpu_torch.train.state import Models


def render_path(models: Models, render_poses, hwf, cfg_render: RenderConfig,
                render_factor: int = 0, device=None):
    """Render every pose (``run_nerf.py:268-359``); returns numpy stacks
    ``rgbs [F, H, W, 3]`` and ``disps [F, H, W]``. ``cfg_render`` is the
    eval config, ``train.config.eval_render_config(cfg, rcfg)``, which
    carries the serving modes (int8, fine-only, coarse-downsampled)."""
    device = resolve_device(device)
    H, W, focal = hwf
    if render_factor:
        H, W, focal = H // render_factor, W // render_factor, focal / render_factor
    rgbs, disps = [], []
    for c2w in render_poses:
        out = render_image(models.coarse, models.fine, int(H), int(W), focal,
                           np.asarray(c2w)[:3, :4], cfg_render, device=device)
        rgbs.append(out["rgb_map"].float().cpu().numpy())
        disps.append(out["disp_map"].float().cpu().numpy())
    return np.stack(rgbs), np.stack(disps)
