"""The serving slice: port ``render_image`` (8 x 12, inverse-CDF sampling
on the kernel's path) against JAX ``render_image`` on converted weights."""

import numpy as np
import torch

from torch_port_helpers import assert_render_close, look_at_pose, render_pair


def test_render_image_matches_jax(monkeypatch):
    import jax.numpy as jnp

    from depth_lidar_nerf_tpu.render.renderer import render_image as jimage
    from depth_lidar_nerf_tpu_torch.render.renderer import render_image

    jm, params, jr, tm, tr = render_pair(monkeypatch, True)
    H, W, focal = 8, 12, 10.0
    c2w = look_at_pose(5)
    ref = jimage(jm.coarse, jm.fine, params, H, W, focal, jnp.asarray(c2w),
                 jr)
    got = render_image(tm.coarse, tm.fine, H, W, focal, c2w, tr,
                       device="cpu")
    assert got["rgb_map"].shape == (H, W, 3)
    assert np.isfinite(got["rgb_map"].numpy()).all()
    assert_render_close(ref, got, ("rgb_map", "acc_map", "depth_map",
                                   "weights", "disp_map"))
    # A ragged last tile gives the same per-ray results.
    tiled = render_image(tm.coarse, tm.fine, H, W, focal, c2w, tr, tile=40,
                         device="cpu")
    for k in got:
        torch.testing.assert_close(tiled[k], got[k], rtol=0, atol=1e-6)
