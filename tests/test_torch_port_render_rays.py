"""The serving slice: port ``render_rays`` against JAX ``render_rays`` with
both packages' ``build_models`` (JAX's fused kernels in the Pallas
interpreter), on the same rays and converted weights."""

import numpy as np
import pytest
import torch

from torch_port_helpers import assert_render_close, look_at_pose, render_pair

KEYS = ("rgb_map", "acc_map", "depth_map", "weights", "disp_map", "rgb0",
        "acc0", "depth_map0", "disp0", "z_std")


@pytest.mark.parametrize("use_pallas_sampling", [False, True])
def test_render_rays_matches_jax(monkeypatch, use_pallas_sampling):
    import jax.numpy as jnp

    from depth_lidar_nerf_tpu.ops.rays import camera_rays as jrays
    from depth_lidar_nerf_tpu.render.renderer import make_rays as jmake
    from depth_lidar_nerf_tpu.render.renderer import render_rays as jrender
    from depth_lidar_nerf_tpu_torch.ops.rays import camera_rays
    from depth_lidar_nerf_tpu_torch.render.renderer import (make_rays,
                                                            render_rays)

    jm, params, jr, tm, tr = render_pair(monkeypatch, use_pallas_sampling)
    H, W, focal = 4, 8, 6.0
    c2w = look_at_pose(3)
    ro, rd = jrays(H, W, focal, jnp.asarray(c2w))
    ref = jrender(jm.coarse, jm.fine, params, jmake(ro, rd, jr, H, W, focal),
                  jr)
    to, td = camera_rays(H, W, focal, torch.from_numpy(c2w))
    np.testing.assert_allclose(td.numpy(), np.asarray(rd), rtol=1e-6,
                               atol=1e-7)
    with torch.no_grad():
        got = render_rays(tm.coarse, tm.fine, make_rays(to, td, tr, H, W,
                                                        focal), tr)
    assert set(ref) == set(got)
    assert np.asarray(ref["acc_map"]).max() > 0.1  # the field is not empty
    assert_render_close(ref, got, KEYS)
