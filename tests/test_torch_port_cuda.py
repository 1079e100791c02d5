"""The port's CUDA kernels against their plain PyTorch versions on the card.

Marked ``cuda``: they skip where no CUDA device is present (the fixture
decides at run time) and run on an H100 with
``python -m pytest tests/test_torch_port_cuda.py -q``. Each builds its
kernel from ``csrc/`` with nvcc at first use.
"""

import numpy as np
import pytest
import torch

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("depth,width,S,N", [(4, 256, 64, 37), (8, 256, 128, 20),
                                             (8, 128, 128, 9), (4, 128, 16, 50),
                                             (2, 128, 3, 70)])
def test_fused_fwd_kernel_matches_plain(cuda, depth, width, S, N, dtype):
    from depth_lidar_nerf_tpu_torch.models.nerf_mlp import NeRFMLP
    from depth_lidar_nerf_tpu_torch.ops import fused_mlp_t as f

    g = torch.Generator().manual_seed(depth * 100 + S)
    m = NeRFMLP(depth=depth, width=width, generator=g).to(cuda)
    params = {k: v.detach() for k, v in m.named_parameters()}
    rng = np.random.default_rng(S)
    pts = torch.from_numpy(rng.uniform(-1, 1, (3, N * S)).astype(np.float32)).to(cuda)
    vd = torch.nn.functional.normalize(
        torch.from_numpy(rng.normal(size=(N, 3)).astype(np.float32)), dim=-1).T.to(cuda)
    kw = dict(depth=depth, width=width, multires=10, multires_views=4,
              dtype=dtype, skips=(4,))
    n0 = f.fused_nerf_fwd.launches
    got = f.fused_nerf_fwd(params, pts, vd, S, **kw)
    torch.cuda.synchronize()
    assert f.fused_nerf_fwd.launches == n0 + 1
    ref = f.fused_nerf_fwd_plain(params, pts, vd, S, **kw)
    scale = ref.abs().max().item()
    tol = 1e-4 * scale if dtype == torch.float32 else 2e-2 * scale
    assert (got - ref).abs().max().item() <= tol


@pytest.mark.parametrize("N,B,V", [(33088, 63, 64), (5, 17, 100), (1000, 2, 7)])
def test_inverse_cdf_kernel_matches_plain(cuda, N, B, V):
    from depth_lidar_nerf_tpu_torch.ops import sampling_cuda as s

    g = torch.Generator(device=cuda).manual_seed(N)
    bins = torch.sort(torch.rand((N, B), device=cuda, generator=g), -1).values
    w = torch.rand((N, B - 1), device=cuda, generator=g) ** 4
    w[0] = 0.0
    u = torch.rand((N, V), device=cuda, generator=g)
    n0 = s.inverse_cdf.launches
    got = s.inverse_cdf(bins, w, u)
    torch.cuda.synchronize()
    assert s.inverse_cdf.launches == n0 + 1
    ref = s.inverse_cdf_plain(bins, w, u)
    # Same float32 operations in the same order: equal to the last bit.
    assert (got - ref).abs().max().item() <= 1e-6


@pytest.mark.parametrize("flag", [False, True])
def test_render_on_card_always_runs_both_kernels(cuda, flag):
    """On the card the renderer takes both kernels whatever
    ``use_fused_mlp`` and ``use_pallas_sampling`` say."""
    from depth_lidar_nerf_tpu_torch.ops import fused_mlp_t as f
    from depth_lidar_nerf_tpu_torch.ops import sampling_cuda as s
    from depth_lidar_nerf_tpu_torch.ops.rays import camera_rays
    from depth_lidar_nerf_tpu_torch.render.renderer import (make_rays,
                                                            render_rays)
    from depth_lidar_nerf_tpu_torch.train.config import (TrainConfig,
                                                         render_config_from)
    from depth_lidar_nerf_tpu_torch.train.state import build_models

    cfg = TrainConfig(netdepth=4, netdepth_fine=8, netwidth=128,
                      netwidth_fine=128, N_samples=32, N_importance=32,
                      use_viewdirs=True, dataset_type="llff",
                      use_fused_mlp=flag, use_pallas_sampling=flag)
    rcfg = render_config_from(cfg, 0, 0.0, 1.0).eval_mode()
    ms = build_models(cfg, rcfg, device=cuda)
    ro, rd = camera_rays(6, 10, 8.0, torch.eye(4, device=cuda)[:3])
    n0 = (f.fused_nerf_fwd.launches, s.inverse_cdf.launches)
    with torch.no_grad():
        out = render_rays(ms.coarse, ms.fine,
                          make_rays(ro, rd, rcfg, 6, 10, 8.0), rcfg)
    torch.cuda.synchronize()
    assert (f.fused_nerf_fwd.launches - n0[0],
            s.inverse_cdf.launches - n0[1]) == (2, 1)
    assert torch.isfinite(out["rgb_map"]).all()
