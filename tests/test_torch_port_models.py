"""``NeRFMLP`` and ``params_from_jax`` against the Flax module, the port's
initialiser against Flax ``lecun_normal``, and ``supports_rays``."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from torch_port_helpers import flax_mlp_params


@pytest.mark.parametrize("depth,skips", [(4, (4,)), (8, (4,)), (3, (2,))])
def test_nerf_mlp_matches_flax(depth, skips):
    from depth_lidar_nerf_tpu_torch.models.nerf_mlp import NeRFMLP
    from depth_lidar_nerf_tpu_torch.weights import params_from_jax

    model, params = flax_mlp_params(depth, 64, seed=depth, skips=skips)
    rng = np.random.default_rng(depth)
    pe = rng.normal(size=(5, 7, 63)).astype(np.float32)
    ve = rng.normal(size=(5, 7, 27)).astype(np.float32)
    ref = np.asarray(model.apply(params, jnp.asarray(pe), jnp.asarray(ve)))
    tm = NeRFMLP(depth=depth, width=64, skips=skips)
    tm.load_state_dict(params_from_jax({"coarse": params})["coarse"])
    with torch.no_grad():
        got = tm(torch.from_numpy(pe), torch.from_numpy(ve)).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-5)


def test_init_matches_flax_lecun_normal():
    from depth_lidar_nerf_tpu_torch.models.nerf_mlp import NeRFMLP

    g = torch.Generator().manual_seed(0)
    tm = NeRFMLP(depth=2, width=256, generator=g)
    _, params = flax_mlp_params(2, 256)
    for name in ("trunk_1", "feature"):
        w = getattr(tm, name).weight.detach().numpy()
        k = params["params"][name]["kernel"]
        assert w.shape == k.T.shape
        np.testing.assert_allclose(w.std(), k.std(), rtol=0.03)
        bound = 2 * np.sqrt(1.0 / w.shape[1]) / 0.87962566103423978
        assert np.abs(w).max() <= bound + 1e-6
        assert not getattr(tm, name).bias.detach().any()
    same = NeRFMLP(depth=2, width=256,
                   generator=torch.Generator().manual_seed(0))
    assert torch.equal(same.trunk_0.weight, tm.trunk_0.weight)


def test_supports_rays_mirrors_jax():
    from depth_lidar_nerf_tpu.ops.fused_mlp_t import supports_rays as jsup
    from depth_lidar_nerf_tpu_torch.ops.fused_mlp_t import supports_rays
    from depth_lidar_nerf_tpu_torch.weights import mlp_state_dict

    for depth, width, skips in [(4, 128, (4,)), (8, 256, (4,)),
                                (8, 64, (4,)), (5, 128, (4,))]:
        _, p = flax_mlp_params(depth, width, skips=skips)
        sd = mlp_state_dict(p)
        for vd in (True, False):
            assert supports_rays(sd, vd, 0, depth, width, 10, 4, skips) == \
                jsup(p, vd, 0, depth, width, 10, 4, skips)
    assert not supports_rays(sd, True, 2, 5, 128, 10, 4, (4,))


def test_fused_mlp_packs_once_until_weights_change():
    from depth_lidar_nerf_tpu_torch.train.state import FusedMLP

    cpu = torch.device("cpu")
    m = FusedMLP(depth=4, width=64, dtype=torch.bfloat16,
                 generator=torch.Generator().manual_seed(0))
    p = m.packed(cpu)
    assert m.packed(cpu) is p
    assert p.dtype == torch.bfloat16 and p.weights.dtype == torch.bfloat16
    n0 = m.trunk_0.weight.numel()
    torch.testing.assert_close(
        p.weights[:n0].float(),
        m.trunk_0.weight.detach().t().bfloat16().float().reshape(-1))
    assert list(p.w_offsets)[:2] == [0, n0]
    with torch.no_grad():
        m.sigma.bias += 1.0  # an in-place update repacks
    q = m.packed(cpu)
    assert q is not p and q.biases[list(q.b_offsets)[4]].item() == 1.0
    m.load_state_dict(FusedMLP(depth=4, width=64).state_dict())
    r = m.packed(cpu)
    assert r is not q and not r.biases.any()


@pytest.mark.parametrize("use_fused_mlp", [False, True])
def test_build_models_honours_fused_flag_on_cpu(use_fused_mlp):
    from depth_lidar_nerf_tpu_torch.train.config import (TrainConfig,
                                                         render_config_from)
    from depth_lidar_nerf_tpu_torch.train.state import FusedMLP, build_models

    cfg = TrainConfig(netdepth=2, netwidth=32, netdepth_fine=2,
                      netwidth_fine=32, N_importance=8,
                      use_fused_mlp=use_fused_mlp, dataset_type="llff")
    ms = build_models(cfg, render_config_from(cfg, 0, 0.0, 1.0),
                      device="cpu")
    assert all(isinstance(m, FusedMLP) == use_fused_mlp for m in ms)
