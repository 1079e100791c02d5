"""The port's optimizer and train state against optax, the packed-weights
refresh after an optimizer step, and the step's refusal of variants it does
not run."""

import numpy as np
import pytest
import torch


def test_adam_and_schedule_match_optax():
    """Three steps of the port's Adam + LR schedule against the JAX
    package's ``make_optimizer`` (optax) on the same gradients, float32."""
    import jax.numpy as jnp
    import optax

    from depth_lidar_nerf_tpu.train.config import TrainConfig as JC
    from depth_lidar_nerf_tpu.train.state import make_optimizer as jopt
    from depth_lidar_nerf_tpu_torch.train.config import TrainConfig
    from depth_lidar_nerf_tpu_torch.train.state import make_optimizer

    rng = np.random.default_rng(0)
    p0 = rng.normal(size=(5, 7)).astype(np.float32)
    grads = rng.normal(size=(3, 5, 7)).astype(np.float32) * \
        np.logspace(-6, 0, 7, dtype=np.float32)
    kw = dict(lrate=5e-3, lrate_decay=1)  # a fast decay, so it shows
    tx = jopt(JC(**kw))
    jp, st = jnp.asarray(p0), None
    st = tx.init(jp)
    p = torch.nn.Parameter(torch.from_numpy(p0.copy()))
    opt = make_optimizer(TrainConfig(**kw), [p])
    for g in grads:
        upd, st = tx.update(jnp.asarray(g), st, jp)
        jp = optax.apply_updates(jp, upd)
        p.grad = torch.from_numpy(g.copy())
        opt.step()
        np.testing.assert_array_equal(p.detach().numpy(), np.asarray(jp))
    np.testing.assert_array_equal(opt.state[p]["exp_avg"].numpy(),
                                  np.asarray(st[0].mu))
    np.testing.assert_array_equal(opt.state[p]["exp_avg_sq"].numpy(),
                                  np.asarray(st[0].nu))


def test_packed_weights_follow_an_optimizer_step():
    """After a training step's Adam update, the next pass packs the new
    weights (the kernels never see last step's copy)."""
    from depth_lidar_nerf_tpu_torch.data.synthetic import draw_scene
    from depth_lidar_nerf_tpu_torch.train.config import (TrainConfig,
                                                         render_config_from)
    from depth_lidar_nerf_tpu_torch.train.state import (build_models,
                                                        init_train_state)
    from depth_lidar_nerf_tpu_torch.train.step import make_train_step
    from depth_lidar_nerf_tpu_torch.train.tables import build_rgb_table

    sc = draw_scene(n_images=1, H=6, W=8, focal=6.0, n_depth_points=5)
    cfg = TrainConfig(dataset_type="llff", N_rand=8, N_samples=16,
                      N_importance=16, netdepth=2, netwidth=128,
                      netdepth_fine=2, netwidth_fine=128, use_viewdirs=True,
                      no_ndc=True, perturb=0.0)
    rcfg = render_config_from(cfg, 0, sc.near, sc.far)
    cpu = torch.device("cpu")
    models = build_models(cfg, rcfg, device=cpu)
    state = init_train_state(cfg, models)
    table = build_rgb_table(sc.images, sc.poses, [0], *sc.hwf, rcfg,
                            device=cpu)
    before = models.coarse.packed(cpu)
    make_train_step(cfg, rcfg, models, sc.hwf)(state, table, None)
    after = models.coarse.packed(cpu)
    assert after is not before
    n0 = models.coarse.trunk_0.weight.numel()
    torch.testing.assert_close(
        after.weights[:n0], models.coarse.trunk_0.weight.detach().t().reshape(-1))
    assert not torch.equal(after.weights[:n0], before.weights[:n0])


@pytest.mark.parametrize("flag", ["depth_inverse_loss", "gan_loss",
                                  "feature_loss", "grid_train", "no_batching"])
def test_step_refuses_unported_variants(flag):
    from depth_lidar_nerf_tpu_torch.train.config import (TrainConfig,
                                                         render_config_from)
    from depth_lidar_nerf_tpu_torch.train.state import build_models
    from depth_lidar_nerf_tpu_torch.train.step import make_train_step

    cfg = TrainConfig(netdepth=2, netwidth=32, netdepth_fine=2,
                      netwidth_fine=32, N_importance=4, use_viewdirs=True)
    rcfg = render_config_from(cfg, 0, 0.0, 1.0)
    models = build_models(cfg, rcfg, device="cpu")
    with pytest.raises(NotImplementedError, match=flag):
        make_train_step(cfg.replace(**{flag: True}), rcfg, models, (4, 4, 2.0))
