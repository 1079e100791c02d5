"""The port's driver with the GAN loss on the CPU: ``train()`` on JAX's
end-to-end GAN schedule (``tests/test_train_e2e.py:180-190``), the
discriminator and its Adam in the checkpoint, a resumed GAN run against an
uninterrupted one bit for bit, checkpoints with and without a
discriminator refused across runs as JAX's orbax restore refuses them, and
``--ft_path`` of a reference ``.tar`` that carries a discriminator and its
moments."""

import numpy as np
import pytest
import torch

from test_torch_port_driver import (_assert_same_state, _cfg, _fields,
                                    _jax_state, _train)

_GAN = dict(feature_loss=True, feature_start_iteration=1,
            feature_loss_every_n=5, vgg_layers=["conv1_2"],
            vgg_layer_weights=[1.0], vgg_loss_type="l1",
            gan_loss=True, gan_start_iteration=6,
            depth_inverse_loss=True, depth_inverse_loss_every_n=5,
            nH=12, nW=16, gradH=4, gradW=4)


@pytest.fixture(scope="module")
def scene_dir(tmp_path_factory):
    from depth_lidar_nerf_tpu_torch.data.synthetic import make_scene

    d = tmp_path_factory.mktemp("scene")
    make_scene(str(d), n_images=3, H=24, W=32, focal=30.0, n_depth_points=120)
    return str(d)


@pytest.fixture(autouse=True)
def _in_tmp(tmp_path, monkeypatch):
    """As ``test_torch_port_driver.py``: the summary writer's ``runs/``
    under ``tmp_path``, one intra-op thread."""
    monkeypatch.chdir(tmp_path)
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _disc(state):
    """The discriminator's tensors and Adam moments by name."""
    disc, opt = state.models.discriminator, state.disc_optimizer
    out = {f"w.{k}": v.detach().clone() for k, v in disc.state_dict().items()}
    for k, p in disc.named_parameters():
        for which, v in opt.state[p].items():
            out[f"{which}.{k}"] = v.clone()
    return out


def test_gan_trains_on_jax_schedule(scene_dir, tmp_path):
    """JAX's ``test_patch_losses_train`` (feature + smoothness every 5th
    iteration, the GAN from iteration 6): 12 iterations reach ``N_iters``;
    ``gan_loss`` and ``loss_dis`` appear from iteration 6 on, at every
    iteration, where JAX's ``variant_key`` puts the GAN, and the
    discriminator moved."""
    from depth_lidar_nerf_tpu.train import config as jcfg
    from depth_lidar_nerf_tpu.train.step import build_step_fns

    seen = {}
    cfg = _cfg(scene_dir, tmp_path, N_iters=12, i_weights=12, i_print=1,
               **_GAN)
    state = _train(cfg, metrics_hook=lambda i, m: seen.setdefault(i, m))
    assert state.step == 12 and sorted(seen) == list(range(1, 13))
    jc = jcfg.TrainConfig(**_fields(scene_dir, tmp_path, N_iters=12, **_GAN))
    plan = build_step_fns(jc, jcfg.render_config_from(jc, 0, 0.0, 1.0), None,
                          (24, 32, 30.0))
    for i, m in seen.items():
        gan = plan.variant_key(i)[1]
        assert ("gan_loss" in m) == gan and ("loss_dis" in m) == gan, i
        assert all(np.isfinite(v) for v in m.values()), (i, m)
    assert [i for i, m in seen.items() if "gan_loss" in m] == list(range(6, 13))
    assert state.disc_optimizer.count == 7


def test_gan_resume_equals_uninterrupted_run(scene_dir, tmp_path, capsys):
    """A GAN run to 8, resumed to 12, equals an uninterrupted 12-iteration
    run bit for bit: the MLPs, their moments, and the discriminator with its
    moments and count, which the checkpoint carries."""
    from depth_lidar_nerf_tpu_torch.train import checkpoint

    kw = dict(_GAN, raw_noise_std=1.0, i_print=4, gan_noise_std=0.1)
    cfg = _cfg(scene_dir, tmp_path / "a", N_iters=8, i_weights=8, **kw)
    _train(cfg)
    ck = checkpoint.load_file(checkpoint.path_of(
        checkpoint.ckpt_dir(cfg.basedir, cfg.expname), 8))
    assert ck["discriminator"] and ck["disc_optimizer_count"] == 3
    assert set(ck["discriminator"]) == {
        "classifier.0.weight", "classifier.0.bias"} | {
        f"model.{i}.{k}" for i in (0, 2, 4, 6) for k in ("weight", "bias")}
    resumed = _train(cfg.replace(N_iters=12))
    assert "resumed from checkpoint at step 8" in capsys.readouterr().out
    whole = _train(_cfg(scene_dir, tmp_path / "b", N_iters=12, i_weights=12,
                        **kw))
    _assert_same_state(resumed, whole)
    a, b = _disc(resumed), _disc(whole)
    assert a.keys() == b.keys() and len(a) == 30
    for k in a:
        assert torch.equal(a[k], b[k]), k
    assert resumed.disc_optimizer.count == whole.disc_optimizer.count == 7


def test_checkpoints_with_and_without_a_discriminator_are_refused(
        scene_dir, tmp_path):
    """A GAN run does not resume a checkpoint without a discriminator, nor a
    run without the GAN one with it (JAX's orbax restore refuses both trees);
    a checkpoint without the GAN still resumes a run without it."""
    base = _cfg(scene_dir, tmp_path / "a", N_iters=2, i_weights=2)
    _train(base)
    with pytest.raises(ValueError, match="discriminator is present in only"):
        _train(base.replace(N_iters=4, **_GAN))
    assert _train(base.replace(N_iters=3)).step == 3
    gan = _cfg(scene_dir, tmp_path / "b", N_iters=7, i_weights=7, **_GAN)
    _train(gan)
    with pytest.raises(ValueError, match="discriminator is present in only"):
        _train(gan.replace(N_iters=8, gan_loss=False))


def test_ft_path_reference_tar_with_a_discriminator(scene_dir, tmp_path,
                                                     capsys):
    """``--ft_path`` of a reference ``.tar`` (JAX's export, plus the
    reference's ``discriminator_state_dict`` and
    ``discriminator_optimizer_dict`` at the run's crop): the port imports
    the discriminator and its moments at the global step and trains on;
    with ``--no_reload_optimizer`` the moments stay fresh."""
    from depth_lidar_nerf_tpu.train.config import TrainConfig as JCfg
    from depth_lidar_nerf_tpu.train.torch_import import \
        export_reference_checkpoint
    from test_torch_port_gan import _reference_disc

    js = _jax_state(JCfg(**_fields(scene_dir, tmp_path)), step=6)
    tar = export_reference_checkpoint(js, str(tmp_path / "ref.tar"),
                                      verbose=False)
    ckpt = torch.load(tar, weights_only=True)
    td, opt = _reference_disc((12, 16), 5)
    ckpt["discriminator_state_dict"] = td.state_dict()
    ckpt["discriminator_optimizer_dict"] = opt.state_dict()
    torch.save(ckpt, tar)
    cfg = _cfg(scene_dir, tmp_path, ft_path=tar, N_iters=8, i_weights=0,
               **_GAN)
    state = _train(cfg)
    out = capsys.readouterr().out
    assert "(step 6; disc_opt_state, disc_params, params)" in out
    assert state.step == 8 and state.disc_optimizer.count == 6 + 2
    moved = [not torch.equal(p.detach(), td.state_dict()[k])
             for k, p in state.models.discriminator.named_parameters()]
    assert all(moved)
    state = _train(cfg.replace(no_reload_optimizer=True, expname="fresh"))
    out = capsys.readouterr().out
    assert "(step 6; disc_params, params)" in out
    assert state.disc_optimizer.count == 2
