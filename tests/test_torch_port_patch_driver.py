"""The port's driver with the patch losses on the CPU, against JAX's driver
where both can run: ``train()`` with JAX's end-to-end patch config
(``tests/test_train_e2e.py:180-190``, without the GAN) and its schedule, the
oversized patch, the held-out ``[TEST]`` line's LPIPS (against JAX's
``_test_lpips`` on one weight file), the ``eval_metrics`` CLI against JAX's,
and the GAN and single-image batching through the driver with the patch
losses."""

import os

import numpy as np
import pytest
import torch

from test_torch_port_driver import _cfg, _fields, _train


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


_PATCH = dict(feature_loss=True, feature_start_iteration=1,
              feature_loss_every_n=5, vgg_layers=["conv1_2"],
              vgg_layer_weights=[1.0], vgg_loss_type="l1",
              depth_inverse_loss=True, depth_inverse_loss_every_n=5,
              nH=12, nW=16, gradH=4, gradW=4)


def test_patch_losses_train_on_jax_schedule(scene_dir, tmp_path):
    """JAX's ``test_patch_losses_train`` without the GAN: 12 iterations
    reach ``N_iters``; the patch terms appear at the iterations JAX's
    ``variant_key`` picks (5 and 10) and at no other, with a finite total."""
    from depth_lidar_nerf_tpu.train import config as jcfg
    from depth_lidar_nerf_tpu.train.step import build_step_fns

    seen = {}
    cfg = _cfg(scene_dir, tmp_path, N_iters=12, i_weights=12, i_print=1,
               **_PATCH)
    state = _train(cfg, metrics_hook=lambda i, m: seen.setdefault(i, m))
    assert state.step == 12 and sorted(seen) == list(range(1, 13))
    jc = jcfg.TrainConfig(**_fields(scene_dir, tmp_path, N_iters=12,
                                    **_PATCH))
    plan = build_step_fns(jc, jcfg.render_config_from(jc, 0, 0.0, 1.0), None,
                          (24, 32, 30.0))
    for i, m in seen.items():
        f, _, s, _, _ = plan.variant_key(i)
        assert ("feature_loss" in m) == f and ("inv_loss" in m) == s, i
        assert np.isfinite(m["loss"])
    assert [i for i, m in seen.items() if "feature_loss" in m] == [5, 10]


def test_grid_patch_losses_train(scene_dir, tmp_path):
    """Grid training with the patch losses (JAX
    ``test_grid_train_with_patch_losses``), with ``patch_ng_int8`` and
    ``patch_render_samples``: grid patch iterations at 5 and 10, without
    the coarse terms; the run ends at ``N_iters``."""
    seen = {}
    cfg = _cfg(scene_dir, tmp_path, N_iters=10, i_weights=10, i_print=5,
               grid_train=True, grid_train_after=4, grid_rebake_every=5,
               grid_train_res=8, grid_train_fine_only=True,
               patch_render_samples=8, patch_ng_int8=True, **_PATCH)
    state = _train(cfg, metrics_hook=lambda i, m: seen.setdefault(i, m))
    assert state.step == 10
    assert {"feature_loss", "inv_loss"} <= set(seen[5])
    assert "feature_loss0" not in seen[5] and "img_loss0" not in seen[5]


def test_oversized_patch_refused_as_jax(scene_dir, tmp_path):
    """JAX's ``test_oversized_patch_rejected_at_build``: the same error."""
    from depth_lidar_nerf_tpu.train.config import TrainConfig as JCfg
    from depth_lidar_nerf_tpu.train.loop import train as jtrain

    kw = dict(_PATCH, nH=64, N_iters=10)  # nH = 64 > H = 24
    with pytest.raises(ValueError, match="larger than image") as ref:
        jtrain(JCfg(**_fields(scene_dir, tmp_path / "j", **kw)))
    with pytest.raises(ValueError, match="larger than image") as got:
        _train(_cfg(scene_dir, tmp_path, **kw))
    assert str(got.value) == str(ref.value)


def _write_lpips_weights(path, seed=0):
    """An ``lpips`` package AlexNet state dict of the port's seed-``seed``
    weights (``net.slice{n}.{idx}`` and ``lins.{i}.model.1.weight``)."""
    from depth_lidar_nerf_tpu_torch.models import lpips as tlp

    m = tlp.LPIPS(generator=torch.Generator().manual_seed(seed))
    sd = m.state_dict()
    out = {}
    for name, idx in tlp._TORCH_CONV_IDX["alex"]:
        for p in ("weight", "bias"):
            out[f"net.slice1.{idx}.{p}"] = sd[f"backbone.{name}.{p}"]
    for i, tap in enumerate(m.tap_channels):
        out[f"lins.{i}.model.1.weight"] = sd[f"lin_{tap}.weight"].abs()
    torch.save(out, path)
    return path


def _test_line(out, i):
    line = [ln for ln in out.splitlines() if ln.startswith(f"[TEST] iter {i} ")]
    assert len(line) == 1, out
    return line[0]


def test_test_line_prints_lpips_as_jax(scene_dir, tmp_path_factory, tmp_path,
                                       capsys, monkeypatch):
    """The ``[TEST]`` line carries the held-out views' LPIPS; on one weight
    file (``$LPIPS_TORCH_WEIGHTS``) it equals JAX's ``_test_lpips`` of the
    frame the run wrote (printed to 4 decimals). Below 31 px a side AlexNet
    has no taps: the line goes without LPIPS, as JAX's."""
    from depth_lidar_nerf_tpu.train import loop as jloop
    from depth_lidar_nerf_tpu_torch.data.synthetic import make_scene
    from depth_lidar_nerf_tpu_torch.train.loop import load_scene

    big = str(tmp_path_factory.mktemp("scene_big"))
    make_scene(big, n_images=3, H=36, W=40, focal=36.0, n_depth_points=120)
    monkeypatch.setenv("LPIPS_TORCH_WEIGHTS", _write_lpips_weights(
        str(tmp_path / "lpips_alex.pth")))
    monkeypatch.setattr(jloop, "_LPIPS_CACHE", [])
    cfg = _cfg(big, tmp_path, N_iters=4, i_weights=0, i_print=4, i_testset=4)
    _train(cfg)
    line = _test_line(capsys.readouterr().out, 4)
    printed = float(line.split(" lpips ")[1])
    scene = load_scene(cfg)
    frame = np.load(os.path.join(str(tmp_path), "t", "testset_000004",
                                 "000.npz"))["rgb"]
    want = jloop._test_lpips([frame], scene.images[scene.i_test])
    assert want is not None and printed == pytest.approx(want, abs=6e-5)
    _train(_cfg(scene_dir, tmp_path, expname="small", N_iters=2,
                i_weights=0, i_print=2, i_testset=2))  # 24 x 32
    assert " lpips " not in _test_line(capsys.readouterr().out, 2)


def test_eval_metrics_matches_jax_cli(tmp_path, monkeypatch, capsys):
    """``evaluation/eval_metrics.py`` against JAX's CLI on the same PNG
    directories, one LPIPS weight file for both: PSNR and SSIM equal, LPIPS
    within float32 (rtol 1e-4); depth PNGs left out."""
    from depth_lidar_nerf_tpu.evaluation import eval_metrics as jem
    from depth_lidar_nerf_tpu_torch.evaluation import eval_metrics as tem
    from depth_lidar_nerf_tpu_torch.utils.images import write_png

    rng = np.random.default_rng(0)
    for d in ("gen", "gt"):
        os.makedirs(tmp_path / d)
    for i in range(2):
        gt = rng.integers(0, 256, (36, 40, 3), dtype=np.uint8)
        noisy = np.clip(gt + rng.integers(-20, 21, gt.shape), 0, 255)
        write_png(str(tmp_path / "gt" / f"{i:03d}.png"), gt)
        write_png(str(tmp_path / "gen" / f"{i:03d}.png"),
                  noisy.astype(np.uint8))
    write_png(str(tmp_path / "gen" / "000_depth.png"), gt)
    write_png(str(tmp_path / "gt" / "000_depth.png"), gt)
    w = _write_lpips_weights(str(tmp_path / "lp.pth"), seed=3)
    jrows, jsum = jem.evaluate_dirs(str(tmp_path / "gen"), str(tmp_path / "gt"),
                                    lpips_weights=w)
    trows, tsum = tem.evaluate_dirs(str(tmp_path / "gen"), str(tmp_path / "gt"),
                                    lpips_weights=w, device="cpu")
    assert [r["file"] for r in trows] == [r["file"] for r in jrows] == [
        "000.png", "001.png"]
    for a, b in zip(trows, jrows):
        assert a["psnr"] == pytest.approx(b["psnr"], rel=1e-12)
        assert a["ssim"] == pytest.approx(b["ssim"], rel=1e-12)
        assert a["lpips"] == pytest.approx(b["lpips"], rel=1e-4)
    assert set(tsum) == set(jsum) == {"psnr", "ssim", "lpips"}
    tem.main(["--generated_dir", str(tmp_path / "gen"), "--gt_dir",
              str(tmp_path / "gt"), "--no_lpips"])
    out = capsys.readouterr().out
    assert "mean psnr" in out and "lpips" not in out


@pytest.mark.parametrize("flag", [dict(gan_loss=True),
                                  dict(no_batching=True)])
def test_gan_and_no_batching_train(scene_dir, tmp_path, flag):
    """Each flag, once refused, now trains through the driver with the
    patch losses: 6 iterations reach ``N_iters`` with finite metrics; the
    GAN, from ``gan_start_iteration`` 1, makes every
    iteration a GAN patch iteration."""
    seen = {}
    state = _train(_cfg(scene_dir, tmp_path, N_iters=6, i_weights=6,
                        i_print=1, gan_start_iteration=1, **_PATCH, **flag),
                   metrics_hook=lambda i, m: seen.setdefault(i, m))
    assert state.step == 6 and sorted(seen) == list(range(1, 7))
    assert all(np.isfinite(v) for m in seen.values() for v in m.values())
    gan = "gan_loss" in flag
    assert all(("loss_dis" in m) == gan for m in seen.values())
    assert os.path.exists(os.path.join(str(tmp_path), "t", "checkpoints",
                                       "6.pt"))


def test_make_patch_batch_draws_as_jax(scene_dir, tmp_path):
    """``_make_patch_batch`` (the host-drawn crop) takes JAX's draws from
    one numpy generator: the same image, origin, permutation, ground truth
    and table position; an oversized patch is refused alike."""
    from depth_lidar_nerf_tpu.train.config import TrainConfig as JCfg
    from depth_lidar_nerf_tpu.train.loop import _make_patch_batch as jmake
    from depth_lidar_nerf_tpu.train.loop import load_scene as jload
    from depth_lidar_nerf_tpu_torch.train.loop import (_make_patch_batch,
                                                       load_scene)

    kw = dict(_PATCH, nH=9, nW=11)
    jc = JCfg(**_fields(scene_dir, tmp_path, **kw))
    tc = _cfg(scene_dir, tmp_path, **kw)
    js, ts = jload(jc), load_scene(tc)
    for seed in range(3):
        jp = jmake(jc, js, np.random.default_rng(seed))
        tp = _make_patch_batch(tc, ts, np.random.default_rng(seed),
                               device="cpu")
        for name in ("c2w", "gt_patch", "start_h", "start_w", "perm", "img"):
            np.testing.assert_array_equal(
                getattr(tp, name).numpy(),
                np.asarray(getattr(jp, name)).astype(
                    getattr(tp, name).numpy().dtype), err_msg=name)
    with pytest.raises(ValueError, match="larger than image"):
        _make_patch_batch(tc.replace(nW=33), ts, np.random.default_rng(0),
                          device="cpu")
