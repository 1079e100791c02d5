"""The port's perceptual models and patch losses against the JAX package's:
VGG19 (every tap, outputs and input gradients), LPIPS with its three
backbones (spatial map on and off), both loaders reading ``.pth`` files that
the tests write in torchvision's and the lpips package's layouts, the
inverse-depth smoothness, SSIM and the VGG feature distance with gradients,
and an LPIPS patch step.

Weights are the Flax modules' initialisation, carried across with
``weights.conv_state_dict``. Tolerances: float32 outputs rtol 1e-4 (atol
1e-6 of values that are near zero), gradients rtol 1e-3; maps and taps are
compared relative to their largest magnitude, since a ReLU tap holds exact
zeros beside large values.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from depth_lidar_nerf_tpu.models import lpips as jlp
from depth_lidar_nerf_tpu.models import vgg as jvgg
from depth_lidar_nerf_tpu.train import losses as jloss
from depth_lidar_nerf_tpu_torch.models import lpips as tlp
from depth_lidar_nerf_tpu_torch.models import vgg as tvgg
from depth_lidar_nerf_tpu_torch.train import losses as tloss
from depth_lidar_nerf_tpu_torch.weights import conv_state_dict
from torch_port_patch_helpers import patch_pair, patch_step_against_jax


def _close(got, want, rtol=1e-4):
    """``|got - want| <= rtol * max|want|`` elementwise."""
    want = np.asarray(want)
    got = np.asarray(got)
    assert got.shape == want.shape, (got.shape, want.shape)
    err = np.abs(got - want).max() / (np.abs(want).max() + 1e-30)
    assert err <= rtol, err


def _np(tree):
    return jax.tree.map(np.asarray, tree)


@pytest.fixture(scope="module")
def vgg_pair():
    x = np.random.default_rng(0).uniform(size=(2, 40, 48, 3)).astype(np.float32)
    jm = jvgg.VGG19Features(taps=jvgg.VGG19_TAPS)
    jp = _np(jm.init(jax.random.key(0), jnp.asarray(x)))
    tm = tvgg.VGG19Features(taps=tvgg.VGG19_TAPS)
    tm.load_state_dict(conv_state_dict(jp))
    return jm, jp, tm, x


def test_vgg19_taps_and_input_gradients_match_jax(vgg_pair):
    jm, jp, tm, x = vgg_pair
    assert tvgg.VGG19_TAPS == jvgg.VGG19_TAPS
    rng = np.random.default_rng(1)
    jout = jm.apply(jp, jnp.asarray(x))
    cot = {k: rng.normal(size=v.shape).astype(np.float32)
           for k, v in jout.items()}

    def f(v):
        out = jm.apply(jp, v)
        return sum(jnp.sum(out[k] * cot[k]) for k in out)

    jgrad = np.asarray(jax.grad(f)(jnp.asarray(x)))
    xt = torch.from_numpy(x).requires_grad_()
    tout = tm(xt)
    assert list(tout) == list(jout) == list(jvgg.VGG19_TAPS)
    for k in jout:  # 94 x 352 would go 47x176, 23x88, 11x44, 5x22
        _close(tout[k].detach().numpy(), jout[k])
    sum((tout[k] * torch.from_numpy(cot[k])).sum() for k in tout).backward()
    _close(xt.grad.numpy(), jgrad, rtol=1e-3)
    # Truncated at the deepest tap, as JAX's: conv2_2's net has 4 convs.
    short = tvgg.VGG19Features(taps=("conv1_2", "conv2_2"))
    assert [n for n, _ in short.named_children()] == [
        "conv1_1", "conv1_2", "conv2_1", "conv2_2"]
    with pytest.raises(ValueError, match="unknown VGG19 taps"):
        tvgg.VGG19Features(taps=("conv6_1",))
    np.testing.assert_allclose(
        tvgg.vgg_normalize(torch.from_numpy(x)).numpy(),
        np.asarray(jvgg.vgg_normalize(jnp.asarray(x))), rtol=1e-6)


def _torchvision_vgg19(tree):
    """A torchvision ``vgg19().features`` state dict of the Flax weights."""
    sd = conv_state_dict(tree)
    idx = tvgg._torch_conv_indices()
    out = {}
    for name, i in zip(tvgg.VGG19_TAPS, idx):
        if f"{name}.weight" in sd:
            out[f"features.{i}.weight"] = sd[f"{name}.weight"]
            out[f"features.{i}.bias"] = sd[f"{name}.bias"]
    return out


def test_load_torch_vgg19_and_the_search_order(vgg_pair, tmp_path,
                                               monkeypatch):
    """A ``.pth`` in torchvision's layout loads into both packages alike;
    ``build_models`` finds it as JAX's ``init_vgg_params`` does:
    ``$VGG19_TORCH_WEIGHTS``, then ``<datadir>/vgg19.pth``, else the seed-0
    init; the weights are frozen and out of the optimizer."""
    from depth_lidar_nerf_tpu.train import config as jcfg
    from depth_lidar_nerf_tpu.train import state as jstate
    from depth_lidar_nerf_tpu_torch.train import config as tcfg
    from depth_lidar_nerf_tpu_torch.train import state as tstate

    jm, jp, _, x = vgg_pair
    torch.save(_torchvision_vgg19(jp), tmp_path / "vgg19.pth")
    fields = dict(feature_loss=True, vgg_layers=["conv1_2", "conv3_4"],
                  datadir=str(tmp_path), nH=16, nW=16, netwidth=128,
                  netwidth_fine=128, netdepth_fine=2)
    monkeypatch.delenv("VGG19_TORCH_WEIGHTS", raising=False)
    jc, tc = jcfg.TrainConfig(**fields), tcfg.TrainConfig(**fields)
    jr = jcfg.render_config_from(jc, 0, 0.0, 1.0)
    tr = tcfg.render_config_from(tc, 0, 0.0, 1.0)
    jmods = jstate.build_models(jc, jr)
    jparams = jstate.init_vgg_params(jc, jmods, jax.random.key(3))
    tm = tstate.build_models(tc, tr, device="cpu")
    want = jmods.vgg.apply(jparams, jnp.asarray(x))
    got = tm.vgg(torch.from_numpy(x))
    assert set(got) == {"conv1_2", "conv3_4"}
    for k in want:
        _close(got[k].numpy(), want[k])
    assert not any(p.requires_grad for p in tm.vgg.parameters())
    state = tstate.init_train_state(tc, tm)
    n_opt = sum(len(g["params"]) for g in state.optimizer.param_groups)
    assert n_opt == sum(len(list(m.parameters())) for m in tm.nerfs())
    # The environment variable comes first; without any file, seed 0.
    zero = {k: torch.zeros_like(v) for k, v in
            _torchvision_vgg19(jp).items()}
    torch.save(zero, tmp_path / "zero.pth")
    monkeypatch.setenv("VGG19_TORCH_WEIGHTS", str(tmp_path / "zero.pth"))
    assert not tstate.build_models(tc, tr, device="cpu").vgg.conv1_1.weight.any()
    monkeypatch.delenv("VGG19_TORCH_WEIGHTS")
    seeded = [tstate.build_models(tc.replace(datadir=str(tmp_path / "no")),
                                  tr, device="cpu").vgg for _ in range(2)]
    assert torch.equal(seeded[0].conv1_1.weight, seeded[1].conv1_1.weight)
    assert not torch.equal(seeded[0].conv1_1.weight, tm.vgg.conv1_1.weight)


def _lpips_package_sd(tm, backbone):
    """The lpips package's state dict names (``net.slice{n}.{idx}...`` and
    ``lins.{i}.model.1.weight``) of ``tm``'s weights."""
    sd = tm.state_dict()
    out = {}
    if backbone == "squeeze":
        out["net.slice1.0.weight"] = sd["backbone.conv1.weight"]
        out["net.slice1.0.bias"] = sd["backbone.conv1.bias"]
        for idx, _, _ in tlp._SQUEEZE_FIRES:
            for sub in ("squeeze", "expand1x1", "expand3x3"):
                for p in ("weight", "bias"):
                    out[f"net.slice2.{idx}.{sub}.{p}"] = \
                        sd[f"backbone.fire_{idx}.{sub}.{p}"]
    else:
        for name, idx in tlp._TORCH_CONV_IDX[backbone]:
            for p in ("weight", "bias"):
                out[f"net.slice1.{idx}.{p}"] = sd[f"backbone.{name}.{p}"]
    for i, tap in enumerate(tm.tap_channels):
        out[f"lins.{i}.model.1.weight"] = sd[f"lin_{tap}.weight"]
    return out


@pytest.mark.parametrize("backbone", ["alex", "vgg", "squeeze"])
def test_lpips_matches_jax(backbone, tmp_path):
    """LPIPS at 33 x 40 (JAX's rule: at least 31 px a side), the distance
    and the spatial map (``jax.image.resize`` bilinear against
    ``F.interpolate(align_corners=False)``), on carried weights and from a
    ``.pth`` in the lpips package's layout read by both loaders."""
    from depth_lidar_nerf_tpu.utils.torch_weights import load_state_dict

    rng = np.random.default_rng(2)
    x0, x1 = (rng.uniform(size=(2, 33, 40, 3)).astype(np.float32)
              for _ in range(2))
    # Whole jitted programs: op-by-op Flax compiles each conv shape apart.
    jparams = jlp.abs_lin_heads(jax.jit(jlp.LPIPS(backbone=backbone).init)(
        jax.random.key(1), x0[:1], x1[:1]))
    sd = conv_state_dict(_np(jparams))
    for spatial in (False, True):
        jm = jlp.LPIPS(spatial=spatial, backbone=backbone)
        tm = tlp.LPIPS(spatial=spatial, backbone=backbone)
        tm.load_state_dict(sd)
        want = np.asarray(jax.jit(jm.apply)(jparams, x0, x1))
        got = tm(torch.from_numpy(x0), torch.from_numpy(x1)).detach().numpy()
        assert got.shape == ((2, 33, 40, 1) if spatial else (2,))
        _close(got, want)
        assert (got >= 0).all()
    # Both loaders read one file alike: the same weights, the heads' abs.
    torch.save(_lpips_package_sd(tm, backbone), tmp_path / "lp.pth")
    jp2 = jlp.abs_lin_heads(jlp.load_torch_lpips(
        jparams, load_state_dict(str(tmp_path / "lp.pth")), backbone))
    tm2 = tlp.init_lpips(backbone, weights_path=str(tmp_path / "lp.pth"),
                         device="cpu")
    assert not any(p.requires_grad for p in tm2.parameters())
    want = conv_state_dict(_np(jp2))
    got = tm2.state_dict()
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(got[k].numpy(), want[k].numpy(), k)


def test_ceil_max_pool_matches_jax():
    rng = np.random.default_rng(3)
    for h, w in ((16, 19), (15, 15), (7, 8)):
        x = rng.normal(size=(1, h, w, 4)).astype(np.float32)
        want = np.asarray(jlp._ceil_max_pool(jnp.asarray(x)))
        got = tlp._ceil_max_pool(torch.from_numpy(x).permute(0, 3, 1, 2))
        np.testing.assert_array_equal(got.permute(0, 2, 3, 1).numpy(), want)


def _grads(jf, tf, *arrays):
    """Value and gradients of JAX's ``jf`` and the port's ``tf`` at the
    same float32 arrays."""
    jv, jg = jax.value_and_grad(jf, argnums=tuple(range(len(arrays))))(
        *map(jnp.asarray, arrays))
    ts = [torch.from_numpy(a).requires_grad_() for a in arrays]
    tv = tf(*ts)
    tv.backward()
    return (float(jv), [np.asarray(g) for g in jg],
            tv.item(), [t.grad.numpy() for t in ts])


def test_patch_losses_and_gradients_match_jax():
    rng = np.random.default_rng(4)
    depth = rng.uniform(0.5, 3.0, (2, 9, 13, 1)).astype(np.float32)
    img = rng.uniform(size=(2, 9, 13, 3)).astype(np.float32)
    img2 = np.clip(img + rng.normal(0, 0.1, img.shape), 0, 1).astype(np.float32)
    cases = [(jloss.inverse_depth_smoothness_loss,
              tloss.inverse_depth_smoothness_loss, (depth, img)),
             (jloss.ssim, tloss.ssim, (img, img2))]
    feats = {k: rng.normal(size=(1, 6, 7, 5)).astype(np.float32)
             for k in ("a", "b")}
    gts = {k: rng.normal(size=(1, 6, 7, 5)).astype(np.float32)
           for k in ("a", "b")}
    for kind in ("l1", "l2"):
        cases.append((
            lambda a, b, _k=kind: jloss.vgg_feature_distance(
                {"a": a, "b": b}, gts, ("a", "b"), (0.1, 1.0), _k),
            lambda a, b, _k=kind: tloss.vgg_feature_distance(
                {"a": a, "b": b}, {k: torch.from_numpy(v)
                                   for k, v in gts.items()},
                ("a", "b"), (0.1, 1.0), _k),
            (feats["a"], feats["b"])))
    for jf, tf, arrays in cases:
        jv, jg, tv, tg = _grads(jf, tf, *arrays)
        np.testing.assert_allclose(tv, jv, rtol=1e-4)
        for a, b in zip(tg, jg):
            _close(a, b, rtol=1e-3)
    per_image = tloss.ssim(torch.from_numpy(img), torch.from_numpy(img2),
                           size_average=False)
    np.testing.assert_allclose(
        per_image.numpy(),
        np.asarray(jloss.ssim(img, img2, size_average=False)), rtol=1e-4)
    assert tloss.ssim(torch.from_numpy(img[0]),
                      torch.from_numpy(img[0])).item() == pytest.approx(1.0)
    with pytest.raises(ValueError, match="l1 or l2"):
        tloss.vgg_feature_distance(feats, feats, ("a",), (1.0,), "l3")


def test_lpips_patch_step_matches_jax(monkeypatch):
    """An LPIPS (alex, spatial map logged) patch step on a 32 x 40 scene
    with a 32 x 32 patch, against JAX's: the loss, every metric, the
    ``lpips_spatial`` map and the updated parameters. The MLPs run as plain
    modules on both sides (a 1,024-ray crop in the Pallas interpreter would
    take minutes); the kernels' routes are held by the other step tests."""
    t = patch_pair(monkeypatch, feature_on=True, hw=(32, 40), focal=36.0,
                   samples=(16, 16), nH=32, nW=32, gradH=4, gradW=4,
                   feature_loss_type="lpips", lpips_spatial=True,
                   use_fused_mlp=False)
    tm, _ = patch_step_against_jax(t)
    assert tm["lpips_spatial"].shape == (32, 32)
    assert {"feature_loss", "feature_loss0"} <= set(tm)
