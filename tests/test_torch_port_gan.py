"""The port's GAN loss against the JAX package on the CPU: the four
discriminators (``models/discriminator.py``), the Flax-to-port weight
conversion (``weights.disc_state_dict``) against JAX's
``convert_discriminator``, ``gan_mse`` and ``gan_noise_std_at`` (bit for
bit), the reference ``.tar``'s discriminator and its Adam moments against
JAX's import, and whole GAN steps against JAX ``make_train_step(...,
gan_on=True)`` (Pallas kernels in the interpreter) from the same weights,
crop, rays and noises: GAN only and GAN + feature + smoothness at noise std
0 and 0.1, three iterations in a row, and grid mode.

Tolerances: float32 outputs rtol 1e-4; step metrics rtol 1e-4, updated
parameters rtol 1e-4 with atol 2.5e-5, Adam moments rtol 1e-3 (the step
tests', ``test_torch_port_train_step.py``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from depth_lidar_nerf_tpu.models import discriminator as jdisc
from depth_lidar_nerf_tpu.train import losses as jlosses
from depth_lidar_nerf_tpu.train import torch_import as jimport
from depth_lidar_nerf_tpu_torch.models import discriminator as tdisc
from depth_lidar_nerf_tpu_torch.train import losses as tlosses
from depth_lidar_nerf_tpu_torch.weights import disc_state_dict
from torch_port_patch_helpers import (patch_pair, patch_step_against_jax,
                                      sync_port_from_jax)


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _pair(arch, hw, x):
    """JAX's discriminator of ``arch`` initialised on ``x`` and the port's
    with the same weights."""
    if arch == "dc":
        j = jdisc.DCDiscriminator(in_dim=3, n_feat=32, img_size=hw[0])
        t = tdisc.DCDiscriminator(in_dim=3, n_feat=32, img_size=hw[0])
    else:
        j = {"esr": jdisc.ESRDiscriminator, "ls": jdisc.LSDiscriminator,
             "basic": jdisc.BasicDiscriminator}[arch]()
        t = {"esr": tdisc.ESRDiscriminator, "ls": tdisc.LSDiscriminator,
             "basic": tdisc.BasicDiscriminator}[arch](hw)
    variables = j.init(jax.random.key(4), jnp.asarray(x))
    t.load_state_dict(disc_state_dict(_np_tree(variables), hw, arch))
    return j, variables, t


@pytest.mark.parametrize("arch,hw", [
    ("esr", (12, 16)), ("esr", (13, 17)), ("ls", (12, 16)), ("ls", (13, 17)),
    ("basic", (12, 16)), ("basic", (13, 17)), ("dc", (16, 16))])
def test_discriminators_match_jax(arch, hw):
    """Each discriminator's logits against JAX's on the same weights: the
    convolutions' padding and stride, the LeakyReLU slope and the
    classifier's flatten order; at 13 x 17 rounding up and down differ.
    Basic runs deterministic (no dropout), DC on 5 channels (the extra two
    sliced off)."""
    ch = 5 if arch == "dc" else 3
    x = np.random.default_rng(1).normal(size=(2, *hw, ch)).astype(np.float32)
    j, variables, t = _pair(arch, hw, x)
    want = np.asarray(j.apply(variables, jnp.asarray(x)))
    with torch.no_grad():
        got = t(torch.from_numpy(x)).numpy()
    assert got.shape == want.shape == (2, 1)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-6)


def test_discriminator_init_and_gradient_match_jax():
    """The port's initialisation draws Flax's LeCun-normal rule (the
    per-layer std within 5%, biases zero, the classifier sized by the
    convolutions), and the input gradient of the ESR logit equals JAX's."""
    hw = (13, 17)
    t = tdisc.ESRDiscriminator(hw, generator=torch.Generator().manual_seed(0))
    assert t.classifier[0].weight.shape == (1, 32 * 4 * 5)
    for name, p in t.named_parameters():
        if name.endswith("bias"):
            assert not p.detach().any()
            continue
        fan_in = p[0].numel()
        std = p.detach().std().item()
        assert abs(std * np.sqrt(fan_in) - 1.0) < 0.05 or p.numel() < 500, name
    x = np.random.default_rng(2).normal(size=(1, *hw, 3)).astype(np.float32)
    j, variables, t = _pair("esr", hw, x)
    want = np.asarray(jax.grad(lambda v: jnp.sum(j.apply(variables, v)))(
        jnp.asarray(x)))
    xt = torch.from_numpy(x).requires_grad_()
    t(xt).sum().backward()
    np.testing.assert_allclose(xt.grad.numpy(), want, rtol=1e-3, atol=1e-7)


def test_basic_dropout_draws_from_its_generator():
    """The Basic discriminator's dropout: off by default; on, a mask from
    the generator given (the same seed, the same logits), kept values scaled
    by 1 / keep."""
    t = tdisc.BasicDiscriminator((12, 16),
                                 generator=torch.Generator().manual_seed(0))
    x = torch.from_numpy(np.random.default_rng(3).normal(
        size=(2, 12, 16, 3)).astype(np.float32))
    with torch.no_grad():
        a = t(x, deterministic=False,
              generator=torch.Generator().manual_seed(5))
        b = t(x, deterministic=False,
              generator=torch.Generator().manual_seed(5))
        c = t(x, deterministic=False,
              generator=torch.Generator().manual_seed(6))
        plain = t(x)
    assert torch.equal(a, b) and not torch.equal(a, c)
    assert not torch.equal(a, plain)


@pytest.mark.parametrize("arch", ["esr", "ls", "basic", "dc"])
def test_disc_state_dict_inverts_jax_convert_discriminator(arch):
    """A reference-layout state dict (random) through JAX's
    ``convert_discriminator`` into a Flax tree, and back through
    ``disc_state_dict``, is the state dict again bit for bit, at 12 x 16
    (a size where JAX's ``// 4`` sizing holds; LS at 32 x 32, which its
    ``// 16`` needs, DC at 16 x 16)."""
    hw = {"esr": (12, 16), "basic": (12, 16), "ls": (32, 32),
          "dc": (16, 16)}[arch]
    x = np.zeros((1, *hw, 3), np.float32)
    _, variables, t = _pair(arch, hw, x)
    gen = torch.Generator().manual_seed(9)
    ref = {k: torch.randn(v.shape, generator=gen)
           for k, v in t.state_dict().items()}
    flax = jimport.convert_discriminator(
        variables, {k: v.numpy() for k, v in ref.items()}, patch_hw=hw,
        arch=arch)
    back = disc_state_dict(_np_tree(flax), hw, arch)
    assert back.keys() == ref.keys()
    for k in ref:
        assert torch.equal(back[k], ref[k]), k


def test_jax_converter_fails_at_the_kitti_patch_where_the_port_sizes_right():
    """At 94 x 352 the ESR feature map is 24 x 88 (94 -> 47 -> 24): the
    port's classifier takes 32 * 24 * 88 = 67,584 inputs. JAX's converter
    sizes it from 94 // 4 = 23 and cannot reshape (the reference's
    behaviour, recorded, not repaired there)."""
    hw = (94, 352)
    t = tdisc.ESRDiscriminator(hw)
    assert t.classifier[0].in_features == 32 * 24 * 88 == 67584
    j = jdisc.ESRDiscriminator()
    variables = j.init(jax.random.key(0), jnp.zeros((1, *hw, 3)))
    sd = {k: v.detach().numpy() for k, v in t.state_dict().items()}
    with pytest.raises(ValueError, match="cannot reshape"):
        jimport.convert_esr_discriminator(variables, sd, patch_hw=hw)
    back = disc_state_dict(
        {"params": {"classifier": {
            "kernel": sd["classifier.0.weight"].reshape(32, 24, 88)
            .transpose(1, 2, 0).reshape(-1, 1),
            "bias": sd["classifier.0.bias"]}}}, hw)
    np.testing.assert_array_equal(back["classifier.0.weight"].numpy(),
                                  sd["classifier.0.weight"])


def test_gan_mse_and_noise_std_match_jax():
    """``gan_mse`` at rtol 1e-6; ``gan_noise_std_at`` bit for bit against
    JAX's, jitted as its step evaluates it on the int32 count, including the
    5,000-step boundary."""
    rng = np.random.default_rng(0)
    pred = rng.normal(size=(3, 1)).astype(np.float32)
    for target in (0.0, 1.0):
        np.testing.assert_allclose(
            tlosses.gan_mse(torch.from_numpy(pred), target).item(),
            float(jlosses.gan_mse(jnp.asarray(pred), target)), rtol=1e-6)
    jitted = jax.jit(jlosses.gan_noise_std_at, static_argnums=1)
    for start in (0.1, 0.3):
        for step in (0, 1, 4999, 5000, 123457):
            want = np.asarray(jitted(jnp.int32(step), start))
            got = tlosses.gan_noise_std_at(step, start).numpy()
            assert got.dtype == want.dtype == np.float32
            assert got.tobytes() == want.tobytes(), (start, step, got, want)


# ------------------------------------------------------ the reference .tar


def _reference_disc(hw, seed):
    """A reference-layout ESR discriminator (``classifier`` registered
    before ``model``, ``discriminator.py:49-55``), trained two Adam steps so
    that it has moments."""
    nn = torch.nn
    h, w = tdisc.feature_hw(hw, 2)

    class TD(nn.Module):
        def __init__(self):
            super().__init__()
            self.classifier = nn.Sequential(nn.Linear(32 * h * w, 1))
            blocks, cin = [], 3
            for cout in (16, 32):
                blocks += [nn.Conv2d(cin, cout, 3, 1, 1), nn.LeakyReLU(0.2),
                           nn.Conv2d(cout, cout, 3, 2, 1), nn.LeakyReLU(0.2)]
                cin = cout
            self.model = nn.Sequential(*blocks)

        def forward(self, img):
            return self.classifier(torch.flatten(self.model(img), 1))

    torch.manual_seed(seed)
    td = TD()
    opt = torch.optim.Adam(td.parameters(), lr=5e-4, betas=(0.9, 0.999))
    for _ in range(2):
        opt.zero_grad()
        td(torch.randn(2, 3, *hw)).square().mean().backward()
        opt.step()
    return td, opt


def test_reference_discriminator_and_moments_import_as_jax(tmp_path):
    """The reference's ``discriminator_state_dict`` and
    ``discriminator_optimizer_dict`` at 12 x 16: the port's import (a key
    rename, moments by the reference's parameter order) equals JAX's
    (``convert_esr_discriminator``, ``import_disc_adam_state``) carried
    across with ``disc_state_dict``, bit for bit, and the logits equal the
    reference module's; a wrong crop keeps a fresh discriminator with
    JAX's message."""
    import optax

    from depth_lidar_nerf_tpu.utils.torch_weights import load_state_dict
    from depth_lidar_nerf_tpu_torch.train import torch_import as timport
    from depth_lidar_nerf_tpu_torch.train.config import TrainConfig
    from depth_lidar_nerf_tpu_torch.train.state import make_disc_optimizer

    hw = (12, 16)
    td, opt = _reference_disc(hw, 3)
    tar = str(tmp_path / "d.tar")
    torch.save({"discriminator_state_dict": td.state_dict(),
                "discriminator_optimizer_dict": opt.state_dict()}, tar)
    jckpt = load_state_dict(tar)
    j = jdisc.ESRDiscriminator()
    variables = j.init(jax.random.key(0), jnp.zeros((1, *hw, 3)))
    jvars = jimport.convert_esr_discriminator(
        variables, jckpt["discriminator_state_dict"], patch_hw=hw)
    jopt = jimport.import_disc_adam_state(
        optax.adam(5e-4, b1=0.9, b2=0.999, eps=1e-8), jvars, jckpt, 2,
        patch_hw=hw)
    ckpt = torch.load(tar, weights_only=True)
    disc = tdisc.ESRDiscriminator(hw)
    disc.load_state_dict(timport.convert_discriminator_state_dict(
        disc, ckpt["discriminator_state_dict"]))
    dopt = make_disc_optimizer(TrainConfig(), disc.parameters())
    assert timport.import_disc_adam_state(dopt, disc, ckpt, 2)
    assert dopt.count == int(jopt[0].count) == 2
    want = disc_state_dict(_np_tree(jvars), hw)
    mu = disc_state_dict(_np_tree(jopt[0].mu), hw)
    nu = disc_state_dict(_np_tree(jopt[0].nu), hw)
    for name, p in disc.named_parameters():
        assert torch.equal(p.detach(), want[name]), name
        assert torch.equal(dopt.state[p]["exp_avg"], mu[name]), name
        assert torch.equal(dopt.state[p]["exp_avg_sq"], nu[name]), name
    x = torch.randn(2, *hw, 3)
    with torch.no_grad():
        np.testing.assert_allclose(disc(x).numpy(),
                                   td(x.permute(0, 3, 1, 2)).numpy(),
                                   rtol=1e-5, atol=1e-7)
    wrong = tdisc.ESRDiscriminator((16, 16))
    with pytest.raises(ValueError, match="patch nH/nW differ"):
        timport.convert_discriminator_state_dict(
            wrong, ckpt["discriminator_state_dict"])


# ------------------------------------------------------------ the GAN step


@pytest.mark.parametrize("std", [0.0, 0.1])
def test_gan_step_matches_jax(monkeypatch, std):
    """One GAN-only patch step (two MLPs; the discriminator on both passes'
    crops, then its own step) against JAX's at noise std 0 and 0.1, JAX's
    noises handed over: ``loss``, ``gan_loss``, ``loss_dis``, the MLPs' and
    the discriminator's parameters and moments."""
    t = patch_pair(monkeypatch, gan_on=True, gan_noise_std=std)
    tm, jm = patch_step_against_jax(t)
    assert {"gan_loss", "loss_dis"} <= set(tm)
    assert "feature_loss" not in tm and "inv_loss" not in tm


@pytest.mark.parametrize("std", [0.0, 0.1])
def test_gan_feature_smooth_step_matches_jax(monkeypatch, std):
    """The KITTI schedule's full patch iteration past ``gan_start``: GAN +
    VGG feature + smoothness, one step against JAX's."""
    t = patch_pair(monkeypatch, gan_on=True, feature_on=True, smooth_on=True,
                   gan_noise_std=std)
    tm, _ = patch_step_against_jax(t)
    assert {"gan_loss", "loss_dis", "feature_loss", "inv_loss"} <= set(tm)


def test_gan_step_at_count_5000_matches_jax(monkeypatch):
    """From a state at step count 5,000 (where ``0.9 ** (step / 5000)``
    crosses its first period): both GAN legs read the noise std once, at the
    count before the update, and the step equals JAX's."""
    from depth_lidar_nerf_tpu_torch.train import step as tstep

    t = patch_pair(monkeypatch, gan_on=True, gan_noise_std=0.1)
    t["jax_state"] = t["jax_state"].replace(step=jnp.int32(5000))
    t["port_state"].step = 5000
    counts = []
    orig = tstep.losses.gan_noise_std_at

    def spy(step, start):
        counts.append(step)
        return orig(step, start)

    monkeypatch.setattr(tstep.losses, "gan_noise_std_at", spy)
    tm, _ = patch_step_against_jax(t)
    assert counts == [5000]
    assert t["port_state"].step == 5001


def test_three_gan_iterations_match_jax(monkeypatch):
    """Three GAN iterations in a row from JAX's state (the port synced from
    JAX's before each, as the step tests do), each its own crop, rays and
    noises; the noise std read at each pre-update count."""
    t = patch_pair(monkeypatch, gan_on=True, gan_noise_std=0.1)
    for i in range(3):
        if i:
            sync_port_from_jax(t)
        patch_step_against_jax(t, seed=i)
    assert t["port_state"].step == 3


def test_grid_gan_step_matches_jax(monkeypatch):
    """Grid mode (``grid_train_fine_only``, ``patch_render_samples`` 32): the
    GAN term and the discriminator see the fine crop only."""
    t = patch_pair(monkeypatch, gan_on=True, grid=True,
                   grid_train_fine_only=True, patch_render_samples=32,
                   gan_noise_std=0.1)
    tm, _ = patch_step_against_jax(t)
    assert "gan_loss" in tm and "img_loss0" not in tm


def test_generator_leg_leaves_the_discriminator_without_gradient(monkeypatch):
    """The generator's backward reaches no discriminator parameter (JAX's
    ``stop_gradient(disc_params)``), the discriminator step sees the crop of
    the generator's forward, and every GAN step runs cuDNN's deterministic
    algorithms and gives the caller's setting back."""
    from depth_lidar_nerf_tpu_torch.train import step as tstep

    t = patch_pair(monkeypatch, gan_on=True, gan_noise_std=0.1)
    ts = t["port_state"]
    disc = ts.models.discriminator
    seen, fakes = [], []
    orig_step = ts.optimizer.step

    def nerf_step():
        seen.append([p.grad for p in disc.parameters()])
        orig_step()

    ts.optimizer.step = nerf_step
    disc.register_forward_pre_hook(
        lambda m, a: fakes.append((torch.backends.cudnn.deterministic,
                                   a[0].detach().clone())))
    before = torch.backends.cudnn.deterministic
    gen = torch.Generator().manual_seed(0)
    from torch_port_patch_helpers import patch_batches

    _, tp = patch_batches(t)
    zeros = {k: np.zeros((1, 8, 12, 3), np.float32) for k in tstep.GAN_NOISES}
    t["port_step"](ts, *t["port_tables"], gen, patch=tp, gan_noise=zeros)
    assert seen == [[None] * len(list(disc.parameters()))]
    assert all(p.requires_grad for p in disc.parameters())
    assert [det for det, _ in fakes] == [True] * 5
    assert torch.backends.cudnn.deterministic == before
    # The generator's leg (fine, coarse crop), then the discriminator's step
    # (real, fake fine, fake coarse): the fakes are the generator's crops.
    (_, g0), (_, g1), (_, real), (_, f0), (_, f1) = fakes
    assert torch.equal(real, tp.gt_patch[None])
    assert torch.equal(g0, f0) and torch.equal(g1, f1)
    assert not torch.equal(g0, g1)
