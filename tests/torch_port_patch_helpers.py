"""Shared inputs for the PyTorch port's patch-step parity tests
(``test_torch_port_patch_*``).

Both packages' patch steps are built on the same tiny synthetic scene, the
port's MLP and perceptual weights converted from the Flax trees; one
``PatchBatch`` (image, crop, permutation, made with numpy from a seed) and
JAX's ray indices are handed to both sides, with ``perturb=False`` and
``raw_noise_std=0``, since JAX's threefry and torch's Philox never draw the
same numbers.
"""

import numpy as np

from torch_port_train_helpers import _jax_state_dicts, jax_step_indices

# The patch of the small scene (12 x 16): 8 x 12 = 96 rays, 8 with gradients.
SMALL_PATCH = dict(nH=8, nW=12, gradH=2, gradW=4)


def patch_pair(monkeypatch, *, feature_on=False, smooth_on=False,
               gan_on=False, precrop_on=False, semantic=False, grid=False,
               hw=(12, 16), focal=14.0, samples=(64, 64), **extra):
    """Both packages' patch steps: coarse D=4 / fine D=4 (D=8 skip@4 with
    ``semantic``) / W=128, ``samples`` (N_samples, N_importance), half RGB
    and half depth rays, float32, multires 4/2 and a coarse density head of
    weight 0 and bias 0.8 (``torch_port_train_helpers.train_pair`` says
    why), ``SMALL_PATCH`` unless ``extra`` says otherwise, the VGG taps
    conv1_2 and conv2_2 (l1, weights 0.1 and 1). With ``grid``, the grid
    variant on one ray CDF (S = 96) that JAX bakes from the initial coarse
    field. Returns a dict of both sides' objects."""
    import jax
    import torch

    from depth_lidar_nerf_tpu.ops import ray_cdf as jcdf
    from depth_lidar_nerf_tpu.train import config as jcfg
    from depth_lidar_nerf_tpu.train import state as jstate
    from depth_lidar_nerf_tpu.train import step as jstep
    from depth_lidar_nerf_tpu.train import tables as jtables
    from depth_lidar_nerf_tpu_torch.data.synthetic import draw_scene
    from depth_lidar_nerf_tpu_torch.ops.ray_cdf import RayCDF
    from depth_lidar_nerf_tpu_torch.train import config as tcfg
    from depth_lidar_nerf_tpu_torch.train import state as tstate
    from depth_lidar_nerf_tpu_torch.train import step as tstep
    from depth_lidar_nerf_tpu_torch.train import tables as ttables
    from depth_lidar_nerf_tpu_torch.weights import (conv_state_dict,
                                                    disc_state_dict,
                                                    params_from_jax)

    monkeypatch.setenv("DLNERF_PALLAS_INTERPRET", "1")
    sc = draw_scene(n_images=2, H=hw[0], W=hw[1], focal=focal,
                    n_depth_points=40, seed=0, backdrop=True,
                    num_classes=19 if semantic else None)
    H, W, focal = sc.hwf
    fields = dict(dataset_type="llff", N_rand=64, N_samples=samples[0],
                  N_importance=samples[1], netdepth=4, netwidth=128,
                  netdepth_fine=8 if semantic else 4, netwidth_fine=128,
                  use_viewdirs=True, no_ndc=True, perturb=0.0,
                  raw_noise_std=0.0, colmap_depth=True, depth_loss=True,
                  depth_lambda=0.01, cull_eps=1e-4, multires=4,
                  multires_views=2, semantic_loss=semantic,
                  semantic_lambda=0.04, feature_loss=feature_on,
                  feature_start_iteration=1, feature_loss_every_n=1,
                  feature_lambda=0.1, vgg_layers=["conv1_2", "conv2_2"],
                  vgg_layer_weights=[0.1, 1.0], vgg_loss_type="l1",
                  depth_inverse_loss=smooth_on, depth_inverse_loss_every_n=1,
                  depth_inverse_lambda=0.1, datadir="/nonexistent",
                  gan_loss=gan_on, gan_lambda=0.1, **SMALL_PATCH)
    fields.update(extra)
    if grid:
        fields.update(grid_train=True, grid_train_samples=96)
    n_cls = sc.num_classes if semantic else 0
    seg = sc.segmentation if semantic else None
    jc, tc = jcfg.TrainConfig(**fields), tcfg.TrainConfig(**fields)
    jr = jcfg.render_config_from(jc, n_cls, sc.near, sc.far)
    tr = tcfg.render_config_from(tc, n_cls, sc.near, sc.far)
    jm = jstate.build_models(jc, jr)
    js = jstate.init_train_state(jc, jr, jm, jax.random.key(0))
    sigma = js.params["coarse"]["params"]["sigma"]
    sigma["kernel"] = sigma["kernel"] * 0.0
    sigma["bias"] = sigma["bias"] + 0.8
    js = js.replace(opt_state=jstate.make_optimizer(jc).init(js.params))
    vgg_params = jstate.init_vgg_params(jc, jm, jax.random.key(7))
    i_train = np.arange(2)
    j_rgb = jtables.build_rgb_table(sc.images, sc.poses, i_train, H, W, focal,
                                    jr, segmentation=seg)
    j_dep = jtables.build_depth_table(sc.depth_gts, sc.poses, i_train, H, W,
                                      focal, jr)
    cpu = torch.device("cpu")
    tm = tstate.build_models(tc, tr, device=cpu)
    sds = params_from_jax(jax.tree.map(np.asarray, js.params))
    tm.coarse.load_state_dict(sds["coarse"])
    tm.fine.load_state_dict(sds["fine"])
    for mod in (tm.vgg, tm.lpips):
        if mod is not None:
            mod.load_state_dict(conv_state_dict(
                jax.tree.map(np.asarray, vgg_params)))
    if gan_on:
        tm.discriminator.load_state_dict(disc_state_dict(
            jax.tree.map(np.asarray, js.disc_params), (jc.nH, jc.nW)))
    variant = dict(feature_on=feature_on, smooth_on=smooth_on, gan_on=gan_on,
                   precrop_on=precrop_on)
    t = dict(
        jax_step=jstep.make_train_step(jc, jr, jm, sc.hwf, grid_mode=grid,
                                       **variant),
        jax_state=js, jax_tables=(j_rgb, j_dep), vgg_params=vgg_params,
        port_step=tstep.make_train_step(tc, tr, tm, sc.hwf, grid_mode=grid,
                                        **variant),
        port_state=tstate.init_train_state(tc, tm),
        port_tables=(ttables.build_rgb_table(sc.images, sc.poses, i_train, H,
                                             W, focal, tr, segmentation=seg,
                                             device=cpu),
                     ttables.build_depth_table(sc.depth_gts, sc.poses,
                                               i_train, H, W, focal, tr,
                                               device=cpu)),
        port_cfg=(tc, tr, sc.hwf), scene=sc, jax_models=jm, port_models=tm,
        n_rgb=32, n_depth=32, jax_cdf=None, port_cdf=None)
    if grid:
        cdf = jcdf.bake_ray_cdf(jstate.Models(jm.coarse, None, None, None),
                                {"coarse": js.params["coarse"]}, jr, j_rgb,
                                j_dep, 96)
        c = jax.tree.map(np.asarray, cdf)
        t["jax_cdf"] = cdf
        t["port_cdf"] = RayCDF(
            torch.from_numpy(np.array(c.w_rgb.view(np.int16))).view(torch.bfloat16),
            torch.from_numpy(np.array(c.w_depth.view(np.int16))).view(torch.bfloat16),
            torch.from_numpy(np.array(c.z)))
    return t


def patch_batches(t, seed=0):
    """One crop of a training image and a permutation of its pixels (numpy,
    from ``seed``), as JAX's and as the port's ``PatchBatch``."""
    import jax.numpy as jnp
    import torch

    from depth_lidar_nerf_tpu.train.step import PatchBatch as JPatch
    from depth_lidar_nerf_tpu_torch.train.step import PatchBatch as TPatch

    cfg = t["port_cfg"][0]
    sc = t["scene"]
    H, W, _ = sc.hwf
    rng = np.random.default_rng(seed)
    img = int(rng.integers(0, 2))
    sh = int(rng.integers(0, H - cfg.nH + 1))
    sw = int(rng.integers(0, W - cfg.nW + 1))
    perm = rng.permutation(cfg.nH * cfg.nW)
    gt = np.asarray(sc.images[img][sh:sh + cfg.nH, sw:sw + cfg.nW],
                    np.float32)
    c2w = np.asarray(sc.poses[img], np.float32)
    jp = JPatch(jnp.asarray(c2w), jnp.asarray(gt), jnp.float32(sh),
                jnp.float32(sw), jnp.asarray(perm, jnp.int32), jnp.int32(img))
    tp = TPatch(torch.from_numpy(c2w), torch.from_numpy(gt), torch.tensor(sh),
                torch.tensor(sw), torch.from_numpy(perm), torch.tensor(img))
    return jp, tp


def jax_gan_noises(rng, nH, nW):
    """The standard normal noises JAX's GAN step draws from its step key, by
    the port's names (``train.step.GAN_NOISES``): in ``_iter_body``,
    ``k_ng, k_loss, k_disc = split(rng, 3)``; the generator's from
    ``split(k_loss, 8)[5:7]``, the discriminator's from ``split(k_disc,
    3)``."""
    import jax

    _, k_loss, k_disc = jax.random.split(rng, 3)
    keys = jax.random.split(k_loss, 8)
    k_r, k_f, k_f0 = jax.random.split(k_disc, 3)
    shape = (1, nH, nW, 3)
    return {name: np.asarray(jax.random.normal(k, shape))
            for name, k in (("noise", keys[5]), ("noise0", keys[6]),
                            ("noise_real", k_r), ("noise_fake", k_f),
                            ("noise_f0", k_f0))}


def _disc_moments(js, nH, nW):
    """JAX's discriminator parameters and Adam moments as the port's state
    dicts."""
    import jax

    from depth_lidar_nerf_tpu_torch.weights import disc_state_dict

    adam = js.disc_opt_state[0]
    return [disc_state_dict(jax.tree.map(np.asarray, t), (nH, nW))
            for t in (js.disc_params, adam.mu, adam.nu)]


def sync_port_from_jax(t):
    """Start the port from JAX's state: the MLPs' parameters and Adam
    moments and counts, and with the GAN the discriminator's."""
    import torch

    js, ts = t["jax_state"], t["port_state"]
    params, mu, nu = _jax_state_dicts(js)
    with torch.no_grad():
        for net, m in (("coarse", ts.models.coarse), ("fine", ts.models.fine)):
            for name, p in m.named_parameters():
                p.copy_(params[net][name])
                st = ts.optimizer.state[p]
                st["exp_avg"] = mu[net][name].clone()
                st["exp_avg_sq"] = nu[net][name].clone()
        ts.optimizer.count = int(js.opt_state[0].count)
        if ts.disc_optimizer is not None:
            cfg = t["port_cfg"][0]
            dp, dmu, dnu = _disc_moments(js, cfg.nH, cfg.nW)
            for name, p in ts.models.discriminator.named_parameters():
                p.copy_(dp[name])
                st = ts.disc_optimizer.state[p]
                st["exp_avg"] = dmu[name].clone()
                st["exp_avg_sq"] = dnu[name].clone()
            ts.disc_optimizer.count = int(js.disc_opt_state[0].count)
    ts.step = int(js.step)


def patch_step_against_jax(t, seed=0, metric_rtol=1e-4,
                           indices=jax_step_indices):
    """One patch step of both packages from the same state, crop and ray
    indices (and with the GAN JAX's noises): every metric (``metric_rtol``;
    maps elementwise), every updated parameter (rtol 1e-4, atol 2.5e-5, as
    the base step tests) and both Adam moments (rtol 1e-3 with an atol of
    1e-3 of each tensor's largest), the discriminator's too. ``indices``
    rebuilds JAX's ray indices from its step key. Returns both metric
    dicts."""
    import jax

    js, ts = t["jax_state"], t["port_state"]
    j_rgb, j_dep = t["jax_tables"]
    cfg = t["port_cfg"][0]
    jp, tp = patch_batches(t, seed)
    rng = jax.random.key(300 + seed)
    idx, idx_d = indices(rng, t["n_rgb"], t["n_depth"],
                         j_rgb.origins.shape[0], j_dep.origins.shape[0])
    gan_noise = (jax_gan_noises(rng, cfg.nH, cfg.nW)
                 if ts.disc_optimizer is not None else None)
    step0 = int(js.step)
    js, jm = t["jax_step"](js, j_rgb, j_dep, jp, t["vgg_params"], rng,
                           t["jax_cdf"])
    t["jax_state"] = js
    tm = t["port_step"](ts, *t["port_tables"], idx=idx, idx_d=idx_d,
                        aux=t["port_cdf"], patch=tp, gan_noise=gan_noise)
    assert set(tm) == set(jm), (sorted(tm), sorted(jm))
    for k in jm:
        np.testing.assert_allclose(tm[k].numpy(), np.asarray(jm[k]),
                                   rtol=metric_rtol, atol=1e-7, err_msg=k)
    params, mu, nu = _jax_state_dicts(js)
    opt = ts.optimizer
    for net, m in (("coarse", ts.models.coarse), ("fine", ts.models.fine)):
        for name, p in m.named_parameters():
            np.testing.assert_allclose(
                p.detach().numpy(), params[net][name].numpy(), rtol=1e-4,
                atol=2.5e-5, err_msg=f"{net} {name}")
            if not opt.state.get(p):  # never had a gradient (grid coarse)
                assert not mu[net][name].numpy().any()
                continue
            for key, want in (("exp_avg", mu), ("exp_avg_sq", nu)):
                w = want[net][name].numpy()
                np.testing.assert_allclose(
                    opt.state[p][key].numpy(), w, rtol=1e-3,
                    atol=1e-3 * np.abs(w).max() + 1e-30,
                    err_msg=f"{net} {name} {key}")
    if ts.disc_optimizer is not None:
        dp, dmu, dnu = _disc_moments(js, cfg.nH, cfg.nW)
        for name, p in ts.models.discriminator.named_parameters():
            np.testing.assert_allclose(p.detach().numpy(), dp[name].numpy(),
                                       rtol=1e-4, atol=2.5e-5,
                                       err_msg=f"disc {name}")
            st = ts.disc_optimizer.state[p]
            for key, want in (("exp_avg", dmu), ("exp_avg_sq", dnu)):
                w = want[name].numpy()
                np.testing.assert_allclose(
                    st[key].numpy(), w, rtol=1e-3,
                    atol=1e-3 * np.abs(w).max() + 1e-30,
                    err_msg=f"disc {name} {key}")
        assert ts.disc_optimizer.count == int(js.disc_opt_state[0].count)
    assert ts.step == int(js.step) == step0 + 1
    return tm, jm
