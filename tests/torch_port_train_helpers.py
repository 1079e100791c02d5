"""Shared inputs for the PyTorch-port training parity tests
(``test_torch_port_train_*``).

JAX runs its Pallas kernels in the interpreter; inputs are made with numpy
from a seed and handed to both packages, weights converted from the Flax
pytrees with ``params_from_jax``.
"""

import numpy as np

from torch_port_helpers import flax_mlp_params, interpret_pallas, ray_batch

ROUTE_FNS = ("_bwd_dense_dparams", "_bwd_culled_dparams", "_bwd_acts_dparams",
             "_bwd_acts_sem_dparams")


def spy_routes(monkeypatch, module, calls):
    """Record in ``calls`` the name of every backward route ``module`` runs
    (JAX ``ops/fused_mlp_t`` or the port's; both name them alike)."""
    for name in ROUTE_FNS:
        orig = getattr(module, name)

        def spy(*a, _orig=orig, _name=name, **k):
            calls.append(_name)
            return _orig(*a, **k)

        monkeypatch.setattr(module, name, spy)


def zero_suffix_cotangent(N, S, seed, lengths=None):
    """A float32 cotangent ``[4, N, S]`` whose rays are live for the first
    ``lengths[n]`` samples and exactly zero after, as ``cull_eps``-masked
    compositing makes them."""
    rng = np.random.default_rng(seed)
    g = rng.normal(size=(4, N, S)).astype(np.float32)
    if lengths is None:
        lengths = rng.integers(0, S + 1, N)
    live = np.arange(S)[None, :] < np.asarray(lengths)[:, None]
    return (g * live[None]).astype(np.float32)


def jax_fused_grads(monkeypatch, depth, width, S, dtype, cull_bwd, save_acts,
                    g, N=8, seed=0):
    """JAX ``fused_nerf_apply_rays`` gradients (Pallas interpreter) for the
    cotangent ``g``, as the port's parameter mapping, and the backward
    routes JAX ran. Also returns the Flax params and the rays."""
    import jax
    import jax.numpy as jnp

    import depth_lidar_nerf_tpu.ops.fused_mlp as fm
    import depth_lidar_nerf_tpu.ops.fused_mlp_t as fmt
    from depth_lidar_nerf_tpu_torch.weights import mlp_state_dict

    interpret_pallas(monkeypatch, fm, fmt)
    calls = []
    spy_routes(monkeypatch, fmt, calls)
    _, params = flax_mlp_params(depth, width, seed=seed)
    rays = ray_batch(N, S, seed=seed + 1)

    def f(p):
        return fmt.fused_nerf_apply_rays(
            p, *rays, depth=depth, width=width, multires=10,
            multires_views=4, dtype=getattr(jnp, dtype), cull_bwd=cull_bwd,
            save_acts=save_acts, skips=(4,))

    _, vjp = jax.vjp(f, params)
    (grads,) = vjp(jnp.asarray(g))
    return (mlp_state_dict(jax.tree.map(np.asarray, grads)), calls, params,
            rays)


def grad_compare(ref, got, tol):
    """The JAX suite's ``_grad_compare`` metric (``tests/test_fused_mlp.py``):
    per tensor, max abs error over mean abs of the reference."""
    for k, a in ref.items():
        a = np.asarray(a, np.float64)
        b = np.asarray(got[k].detach().numpy(), np.float64)
        err = np.abs(a - b).max() / (np.abs(a).mean() + 1e-12)
        assert err < tol, (k, err)


def grad_compare_bf16(ref, got, tol=3e-2):
    """bfloat16 level: per tensor, the relative L2 error. The encodings of
    the two packages round differently in bfloat16 (JAX uses the
    double-angle recurrence), and a rounding flip moves a ReLU gate."""
    for k, a in ref.items():
        a = np.asarray(a, np.float64)
        b = np.asarray(got[k].detach().float().numpy(), np.float64)
        err = np.linalg.norm(a - b) / (np.linalg.norm(a) + 1e-12)
        assert err < tol, (k, err)


def train_pair(monkeypatch, cull_eps, n_rand=64, seed=0, semantic=False,
               netdepth_fine=8, sigma_loss=False):
    """Both packages' base training step on the same tiny synthetic scene:
    coarse D=4 / fine D=8 skip@4 (or ``netdepth_fine``) / W=128, 64 + 64
    samples, half RGB and half depth rays, float32, ``perturb=False``,
    ``raw_noise_std=0``; with ``semantic``, a 19-class semantic head on both
    MLPs and the semantic loss (lambda 0.04, the scene's labels); with
    ``sigma_loss``, the DS-NeRF sigma loss (lambda 0.1). The port's weights
    are converted from the JAX ones. Returns a dict of both sides' objects.

    Two choices keep the importance samples of both packages within float32
    noise of each other, so that the fine pass is compared at the same
    points. The inverse CDF divides by each bin's mass: on the seeded field
    bins hold as little as ~4e-5 of it, and a 1e-7 change of a coarse weight
    (float32 summation order) moves a sample by ~5e-4. So the coarse
    density head starts at zero weight and bias 0.8, a constant density
    that gives every bin at least ~4e-4 of the mass (it still trains);
    samples then move by ~2e-5. And the encodings use 4 and 2 octaves: at
    the default tenth octave (2^9 rad per unit) even a 2e-5 move changes the
    fine gradients by ~1e-1 of their mean."""
    import jax
    import torch

    from depth_lidar_nerf_tpu.train import config as jcfg
    from depth_lidar_nerf_tpu.train import state as jstate
    from depth_lidar_nerf_tpu.train import step as jstep
    from depth_lidar_nerf_tpu.train import tables as jtables
    from depth_lidar_nerf_tpu_torch.data.synthetic import draw_scene
    from depth_lidar_nerf_tpu_torch.train import config as tcfg
    from depth_lidar_nerf_tpu_torch.train import state as tstate
    from depth_lidar_nerf_tpu_torch.train import step as tstep
    from depth_lidar_nerf_tpu_torch.train import tables as ttables
    from depth_lidar_nerf_tpu_torch.weights import params_from_jax

    monkeypatch.setenv("DLNERF_PALLAS_INTERPRET", "1")
    sc = draw_scene(n_images=2, H=12, W=16, focal=14.0, n_depth_points=40,
                    seed=seed, backdrop=True,
                    num_classes=19 if semantic else None)
    H, W, focal = sc.hwf
    fields = dict(dataset_type="llff", N_rand=n_rand, N_samples=64,
                  N_importance=64, netdepth=4, netwidth=128,
                  netdepth_fine=netdepth_fine, sigma_loss=sigma_loss,
                  netwidth_fine=128, use_viewdirs=True, no_ndc=True,
                  perturb=0.0, raw_noise_std=0.0, colmap_depth=True,
                  depth_loss=True, depth_lambda=0.01, cull_eps=cull_eps,
                  multires=4, multires_views=2, semantic_loss=semantic,
                  semantic_lambda=0.04)
    n_cls = sc.num_classes if semantic else 0
    seg = sc.segmentation if semantic else None
    jc, tc = jcfg.TrainConfig(**fields), tcfg.TrainConfig(**fields)
    jr = jcfg.render_config_from(jc, n_cls, sc.near, sc.far)
    tr = tcfg.render_config_from(tc, n_cls, sc.near, sc.far)
    jm = jstate.build_models(jc, jr)
    js = jstate.init_train_state(jc, jr, jm, jax.random.key(seed))
    sigma = js.params["coarse"]["params"]["sigma"]
    sigma["kernel"] = sigma["kernel"] * 0.0
    sigma["bias"] = sigma["bias"] + 0.8
    js = js.replace(opt_state=jstate.make_optimizer(jc).init(js.params))
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
    return dict(
        jax_step=jstep.make_train_step(jc, jr, jm, sc.hwf), jax_state=js,
        jax_tables=(j_rgb, j_dep),
        port_step=tstep.make_train_step(tc, tr, tm, sc.hwf),
        port_state=tstate.init_train_state(tc, tm),
        port_tables=(ttables.build_rgb_table(sc.images, sc.poses, i_train, H,
                                             W, focal, tr, segmentation=seg,
                                             device=cpu),
                     ttables.build_depth_table(sc.depth_gts, sc.poses,
                                               i_train, H, W, focal, tr,
                                               device=cpu)),
        port_cfg=(tc, tr, sc.hwf), n_rgb=n_rand - n_rand // 2,
        n_depth=n_rand // 2)


def jax_step_indices(rng, n_rgb, n_depth, m_rgb, m_depth):
    """The ray indices JAX ``make_train_step`` draws from its step key:
    ``k_loss = split(rng, 3)[1]``, then ``split(k_loss, 8)[0:2]``."""
    import jax

    keys = jax.random.split(jax.random.split(rng, 3)[1], 8)
    idx = jax.random.randint(keys[0], (n_rgb,), 0, m_rgb)
    idx_d = jax.random.randint(keys[1], (n_depth,), 0, m_depth)
    return np.asarray(idx), np.asarray(idx_d)


def _jax_state_dicts(js):
    import jax

    from depth_lidar_nerf_tpu_torch.weights import params_from_jax

    adam = js.opt_state[0]
    return [params_from_jax(jax.tree.map(np.asarray, t))
            for t in (js.params, adam.mu, adam.nu)]


def three_steps_against_jax(monkeypatch, t, exempt_noise=False):
    """Three steps of both packages' steps from :func:`train_pair` ``t``, the
    port started from JAX's parameters and Adam moments before each; the
    metrics, parameters and moments compared after each (tolerances in
    ``tests/test_torch_port_train_step.py``). With ``exempt_noise``, a
    parameter element whose JAX gradient is under twice its gap to the
    port's (Adam's update of it then has no determined sign) is left out of
    the parameter comparison, at most 0.1% of the elements in a step; the
    gradients themselves are still compared, through the moments. Returns
    the backward routes each package ran."""
    import jax
    import torch

    import depth_lidar_nerf_tpu.ops.fused_mlp_t as jfmt
    from depth_lidar_nerf_tpu_torch.ops import fused_mlp_t as tfmt

    jcalls, tcalls = [], []
    spy_routes(monkeypatch, jfmt, jcalls)
    spy_routes(monkeypatch, tfmt, tcalls)
    js, ts = t["jax_state"], t["port_state"]
    j_rgb, j_dep = t["jax_tables"]
    nets = {"coarse": ts.models.coarse, "fine": ts.models.fine}
    opt = ts.optimizer
    for i in range(3):
        mu_prev = _jax_state_dicts(js)[1]
        if i:  # start the port's step from JAX's state
            params, mu, nu = _jax_state_dicts(js)
            with torch.no_grad():
                for net, m in nets.items():
                    for name, p in m.named_parameters():
                        p.copy_(params[net][name])
                        opt.state[p]["exp_avg"].copy_(mu[net][name])
                        opt.state[p]["exp_avg_sq"].copy_(nu[net][name])
        rng = jax.random.key(100 + i)
        idx, idx_d = jax_step_indices(rng, t["n_rgb"], t["n_depth"],
                                      j_rgb.origins.shape[0],
                                      j_dep.origins.shape[0])
        js, jm = t["jax_step"](js, j_rgb, j_dep, None, None, rng)
        tm = t["port_step"](ts, *t["port_tables"], idx=idx, idx_d=idx_d)
        assert set(tm) == set(jm)
        for k in jm:
            np.testing.assert_allclose(tm[k].item(), float(jm[k]), rtol=1e-4,
                                       err_msg=f"step {i} {k}")
        params, mu, nu = _jax_state_dicts(js)
        n_exempt = n_all = 0
        for net, m in nets.items():
            for name, p in m.named_parameters():
                keep = np.ones(p.shape, bool)
                if exempt_noise:
                    # Each package's gradient of this step, times 1 - b1.
                    gj = mu[net][name].numpy() - 0.9 * mu_prev[net][name].numpy()
                    gp = (opt.state[p]["exp_avg"].numpy()
                          - 0.9 * mu_prev[net][name].numpy())
                    keep = np.abs(gj) >= 2 * np.abs(gp - gj)
                    n_exempt += int((~keep).sum())
                n_all += p.numel()
                np.testing.assert_allclose(
                    p.detach().numpy()[keep],
                    params[net][name].numpy()[keep], rtol=1e-4, atol=2.5e-5,
                    err_msg=f"step {i} {net} {name}")
                for key, want in (("exp_avg", mu), ("exp_avg_sq", nu)):
                    w = want[net][name].numpy()
                    np.testing.assert_allclose(
                        opt.state[p][key].numpy(), w, rtol=1e-3,
                        atol=1e-3 * np.abs(w).max() + 1e-30,
                        err_msg=f"step {i} {net} {name} {key}")
        assert n_exempt <= 1e-3 * n_all, (i, n_exempt, n_all)
    assert ts.step == int(js.step) == 3
    return jcalls, tcalls
