"""Shared inputs for the PyTorch-port training parity tests
(``test_torch_port_train_*``).

JAX runs its Pallas kernels in the interpreter; inputs are made with numpy
from a seed and handed to both packages, weights converted from the Flax
pytrees with ``params_from_jax``.
"""

import numpy as np

from torch_port_helpers import flax_mlp_params, interpret_pallas, ray_batch

ROUTE_FNS = ("_bwd_dense_dparams", "_bwd_culled_dparams", "_bwd_acts_dparams")


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


def train_pair(monkeypatch, cull_eps, n_rand=64, seed=0):
    """Both packages' base training step on the same tiny synthetic scene:
    coarse D=4 / fine D=8 skip@4 / W=128, 64 + 64 samples, half RGB and half
    depth rays, float32, ``perturb=False``, ``raw_noise_std=0``. The port's
    weights are converted from the JAX ones. Returns a dict of both sides'
    objects.

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
                    seed=seed, backdrop=True)
    H, W, focal = sc.hwf
    fields = dict(dataset_type="llff", N_rand=n_rand, N_samples=64,
                  N_importance=64, netdepth=4, netwidth=128, netdepth_fine=8,
                  netwidth_fine=128, use_viewdirs=True, no_ndc=True,
                  perturb=0.0, raw_noise_std=0.0, colmap_depth=True,
                  depth_loss=True, depth_lambda=0.01, cull_eps=cull_eps,
                  multires=4, multires_views=2)
    jc, tc = jcfg.TrainConfig(**fields), tcfg.TrainConfig(**fields)
    jr = jcfg.render_config_from(jc, 0, sc.near, sc.far)
    tr = tcfg.render_config_from(tc, 0, sc.near, sc.far)
    jm = jstate.build_models(jc, jr)
    js = jstate.init_train_state(jc, jr, jm, jax.random.key(seed))
    sigma = js.params["coarse"]["params"]["sigma"]
    sigma["kernel"] = sigma["kernel"] * 0.0
    sigma["bias"] = sigma["bias"] + 0.8
    js = js.replace(opt_state=jstate.make_optimizer(jc).init(js.params))
    i_train = np.arange(2)
    j_rgb = jtables.build_rgb_table(sc.images, sc.poses, i_train, H, W, focal,
                                    jr)
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
                                             W, focal, tr, device=cpu),
                     ttables.build_depth_table(sc.depth_gts, sc.poses,
                                               i_train, H, W, focal, tr,
                                               device=cpu)),
        n_rgb=n_rand - n_rand // 2, n_depth=n_rand // 2)


def jax_step_indices(rng, n_rgb, n_depth, m_rgb, m_depth):
    """The ray indices JAX ``make_train_step`` draws from its step key:
    ``k_loss = split(rng, 3)[1]``, then ``split(k_loss, 8)[0:2]``."""
    import jax

    keys = jax.random.split(jax.random.split(rng, 3)[1], 8)
    idx = jax.random.randint(keys[0], (n_rgb,), 0, m_rgb)
    idx_d = jax.random.randint(keys[1], (n_depth,), 0, m_depth)
    return np.asarray(idx), np.asarray(idx_d)
