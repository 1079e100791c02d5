"""Shared inputs for the PyTorch-port semantic parity tests
(``test_torch_port_semantic_*``).

JAX runs its semantic Pallas kernels (``_fwd_kernel_sem_only``,
``_fwd_kernel_acts_sem``, ``_bwd_kernel_acts_sem``) in the interpreter;
inputs are made with numpy from a seed and handed to both packages, weights
converted from the Flax pytrees with ``params_from_jax``.
"""

import numpy as np

from torch_port_helpers import interpret_pallas, ray_batch


def flax_sem_params(depth, width, n_classes, seed=0, skips=(4,)):
    """Flax ``NeRFMLP`` params with a semantic head, as a numpy pytree.
    Flax initialises every bias to zero; they are drawn here instead, so
    that the head's biases (scaled by S in the ray sum) take part."""
    import jax
    import jax.numpy as jnp

    from depth_lidar_nerf_tpu.models import NeRFMLP

    model = NeRFMLP(depth=depth, width=width, in_channels=63,
                    in_channels_views=27, skips=skips,
                    num_semantic_classes=n_classes, dtype=jnp.float32)
    params = jax.tree.map(np.asarray, model.init(
        jax.random.key(seed), jnp.zeros((1, 63)), jnp.zeros((1, 27))))
    rng = np.random.default_rng(seed + 100)
    for name, layer in params["params"].items():
        layer["bias"] = (0.1 * rng.normal(size=layer["bias"].shape)
                         ).astype(np.float32)
    params["params"]["sigma"]["bias"] += 0.5
    return model, params


def sem_cotangents(N, S, n_classes, seed):
    """A raw cotangent ``[4, N, S]`` and a logit cotangent ``[N, C]`` that
    is zero on the second half of the rays (the step's depth rays carry no
    semantic loss)."""
    rng = np.random.default_rng(seed)
    g = rng.normal(size=(4, N, S)).astype(np.float32)
    gsem = rng.normal(size=(N, n_classes)).astype(np.float32)
    gsem[N // 2:] = 0.0
    return g, gsem


def jax_semantic(monkeypatch, depth, width, n_classes, S, dtype, N=8, seed=0):
    """JAX ``fused_nerf_apply_rays_semantic`` (Pallas interpreter): raw,
    logits, and the parameter gradients for :func:`sem_cotangents` as the
    port's parameter mapping; also the Flax params, rays and cotangents."""
    import jax
    import jax.numpy as jnp

    import depth_lidar_nerf_tpu.ops.fused_mlp as fm
    import depth_lidar_nerf_tpu.ops.fused_mlp_t as fmt
    from depth_lidar_nerf_tpu_torch.weights import mlp_state_dict

    interpret_pallas(monkeypatch, fm, fmt)
    _, params = flax_sem_params(depth, width, n_classes, seed=seed)
    rays = ray_batch(N, S, seed=seed + 1)
    g, gsem = sem_cotangents(N, S, n_classes, seed + 2)

    def f(p):
        return fmt.fused_nerf_apply_rays_semantic(
            p, *rays, depth=depth, width=width, multires=10,
            multires_views=4, dtype=getattr(jnp, dtype), skips=(4,))

    (raw, sem), vjp = jax.vjp(f, params)
    (grads,) = vjp((jnp.asarray(g), jnp.asarray(gsem)))
    return dict(raw=np.asarray(raw), sem=np.asarray(sem),
                grads=mlp_state_dict(jax.tree.map(np.asarray, grads)),
                params=params, rays=rays, g=g, gsem=gsem)


def port_inputs(params, rays):
    """The converted weights, the rays as tensors, and the kernels' inputs
    ``pts_t [3, N S]`` and ``vd_t [3, N]``."""
    import torch

    from depth_lidar_nerf_tpu_torch.weights import mlp_state_dict

    ro, rd, vd, z = (torch.from_numpy(a) for a in rays)
    N, S = z.shape
    pts_t = (ro.T[:, :, None] + rd.T[:, :, None] * z[None]).reshape(3, N * S)
    return mlp_state_dict(params), (ro, rd, vd, z), pts_t, vd.T.contiguous()


def sem_render_pair(monkeypatch):
    """JAX and port models built by ``build_models`` from one semantic config
    (coarse D=4, fine D=8 skip@4, W=128, 19 classes, f32, NDC off), the
    port's weights converted from JAX's."""
    import jax

    from depth_lidar_nerf_tpu.train import config as jcfg
    from depth_lidar_nerf_tpu.train.state import build_models as jbuild
    from depth_lidar_nerf_tpu_torch.train import config as tcfg
    from depth_lidar_nerf_tpu_torch.train.state import build_models as tbuild
    from depth_lidar_nerf_tpu_torch.weights import params_from_jax

    import depth_lidar_nerf_tpu.ops.fused_mlp as fm
    import depth_lidar_nerf_tpu.ops.fused_mlp_t as fmt

    monkeypatch.setenv("DLNERF_PALLAS_INTERPRET", "1")
    interpret_pallas(monkeypatch, fm, fmt)
    fields = dict(netdepth=4, netdepth_fine=8, netwidth=128,
                  netwidth_fine=128, N_samples=64, N_importance=64,
                  use_viewdirs=True, dataset_type="llff", no_ndc=True,
                  semantic_loss=True)
    jc, tc = jcfg.TrainConfig(**fields), tcfg.TrainConfig(**fields)
    jr = jcfg.render_config_from(jc, 19, 2.0, 6.0).eval_mode()
    tr = tcfg.render_config_from(tc, 19, 2.0, 6.0).eval_mode()
    jm = jbuild(jc, jr)
    tm = tbuild(tc, tr, device="cpu")
    _, pc = flax_sem_params(4, 128, 19, seed=0)
    _, pf = flax_sem_params(8, 128, 19, seed=1)
    params = {"coarse": pc, "fine": pf}
    sds = params_from_jax(params)
    tm.coarse.load_state_dict(sds["coarse"])
    tm.fine.load_state_dict(sds["fine"])
    return jm, jax.tree.map(np.asarray, params), jr, tm, tr
