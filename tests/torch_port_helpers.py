"""Shared inputs for the PyTorch-port parity tests (``test_torch_port_*``).

Inputs are made with numpy from a seed and handed to both packages; weights
are initialised by the Flax module and converted with ``params_from_jax``.
"""

import numpy as np


def interpret_pallas(monkeypatch, *modules):
    """Run every ``pl.pallas_call`` of ``modules`` in the Pallas interpreter,
    as ``tests/test_fused_mlp.py`` does."""
    import jax.experimental.pallas as pl

    orig = pl.pallas_call

    def patched(*a, **k):
        k["interpret"] = True
        return orig(*a, **k)

    for m in modules:
        monkeypatch.setattr(m.pl, "pallas_call", patched)


def flax_mlp_params(depth, width, seed=0, multires=10, multires_views=4,
                    skips=(4,)):
    """Flax ``NeRFMLP`` params as a numpy pytree."""
    import jax
    import jax.numpy as jnp

    from depth_lidar_nerf_tpu.models import NeRFMLP

    e_p, e_v = 3 + 6 * multires, 3 + 6 * multires_views
    model = NeRFMLP(depth=depth, width=width, in_channels=e_p,
                    in_channels_views=e_v, skips=skips, dtype=jnp.float32)
    params = model.init(jax.random.key(seed), jnp.zeros((1, e_p)),
                        jnp.zeros((1, e_v)))
    return model, jax.tree.map(np.asarray, params)


def ray_batch(N, S, seed=0):
    """Float32 numpy rays: origins, directions, unit viewdirs, sorted z."""
    rng = np.random.default_rng(seed)
    ro = rng.normal(size=(N, 3)).astype(np.float32)
    rd = rng.normal(size=(N, 3)).astype(np.float32)
    vd = (rd / np.linalg.norm(rd, axis=-1, keepdims=True)).astype(np.float32)
    z = np.sort(rng.uniform(2.0, 6.0, (N, S)), axis=-1).astype(np.float32)
    return ro, rd, vd, z


def look_at_pose(seed=0):
    """A forward-facing camera-to-world ``[3, 4]`` with a small random tilt."""
    rng = np.random.default_rng(seed)
    a, b = rng.uniform(-0.2, 0.2, 2)
    ca, sa, cb, sb = np.cos(a), np.sin(a), np.cos(b), np.sin(b)
    rx = np.array([[1, 0, 0], [0, ca, -sa], [0, sa, ca]])
    ry = np.array([[cb, 0, sb], [0, 1, 0], [-sb, 0, cb]])
    t = rng.uniform(-0.1, 0.1, (3, 1))
    return np.concatenate([rx @ ry, t], axis=1).astype(np.float32)


def fused_pair(monkeypatch, depth, width, S, dtype, N=8, seed=0):
    """Kernel 1: JAX ``fused_nerf_apply_rays`` (Pallas interpreter) and the
    port's plain version on the same rays and converted weights, ``dtype``
    "float32" or "bfloat16". Returns (jax raw, port raw), each [4, N, S]."""
    import jax.numpy as jnp
    import torch

    import depth_lidar_nerf_tpu.ops.fused_mlp as fm
    import depth_lidar_nerf_tpu.ops.fused_mlp_t as fmt
    from depth_lidar_nerf_tpu_torch.ops import fused_mlp_t as tfmt
    from depth_lidar_nerf_tpu_torch.weights import mlp_state_dict

    interpret_pallas(monkeypatch, fm, fmt)
    _, params = flax_mlp_params(depth, width, seed=seed)
    ro, rd, vd, z = ray_batch(N, S, seed=seed + 1)
    kw = dict(depth=depth, width=width, multires=10, multires_views=4,
              skips=(4,))
    ref = np.asarray(fmt.fused_nerf_apply_rays(
        params, ro, rd, vd, z, dtype=getattr(jnp, dtype), **kw))
    sd = mlp_state_dict(params)
    with torch.no_grad():
        got = tfmt.fused_nerf_apply_rays(
            sd, torch.from_numpy(ro), torch.from_numpy(rd),
            torch.from_numpy(vd), torch.from_numpy(z),
            dtype=getattr(torch, dtype), **kw).numpy()
    return ref, got


def render_pair(monkeypatch, use_pallas_sampling):
    """The slice as a whole: JAX and port renderers built by ``build_models``
    from the same config (coarse D=4, fine D=8 skip@4, W=128, NDC, f32), the
    port's weights converted from the JAX ones. Returns (jax_models,
    jax_params, jax_rcfg, port_models, port_rcfg)."""
    import dataclasses

    import jax
    import jax.numpy as jnp

    from depth_lidar_nerf_tpu.train import config as jcfg
    from depth_lidar_nerf_tpu.train.state import build_models as jbuild
    from depth_lidar_nerf_tpu_torch.train import config as tcfg
    from depth_lidar_nerf_tpu_torch.train.state import build_models as tbuild
    from depth_lidar_nerf_tpu_torch.weights import params_from_jax

    monkeypatch.setenv("DLNERF_PALLAS_INTERPRET", "1")
    fields = dict(netdepth=4, netdepth_fine=8, netwidth=128,
                  netwidth_fine=128, N_samples=64, N_importance=64,
                  use_viewdirs=True, dataset_type="llff",
                  use_pallas_sampling=use_pallas_sampling)
    jc = jcfg.TrainConfig(**fields)
    jr = jcfg.render_config_from(jc, 0, 0.0, 1.0).eval_mode()
    jm = jbuild(jc, jr)
    pe, ve = jnp.zeros((1, 63)), jnp.zeros((1, 27))
    params = {"coarse": jm.coarse.init(jax.random.key(0), pe, ve),
              "fine": jm.fine.init(jax.random.key(1), pe, ve)}
    # Random init gives near-transparent fields; a larger sigma bias makes
    # the weights (and so the importance samples) depend on the field.
    for k in ("coarse", "fine"):
        sig = params[k]["params"]["sigma"]
        sig["bias"] = sig["bias"] + 2.0
    params = jax.tree.map(np.asarray, params)

    tc = tcfg.TrainConfig(**fields)
    tr = tcfg.render_config_from(tc, 0, 0.0, 1.0).eval_mode()
    assert dataclasses.asdict(tr) == {
        k: v for k, v in dataclasses.asdict(jr).items()
        if k in dataclasses.asdict(tr)}
    tm = tbuild(tc, tr, device="cpu")
    sds = params_from_jax(params)
    tm.coarse.load_state_dict(sds["coarse"])
    tm.fine.load_state_dict(sds["fine"])
    return jm, params, jr, tm, tr


def assert_render_close(ref, got, keys):
    """rgb/acc/depth/weights at rtol 1e-4 / atol 1e-5; disp where acc > 1e-3."""
    for k in keys:
        a, b = np.asarray(ref[k]), got[k].numpy()
        assert a.shape == b.shape, (k, a.shape, b.shape)
        if k.startswith("disp"):
            acc = np.asarray(ref["acc_map" if k == "disp_map" else "acc0"])
            a, b = a[acc > 1e-3], b[acc > 1e-3]
        np.testing.assert_allclose(b, a, rtol=1e-4, atol=1e-5, err_msg=k)
