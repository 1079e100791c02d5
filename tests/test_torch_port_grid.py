"""Grid training and baked-density-grid serving in the port, on the CPU
against the JAX package (``ops/ray_cdf.py``, ``ops/density_grid.py``, the
renderer's grid branch, the grid step and the driver's bakes), with the
``linspace`` and Adam repairs they needed.

Tolerances. The det ``t_vals``, the det draws ``u`` and ``cdf_z_grid`` bit
for bit. The baked weights: float32 at rtol 1e-4 / atol 1e-6 (the plain
module against Flax, or the kernel twin against JAX's interpreted kernel),
the bfloat16 rows within one bfloat16 ulp. ``frustum_bounds`` bit for bit;
``grid_bounds_for_poses`` at rtol 1e-6 (the rays' float32 formulas, NDC
included, agree to an ulp). The 3-D bake at rtol 1e-4 / atol 1e-5 (its axes
agree with JAX's within one float32 ulp: XLA compiles ``jnp.linspace`` into
a reassociated product and a fused multiply-add); ``trilinear_sigma`` at
rtol 1e-6. Renders as ``assert_render_close`` (rtol 1e-4, atol 1e-5). Grid
steps as ``tests/test_torch_port_train_step.py``. The driver's
``--render_only`` frames at the serving tests' float32 limits.
"""

import dataclasses
import os

import numpy as np
import pytest
import torch

from torch_port_helpers import assert_render_close, render_pair
from torch_port_train_helpers import _jax_state_dicts, jax_step_indices

S_VALUES = (16, 33, 64, 128, 192)


# ---------------------------------------------------------------- linspace


@pytest.mark.parametrize("lindisp", [False, True])
@pytest.mark.parametrize("S", S_VALUES)
def test_det_t_vals_u_and_cdf_grid_equal_jax(S, lindisp):
    """The stratified depths without jitter, the det draws and the bake
    grid equal JAX's bit for bit (``torch.linspace`` misses in the last bit
    at 30 of 64 entries). JAX computes the depths under ``jit``, as its
    renders and steps do (XLA fuses them into a multiply-add); the bake
    grid of a ``RayCDF`` eagerly, as ``bake_ray_cdf`` does."""
    import jax
    import jax.numpy as jnp

    from depth_lidar_nerf_tpu.ops import ray_cdf as jcdf
    from depth_lidar_nerf_tpu.ops import sampling as jsamp
    from depth_lidar_nerf_tpu.render.renderer import RenderConfig as JRcfg
    from depth_lidar_nerf_tpu_torch.ops import ray_cdf, sampling
    from depth_lidar_nerf_tpu_torch.render.renderer import RenderConfig

    rng = np.random.default_rng(S)
    near = rng.uniform(0.1, 1.0, (7, 1)).astype(np.float32)
    far = (near + rng.uniform(1.0, 5.0, (7, 1))).astype(np.float32)
    ref = np.asarray(jax.jit(lambda a, b: jsamp.stratified_z_vals(
        a, b, S, lindisp=lindisp, perturb=False))(near, far))
    got = sampling.stratified_z_vals(torch.from_numpy(near),
                                     torch.from_numpy(far), S,
                                     lindisp=lindisp, perturb=False)
    assert np.array_equal(got.numpy(), ref)
    u = sampling.pdf_uniforms(3, S, det=True, generator=None, device="cpu")
    assert np.array_equal(u.numpy(), np.broadcast_to(
        np.asarray(jnp.linspace(0.0, 1.0, S, dtype=jnp.float32)), (3, S)))
    kw = dict(near=float(near[0, 0]), far=float(far[0, 0]), lindisp=lindisp)
    assert np.array_equal(ray_cdf.cdf_z_grid(RenderConfig(**kw), S).numpy(),
                          np.asarray(jcdf.cdf_z_grid(JRcfg(**kw), S)))


# ------------------------------------------------------------- bake helpers


def _scene_tables(rcfg_j, rcfg_t, n_images=2, H=12, W=16):
    """Both packages' ray tables of one seeded in-memory scene."""
    from depth_lidar_nerf_tpu.train import tables as jtables
    from depth_lidar_nerf_tpu_torch.data.synthetic import draw_scene
    from depth_lidar_nerf_tpu_torch.train import tables as ttables

    sc = draw_scene(n_images=n_images, H=H, W=W, focal=14.0,
                    n_depth_points=40, seed=0, backdrop=True)
    it = np.arange(n_images)
    j = (jtables.build_rgb_table(sc.images, sc.poses, it, H, W, 14.0, rcfg_j),
         jtables.build_depth_table(sc.depth_gts, sc.poses, it, H, W, 14.0,
                                   rcfg_j))
    t = (ttables.build_rgb_table(sc.images, sc.poses, it, H, W, 14.0, rcfg_t,
                                 device="cpu"),
         ttables.build_depth_table(sc.depth_gts, sc.poses, it, H, W, 14.0,
                                   rcfg_t, device="cpu"))
    return sc, j, t


def _small_models(fused, semantic=0, **kw):
    """Both packages' coarse and fine D=2 / W=32 MLPs (float32, no NDC,
    multires 6/2), the port's weights converted from JAX's; the sigma bias
    raised so that the field is not transparent. With ``fused``, JAX's
    kernels run in the Pallas interpreter (DLNERF_PALLAS_INTERPRET set by
    the caller) and the port builds ``FusedMLP``; else both run the plain
    module."""
    import jax

    from depth_lidar_nerf_tpu.train import config as jcfg
    from depth_lidar_nerf_tpu.train import state as jstate
    from depth_lidar_nerf_tpu_torch.train import config as tcfg
    from depth_lidar_nerf_tpu_torch.train import state as tstate
    from depth_lidar_nerf_tpu_torch.weights import params_from_jax

    fields = dict(dataset_type="llff", no_ndc=True, N_samples=16,
                  N_importance=16, netdepth=2, netwidth=32, netdepth_fine=2,
                  netwidth_fine=32, use_viewdirs=True, multires=6,
                  multires_views=2, use_fused_mlp=fused)
    fields.update(kw)
    jc, tc = jcfg.TrainConfig(**fields), tcfg.TrainConfig(**fields)
    jr = jcfg.render_config_from(jc, semantic, 2.0, 6.0)
    tr = tcfg.render_config_from(tc, semantic, 2.0, 6.0)
    jm = jstate.build_models(jc, jr)
    js = jstate.init_train_state(jc, jr, jm, jax.random.key(0))
    params = jax.tree.map(np.asarray, js.params)
    for k in ("coarse", "fine"):
        sig = params[k]["params"]["sigma"]
        sig["bias"] = sig["bias"] + 1.5
    tm = tstate.build_models(tc, tr, device="cpu")
    sds = params_from_jax(params)
    tm.coarse.load_state_dict(sds["coarse"])
    tm.fine.load_state_dict(sds["fine"])
    return jm, params, jr, tm, tr


def _bf16_bits(x):
    """bfloat16 values as their 16-bit patterns (int)."""
    if isinstance(x, torch.Tensor):
        return x.view(torch.int16).numpy().astype(np.int64)
    return np.asarray(x).view(np.int16).astype(np.int64)


# --------------------------------------------------------------- ray CDFs


@pytest.mark.parametrize("fused", [False, True])
def test_bake_table_weights_match_jax(monkeypatch, fused):
    """``bake_table_weights`` over a table whose ray count is not a
    multiple of the chunk (384 rays in chunks of 100; JAX pads the last
    chunk): float32 weights before the cast within rtol 1e-4, the bfloat16
    rows within one bfloat16 ulp of JAX's. With ``fused``, the route of an
    eval render: kernel 1's twin against JAX's interpreted kernel."""
    import jax.numpy as jnp

    from depth_lidar_nerf_tpu.ops import ray_cdf as jcdf
    from depth_lidar_nerf_tpu.render import renderer as jrend
    from depth_lidar_nerf_tpu_torch.ops import ray_cdf
    from depth_lidar_nerf_tpu_torch.render import renderer as trend

    if fused:
        monkeypatch.setenv("DLNERF_PALLAS_INTERPRET", "1")
    jm, params, jr, tm, tr = _small_models(fused)
    _, (j_rgb, _), (t_rgb, _) = _scene_tables(jr, tr)
    S = 32
    assert t_rgb.origins.shape[0] % 100 and t_rgb.origins.shape[0] > 300
    ref = jcdf.bake_table_weights(jm.fine, params["fine"], jr, j_rgb.origins,
                                  j_rgb.directions, j_rgb.viewdirs, S,
                                  chunk=100)
    got = ray_cdf.bake_table_weights(tm.fine, tr, t_rgb.origins,
                                     t_rgb.directions, t_rgb.viewdirs, S,
                                     chunk=100)
    assert got.dtype == torch.bfloat16 and got.shape == tuple(ref.shape)
    assert np.abs(_bf16_bits(got) - _bf16_bits(ref)).max() <= 1
    # The float32 weights the rows were cast from.
    n = t_rgb.origins.shape[0]
    jrb = dataclasses.replace(jr.eval_mode(), cull_eps=0.0)
    trb = dataclasses.replace(tr.eval_mode(), cull_eps=0.0)
    z = ray_cdf.cdf_z_grid(trb, S)
    near, far = np.full((n, 1), 2.0, np.float32), np.full((n, 1), 6.0,
                                                          np.float32)
    jrays = jrend.Rays(j_rgb.origins, j_rgb.directions, j_rgb.viewdirs,
                       jnp.asarray(near), jnp.asarray(far))
    w_ref = np.asarray(jrend._composite_from_z(
        jm.fine, params["fine"], jrays,
        jnp.broadcast_to(jcdf.cdf_z_grid(jrb, S), (n, S)), jrb, None).weights)
    trays = trend.Rays(t_rgb.origins, t_rgb.directions, t_rgb.viewdirs,
                       torch.from_numpy(near), torch.from_numpy(far))
    with torch.no_grad():
        w_got = trend._composite_from_z(tm.fine, trays, z.expand(n, S), trb,
                                        None).weights
    assert w_ref.max() > 0.05  # the field is not transparent
    np.testing.assert_allclose(w_got.numpy(), w_ref, rtol=1e-4, atol=1e-6)
    assert torch.equal(got, w_got.to(torch.bfloat16))


@pytest.mark.parametrize("with_depth", [True, False])
def test_bake_ray_cdf_matches_jax(with_depth):
    """``bake_ray_cdf`` from the fine model over both tables (or the rgb
    table alone): rows within one bfloat16 ulp, the z grid bit for bit."""
    from depth_lidar_nerf_tpu.ops import ray_cdf as jcdf
    from depth_lidar_nerf_tpu_torch.ops import ray_cdf

    jm, params, jr, tm, tr = _small_models(False)
    _, (j_rgb, j_dep), (t_rgb, t_dep) = _scene_tables(jr, tr)
    S = 24
    ref = jcdf.bake_ray_cdf(jm, params, jr, j_rgb,
                            j_dep if with_depth else None, S)
    got = ray_cdf.bake_ray_cdf(tm, tr, t_rgb, t_dep if with_depth else None,
                               S)
    assert np.array_equal(got.z.numpy(), np.asarray(ref.z))
    assert np.abs(_bf16_bits(got.w_rgb) - _bf16_bits(ref.w_rgb)).max() <= 1
    if with_depth:
        assert got.w_depth.shape == tuple(ref.w_depth.shape)
        assert np.abs(_bf16_bits(got.w_depth)
                      - _bf16_bits(ref.w_depth)).max() <= 1
    else:
        assert got.w_depth is None and ref.w_depth is None


def test_bake_of_a_semantic_model_takes_the_plain_module(monkeypatch):
    """A model with a semantic head is baked with ``num_semantic_classes=0``
    through the plain module, never the rgb kernel (which refuses its
    packing), as JAX's bake takes Flax; rows within one bfloat16 ulp."""
    from depth_lidar_nerf_tpu.ops import ray_cdf as jcdf
    from depth_lidar_nerf_tpu_torch.ops import fused_mlp_t, ray_cdf

    monkeypatch.setenv("DLNERF_PALLAS_INTERPRET", "1")
    jm, params, jr, tm, tr = _small_models(True, semantic=5)
    _, (j_rgb, _), (t_rgb, _) = _scene_tables(jr, tr)
    fused_mlp_t.fused_nerf_apply_rays.last_route = None
    calls = []
    orig = type(tm.fine).forward
    monkeypatch.setattr(type(tm.fine), "forward",
                        lambda self, *a: calls.append(1) or orig(self, *a))
    got = ray_cdf.bake_table_weights(tm.fine, tr, t_rgb.origins,
                                     t_rgb.directions, t_rgb.viewdirs, 16)
    assert calls and fused_mlp_t.fused_nerf_apply_rays.last_route is None
    ref = jcdf.bake_table_weights(jm.fine, params["fine"], jr, j_rgb.origins,
                                  j_rgb.directions, j_rgb.viewdirs, 16)
    assert np.abs(_bf16_bits(got) - _bf16_bits(ref)).max() <= 1


# ------------------------------------------------------------ 3-D grids


def test_frustum_bounds_equal_jax():
    from depth_lidar_nerf_tpu.ops.density_grid import frustum_bounds as jfb
    from depth_lidar_nerf_tpu_torch.ops.density_grid import frustum_bounds

    rng = np.random.default_rng(0)
    o = rng.normal(size=(40, 3)).astype(np.float32)
    d = rng.normal(size=(40, 3)).astype(np.float32)
    for near, far in ((0.0, 1.0), (2.0, 6.0)):
        for a, b in zip(frustum_bounds(o, d, near, far),
                        jfb(o, d, near, far)):
            assert a.dtype == np.float32 and np.array_equal(a, b)


@pytest.mark.parametrize("ndc", [False, True])
def test_grid_bounds_for_poses_match_jax(ndc):
    """The corner and centre rays of every pose, NDC-warped or not, with a
    render factor."""
    from depth_lidar_nerf_tpu.render.renderer import RenderConfig as JRcfg
    from depth_lidar_nerf_tpu.train.loop import grid_bounds_for_poses as jgb
    from depth_lidar_nerf_tpu_torch.render.renderer import RenderConfig
    from depth_lidar_nerf_tpu_torch.train.loop import grid_bounds_for_poses
    from torch_port_helpers import look_at_pose

    poses = np.stack([look_at_pose(s) for s in range(4)])
    kw = dict(ndc=ndc, near=0.0 if ndc else 2.0, far=1.0 if ndc else 6.0)
    for factor in (0, 2):
        got = grid_bounds_for_poses(RenderConfig(**kw), poses,
                                    (24, 32, 30.0), factor)
        ref = jgb(JRcfg(**kw), poses, (24, 32, 30.0), factor)
        for a, b in zip(got, ref):
            np.testing.assert_allclose(a, np.asarray(b), rtol=1e-6, atol=0)


def test_bake_density_grid_matches_jax():
    """R = 17 in chunks of 1,000 points (below R^3 = 4,913): the fine
    model's raw sigma, and the bounds passed through."""
    import jax.numpy as jnp

    from depth_lidar_nerf_tpu.ops.density_grid import bake_density_grid as jb
    from depth_lidar_nerf_tpu_torch.ops.density_grid import bake_density_grid

    jm, params, jr, tm, tr = _small_models(False)
    lo = np.array([-1.5, -1.0, -6.0], np.float32)
    hi = np.array([1.25, 1.0, -2.0], np.float32)
    ref, jlo, jhi = jb(jm.fine, params["fine"], jr, lo, hi, 17, chunk=1000)
    grid, tlo, thi = bake_density_grid(tm.fine, tr, lo, hi, 17, chunk=1000)
    assert grid.shape == (17, 17, 17) and grid.dtype == torch.float32
    assert np.array_equal(tlo.numpy(), lo) and np.array_equal(thi.numpy(), hi)
    np.testing.assert_allclose(grid.numpy(), np.asarray(ref), rtol=1e-4,
                               atol=1e-5)
    # Each axis within one float32 ulp of jnp.linspace's, ends exact.
    from depth_lidar_nerf_tpu_torch.ops.sampling import unit_linspace

    t = unit_linspace(17)
    for i in range(3):
        ax = (torch.tensor(lo[i]) * (1.0 - t) + torch.tensor(hi[i]) * t).numpy()
        jax_ax = np.asarray(jnp.linspace(lo[i], hi[i], 17, dtype=jnp.float32))
        assert ax[0] == lo[i] and ax[-1] == hi[i]
        assert np.all(np.abs(ax - jax_ax) <= np.spacing(np.abs(jax_ax)))


def test_trilinear_sigma_matches_jax():
    """Inside, on and beyond the bounds (clamped to the boundary voxels)."""
    import jax.numpy as jnp

    from depth_lidar_nerf_tpu.ops.density_grid import trilinear_sigma as jts
    from depth_lidar_nerf_tpu_torch.ops.density_grid import trilinear_sigma

    rng = np.random.default_rng(1)
    grid = rng.normal(size=(9, 9, 9)).astype(np.float32)
    lo = np.array([-1.0, -2.0, 0.5], np.float32)
    hi = np.array([1.0, 0.0, 3.0], np.float32)
    pts = rng.uniform(lo - 0.7, hi + 0.7, (50, 6, 3)).astype(np.float32)
    pts[0, :2] = lo
    pts[0, 2:4] = hi
    out = (np.abs(pts - (lo + hi) / 2) > (hi - lo) / 2).any(-1)
    assert 0.1 < out.mean() < 0.9  # both kinds of points
    got = trilinear_sigma(*(torch.from_numpy(a) for a in (grid, lo, hi, pts)))
    ref = np.asarray(jts(*(jnp.asarray(a) for a in (grid, lo, hi, pts))))
    assert got.shape == (50, 6)
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-6, atol=1e-7)


# ----------------------------------------------------------- grid serving


def _serving_pair(monkeypatch, R=12):
    """``render_pair``'s stacks (coarse D=4, fine D=8 skip@4, W=128, NDC,
    float32) with a grid JAX baked from the fine model over the NDC
    frustum, handed to both as numpy."""
    import jax.numpy as jnp

    from depth_lidar_nerf_tpu.ops.density_grid import bake_density_grid

    jm, params, jr, tm, tr = render_pair(monkeypatch, False)
    lo = np.array([-1.1, -1.1, -1.05], np.float32)
    hi = np.array([1.1, 1.1, 1.05], np.float32)
    g, _, _ = bake_density_grid(jm.fine, params["fine"], jr, lo, hi, R)
    g = np.array(g)
    jgrid = (jnp.asarray(g), jnp.asarray(lo), jnp.asarray(hi))
    tgrid = tuple(torch.from_numpy(a) for a in (g, lo, hi))
    return jm, params, jr, tm, tr, jgrid, tgrid


def _ndc_rays(N, seed=3):
    from torch_port_helpers import ray_batch

    ro, rd, vd, _ = ray_batch(N, 4, seed=seed)
    ro = ro * 0.3
    rd = np.stack([rd[:, 0] * 0.3, rd[:, 1] * 0.3, np.full(N, 2.0)],
                  -1).astype(np.float32)
    ro[:, 2] = -1.0
    return (ro, rd, vd, np.zeros((N, 1), np.float32),
            np.ones((N, 1), np.float32))


@pytest.mark.parametrize("mode", ["union", "fine_only", "samples"])
def test_render_rays_grid_matches_jax(monkeypatch, mode):
    """``render_rays`` with a grid against JAX's with
    ``params["density_grid"]``, det draws, float32: the union of 64
    stratified and 64 importance samples, ``render_grid_fine_only``, and
    ``render_grid_samples`` 96 with fine-only. The coarse MLP never runs
    (a spy), and the grid's coarse pass is black (rgb0)."""
    import jax.numpy as jnp

    from depth_lidar_nerf_tpu.render import renderer as jrend
    from depth_lidar_nerf_tpu_torch.render import renderer as trend

    jm, params, jr, tm, tr, jgrid, tgrid = _serving_pair(monkeypatch)
    kw = dict(render_grid=12, render_grid_fine_only=mode != "union",
              render_grid_samples=96 if mode == "samples" else 0)
    jc, tc = (dataclasses.replace(c, **kw) for c in (jr, tr))
    rays = _ndc_rays(16)
    ref = jrend.render_rays(jm.coarse, jm.fine,
                            {**params, "density_grid": jgrid},
                            jrend.Rays(*(jnp.asarray(a) for a in rays)), jc)
    seen = []
    orig = trend._composite_from_z
    monkeypatch.setattr(trend, "_composite_from_z",
                        lambda m, *a, **k: seen.append(m) or orig(m, *a, **k))
    with torch.no_grad():
        got = trend.render_rays(tm.coarse, tm.fine,
                                trend.Rays(*(torch.from_numpy(a)
                                             for a in rays)), tc,
                                density_grid=tgrid)
    assert seen == [tm.fine]
    assert set(got) == set(ref)
    s_fine = 64 if mode != "union" else 128
    assert got["weights"].shape == (16, s_fine)
    assert np.asarray(ref["acc0"]).max() > 0.1  # the grid is not empty
    assert got["rgb0"].max() < 1e-8
    assert_render_close(ref, got, ("rgb_map", "acc_map", "depth_map",
                                   "disp_map", "weights", "rgb0", "acc0",
                                   "depth_map0", "z_std"))


def test_render_grid_zero_ignores_the_grid(monkeypatch):
    """``render_grid = 0`` (or no fine pass) renders as without a grid."""
    from depth_lidar_nerf_tpu_torch.render import renderer as trend

    _, _, _, tm, tr, _, tgrid = _serving_pair(monkeypatch)
    rays = trend.Rays(*(torch.from_numpy(a) for a in _ndc_rays(8)))
    with torch.no_grad():
        plain = trend.render_rays(tm.coarse, tm.fine, rays, tr)
        got = trend.render_rays(tm.coarse, tm.fine, rays,
                                dataclasses.replace(tr, render_grid_fine_only=True),
                                density_grid=tgrid)
        coarse_only = dataclasses.replace(tr, N_importance=0, render_grid=12)
        a = trend.render_rays(tm.coarse, None, rays, coarse_only)
        b = trend.render_rays(tm.coarse, None, rays, coarse_only,
                              density_grid=tgrid)
    for k in plain:
        assert torch.equal(got[k], plain[k]), k
    for k in a:
        assert torch.equal(a[k], b[k]), k


def test_render_image_with_a_grid_skips_the_downsampled_route(monkeypatch):
    """A grid frame with ``render_coarse_downsample`` set renders every
    pixel through the grid, as JAX's ``render_image`` does."""
    import jax.numpy as jnp

    from depth_lidar_nerf_tpu.render import renderer as jrend
    from depth_lidar_nerf_tpu_torch.render import renderer as trend
    from torch_port_helpers import look_at_pose

    jm, params, jr, tm, tr, jgrid, tgrid = _serving_pair(monkeypatch)
    kw = dict(render_grid=12, render_grid_fine_only=True,
              render_coarse_downsample=2)
    jc, tc = (dataclasses.replace(c, **kw) for c in (jr, tr))
    called = []
    monkeypatch.setattr(trend, "render_image_coarse_downsampled",
                        lambda *a, **k: called.append(1))
    c2w = look_at_pose(2)
    got = trend.render_image(tm.coarse, tm.fine, 6, 8, 7.0, c2w, tc,
                             device="cpu", density_grid=tgrid)
    assert not called
    ref = jrend.render_image(jm.coarse, jm.fine,
                             {**params, "density_grid": jgrid}, 6, 8, 7.0,
                             jnp.asarray(c2w), jc)
    assert set(got) == set(ref)
    assert_render_close(ref, got, ("rgb_map", "acc_map", "depth_map"))


@pytest.mark.parametrize("grid_fine_only", [False, True])
def test_pick_render_tile_follows_jax_grid_rule(monkeypatch, grid_fine_only):
    """With a grid only the fine pass gates the tile: N_samples 24 leaves
    the coarse pass off the fused kernels (24 does not divide 2,048), so
    without a grid the ``netchunk`` tile binds; with a fine-only grid the
    64-sample fine pass is fused and ``chunk`` binds; the grid union (88)
    is not. As JAX decides."""
    from depth_lidar_nerf_tpu.render import renderer as jrend
    from depth_lidar_nerf_tpu_torch.render import renderer as trend

    jm, params, jr, tm, tr, jgrid, tgrid = _serving_pair(monkeypatch)
    kw = dict(N_samples=24, netchunk=8192, chunk=4096, render_grid=12,
              render_grid_fine_only=grid_fine_only)
    jc, tc = (dataclasses.replace(c, **kw) for c in (jr, tr))
    tiles = []
    for with_grid in (False, True):
        t = trend.pick_render_tile(tm.coarse, tm.fine, tc, 10000,
                                   tgrid if with_grid else None)
        j = jrend.pick_render_tile(
            jm.coarse, jm.fine,
            {**params, "density_grid": jgrid} if with_grid else params, jc,
            10000)
        assert t == j
        tiles.append(t)
    assert tiles == [128, 4096 if grid_fine_only else 128]


# -------------------------------------------------------------- grid steps


def _grid_pair(monkeypatch, cull_eps, fine_only):
    """Both packages' grid steps on a tiny synthetic scene (coarse D=2,
    fine D=4, W=128, 64 + 64 samples, half RGB and half depth rays,
    float32, ``perturb=False``, no noise, multires 4/2 as
    ``torch_port_train_helpers.train_pair``), from a JAX state after one
    two-MLP step, so that the coarse Adam moments are nonzero. One ray CDF
    (S = 96) is baked by JAX from the initial coarse field, whose density
    head is constant (weight 0, bias 0.8: every bin holds enough mass that
    float32 noise moves no importance sample far; see ``train_pair``), and
    handed to both sides as numpy."""
    import jax

    from depth_lidar_nerf_tpu.ops import ray_cdf as jcdf
    from depth_lidar_nerf_tpu.train import config as jcfg
    from depth_lidar_nerf_tpu.train import state as jstate
    from depth_lidar_nerf_tpu.train import step as jstep
    from depth_lidar_nerf_tpu_torch.ops.ray_cdf import RayCDF
    from depth_lidar_nerf_tpu_torch.train import config as tcfg
    from depth_lidar_nerf_tpu_torch.train import state as tstate
    from depth_lidar_nerf_tpu_torch.train import step as tstep

    monkeypatch.setenv("DLNERF_PALLAS_INTERPRET", "1")
    fields = dict(dataset_type="llff", N_rand=64, N_samples=64,
                  N_importance=64, netdepth=2, netwidth=128, netdepth_fine=4,
                  netwidth_fine=128, use_viewdirs=True, no_ndc=True,
                  perturb=0.0, raw_noise_std=0.0, colmap_depth=True,
                  depth_loss=True, depth_lambda=0.01, cull_eps=cull_eps,
                  multires=4, multires_views=2, grid_train=True,
                  grid_train_fine_only=fine_only, grid_train_samples=96)
    jc, tc = jcfg.TrainConfig(**fields), tcfg.TrainConfig(**fields)
    jr = jcfg.render_config_from(jc, 0, 2.0, 6.0)
    tr = tcfg.render_config_from(tc, 0, 2.0, 6.0)
    jm = jstate.build_models(jc, jr)
    js = jstate.init_train_state(jc, jr, jm, jax.random.key(0))
    sigma = js.params["coarse"]["params"]["sigma"]
    sigma["kernel"] = sigma["kernel"] * 0.0
    sigma["bias"] = sigma["bias"] + 0.8
    js = js.replace(opt_state=jstate.make_optimizer(jc).init(js.params))
    sc, (j_rgb, j_dep), (t_rgb, t_dep) = _scene_tables(jr, tr)
    # scene near/far are the config's 2/6 (no_ndc with fixed bounds)
    cdf = jcdf.bake_ray_cdf(jstate.Models(jm.coarse, None, None, None),
                            {"coarse": js.params["coarse"]}, jr, j_rgb,
                            j_dep, 96)
    cdf_np = jax.tree.map(np.asarray, cdf)
    two = jstep.make_train_step(jc, jr, jm, sc.hwf)
    js, _ = two(js, j_rgb, j_dep, None, None, jax.random.key(99))
    tm = tstate.build_models(tc, tr, device="cpu")
    ts = tstate.init_train_state(tc, tm)
    params, mu, nu = _jax_state_dicts(js)
    with torch.no_grad():
        for net, m in (("coarse", tm.coarse), ("fine", tm.fine)):
            for name, p in m.named_parameters():
                p.copy_(params[net][name])
                ts.optimizer.state[p] = {"exp_avg": mu[net][name].clone(),
                                         "exp_avg_sq": nu[net][name].clone()}
    ts.optimizer.count = ts.step = 1
    t_cdf = RayCDF(*(torch.from_numpy(np.array(x)) for x in
                     (cdf_np.w_rgb.view(np.int16), cdf_np.w_depth.view(np.int16),
                      cdf_np.z)))
    t_cdf = t_cdf._replace(w_rgb=t_cdf.w_rgb.view(torch.bfloat16),
                           w_depth=t_cdf.w_depth.view(torch.bfloat16))
    return dict(
        jax_step=jstep.make_train_step(jc, jr, jm, sc.hwf, grid_mode=True),
        jax_state=js, jax_tables=(j_rgb, j_dep), jax_cdf=cdf,
        port_step=tstep.make_train_step(tc, tr, tm, sc.hwf, grid_mode=True),
        port_state=ts, port_tables=(t_rgb, t_dep), port_cdf=t_cdf,
        n_rgb=32, n_depth=32)


def _three_grid_steps(t):
    """Three grid steps of both packages, the port started from JAX's
    parameters and Adam moments before each (as
    ``torch_port_train_helpers.three_steps_against_jax``); the metrics,
    every parameter and both moments compared after each, the coarse MLP's
    too: it has no gradient in a grid step, and optax still decays its
    moments and moves it by its first moment."""
    import jax

    js, ts = t["jax_state"], t["port_state"]
    j_rgb, j_dep = t["jax_tables"]
    nets = {"coarse": ts.models.coarse, "fine": ts.models.fine}
    opt = ts.optimizer
    coarse_moved = []
    for i in range(3):
        params, mu, nu = _jax_state_dicts(js)
        with torch.no_grad():
            for net, m in nets.items():
                for name, p in m.named_parameters():
                    p.copy_(params[net][name])
                    opt.state[p]["exp_avg"].copy_(mu[net][name])
                    opt.state[p]["exp_avg_sq"].copy_(nu[net][name])
        before = params["coarse"]
        rng = jax.random.key(200 + i)
        idx, idx_d = jax_step_indices(rng, t["n_rgb"], t["n_depth"],
                                      j_rgb.origins.shape[0],
                                      j_dep.origins.shape[0])
        js, jm = t["jax_step"](js, j_rgb, j_dep, None, None, rng,
                               t["jax_cdf"])
        tm = t["port_step"](ts, *t["port_tables"], idx=idx, idx_d=idx_d,
                            aux=t["port_cdf"])
        assert set(tm) == set(jm) == {"loss", "img_loss", "psnr",
                                      "depth_importance", "depth_loss"}
        for k in jm:
            np.testing.assert_allclose(tm[k].item(), float(jm[k]), rtol=1e-4,
                                       err_msg=f"step {i} {k}")
        params, mu, nu = _jax_state_dicts(js)
        for net, m in nets.items():
            for name, p in m.named_parameters():
                np.testing.assert_allclose(
                    p.detach().numpy(), params[net][name].numpy(), rtol=1e-4,
                    atol=2.5e-5, err_msg=f"step {i} {net} {name}")
                for key, want in (("exp_avg", mu), ("exp_avg_sq", nu)):
                    w = want[net][name].numpy()
                    np.testing.assert_allclose(
                        opt.state[p][key].numpy(), w, rtol=1e-3,
                        atol=1e-3 * np.abs(w).max() + 1e-30,
                        err_msg=f"step {i} {net} {name} {key}")
        coarse_moved.append(max(
            (params["coarse"][k] - before[k]).abs().max().item()
            for k in before))
    assert ts.step == int(js.step) == 4
    return coarse_moved


@pytest.mark.parametrize("fine_only,cull_eps", [(True, 1e-4), (True, 0.0),
                                                (False, 1e-4), (False, 0.0)])
def test_grid_steps_match_jax(monkeypatch, fine_only, cull_eps):
    """Three grid steps against JAX ``make_train_step(grid_mode=True)``
    on one baked table, with depth rays: fine-only (64 samples) and the
    union (128), ``cull_eps`` 1e-4 and 0. The fine pass takes the
    saved-activation route in both; no coarse pass runs. The coarse
    parameters keep moving (Adam's first moment) and match JAX's."""
    import depth_lidar_nerf_tpu.ops.fused_mlp_t as jfmt
    from depth_lidar_nerf_tpu_torch.ops import fused_mlp_t as tfmt
    from torch_port_train_helpers import spy_routes

    t = _grid_pair(monkeypatch, cull_eps, fine_only)
    jcalls, tcalls = [], []
    spy_routes(monkeypatch, jfmt, jcalls)
    spy_routes(monkeypatch, tfmt, tcalls)
    moved = _three_grid_steps(t)
    assert min(moved) > 1e-6  # the coarse MLP moved in every step
    assert sorted(set(jcalls)) == sorted(set(tcalls)) == ["_bwd_acts_dparams"]
    assert len(tcalls) == 3


def test_semantic_grid_step_drops_the_coarse_terms():
    """JAX's ``test_grid_step_drops_coarse_loss_terms``: a semantic grid
    step's metrics lack ``img_loss0``, ``psnr0`` and ``semantic_loss0`` and
    keep ``semantic_loss`` and ``depth_loss``; the two-MLP step has them."""
    from depth_lidar_nerf_tpu_torch.data.synthetic import draw_scene
    from depth_lidar_nerf_tpu_torch.ops.ray_cdf import bake_ray_cdf
    from depth_lidar_nerf_tpu_torch.train.config import (TrainConfig,
                                                         render_config_from)
    from depth_lidar_nerf_tpu_torch.train.state import (build_models,
                                                        init_train_state)
    from depth_lidar_nerf_tpu_torch.train.step import make_train_step
    from depth_lidar_nerf_tpu_torch.train.tables import (build_depth_table,
                                                         build_rgb_table)

    sc = draw_scene(n_images=2, H=12, W=16, focal=14.0, n_depth_points=40,
                    seed=0, backdrop=True, num_classes=5)
    cfg = TrainConfig(dataset_type="llff", N_rand=32, N_samples=16,
                      N_importance=16, netdepth=2, netwidth=32,
                      netdepth_fine=2, netwidth_fine=32, use_viewdirs=True,
                      no_ndc=True, colmap_depth=True, depth_loss=True,
                      semantic_loss=True, semantic_lambda=0.01,
                      multires=4, multires_views=2, grid_train=True)
    rcfg = render_config_from(cfg, sc.num_classes, sc.near, sc.far)
    models = build_models(cfg, rcfg, device="cpu")
    state = init_train_state(cfg, models)
    it = range(2)
    rgb = build_rgb_table(sc.images, sc.poses, it, *sc.hwf, rcfg,
                          segmentation=sc.segmentation, device="cpu")
    dep = build_depth_table(sc.depth_gts, sc.poses, it, *sc.hwf, rcfg,
                            device="cpu")
    gen = torch.Generator().manual_seed(1)
    m_two = make_train_step(cfg, rcfg, models, sc.hwf)(state, rgb, dep, gen)
    assert {"img_loss0", "psnr0", "semantic_loss0"} <= set(m_two)
    cdf = bake_ray_cdf(models, rcfg, rgb, dep, cfg.N_samples)
    assert cdf.w_rgb.shape == (rgb.origins.shape[0], cfg.N_samples)
    assert cdf.w_rgb.dtype == torch.bfloat16
    gstep = make_train_step(cfg, rcfg, models, sc.hwf, grid_mode=True)
    m_grid = gstep(state, rgb, dep, gen, aux=cdf)
    assert not {"img_loss0", "psnr0", "semantic_loss0"} & set(m_grid)
    assert {"semantic_loss", "depth_loss"} <= set(m_grid)
    assert np.isfinite(m_grid["loss"].item())
    with pytest.raises(ValueError, match="RayCDF"):
        gstep(state, rgb, dep, gen)
    with pytest.raises(ValueError, match="fine pass"):
        make_train_step(cfg.replace(N_importance=0), rcfg, models, sc.hwf,
                        grid_mode=True)


# ------------------------------------------------------------------ driver


@pytest.fixture(scope="module")
def scene_dir(tmp_path_factory):
    from depth_lidar_nerf_tpu_torch.data.synthetic import make_scene

    d = tmp_path_factory.mktemp("scene_grid")
    make_scene(str(d), n_images=3, H=24, W=32, focal=30.0, n_depth_points=120)
    return str(d)


def _fields(scene_dir, tmp_path, **kw):
    """JAX ``tests/test_grid_train.py``'s configuration."""
    base = dict(
        expname="t", basedir=str(tmp_path), datadir=scene_dir,
        dataset_type="llff", factor=0, llffhold=0, test_scene=[2],
        N_rand=96, N_samples=12, N_importance=8, netdepth=2, netwidth=48,
        netdepth_fine=2, netwidth_fine=48, use_viewdirs=True, no_ndc=True,
        N_iters=60, i_print=30, i_weights=60, i_testset=0, i_video=0,
        lrate=5e-3, multires=6, multires_views=2, should_seed=True,
        steps_per_dispatch=1, grid_train=True, grid_train_after=20,
        grid_rebake_every=20, grid_train_res=24)
    base.update(kw)
    return base


@pytest.fixture
def _in_tmp(tmp_path, monkeypatch):
    """The summary writer writes under the working directory; one intra-op
    thread (see ``tests/test_torch_port_driver.py``)."""
    monkeypatch.chdir(tmp_path)
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def test_grid_train_rebakes_on_jax_cadence_and_climbs(scene_dir, tmp_path,
                                                      monkeypatch, capsys,
                                                      _in_tmp):
    """``train()`` with ``--grid_train`` (JAX's
    ``test_grid_train_runs_and_psnr_climbs`` at its sizes): rebakes at the
    first grid step and every ``grid_rebake_every`` steps after, the
    held-out [TEST] frames after the switch render through the grid, and
    the [TRAIN] PSNR climbs by JAX's rule. A run resumed past the switch
    rebakes at its first step, then on that cadence."""
    from depth_lidar_nerf_tpu_torch.train import loop
    from depth_lidar_nerf_tpu_torch.train.config import TrainConfig

    baked, served = [], []
    orig_rebake = loop._Grid.rebake
    monkeypatch.setattr(loop._Grid, "rebake",
                        lambda self, i: baked.append(i) or orig_rebake(self, i))
    orig_path = loop.render_path

    def spy_path(*a, density_grid=None, **k):
        served.append(density_grid is not None)
        return orig_path(*a, density_grid=density_grid, **k)

    monkeypatch.setattr(loop, "render_path", spy_path)
    cfg = TrainConfig(**_fields(scene_dir, tmp_path, N_iters=200, i_print=20,
                                i_weights=200, i_testset=50,
                                grid_train_after=60, grid_rebake_every=40))
    state = loop.train(cfg, device="cpu")
    out = capsys.readouterr().out
    assert state.step == 200
    assert baked == [61, 101, 141, 181]
    assert served == [False, True, True, True]  # [TEST] at 50, 100, 150, 200
    assert "baked 24^3 density grid" in out
    psnrs = [float(l.split("psnr")[1].split()[0]) for l in out.splitlines()
             if l.startswith("[TRAIN]")]
    post = [p for i, p in enumerate(psnrs) if (i + 1) * 20 > 60]
    assert post[-1] > psnrs[2] + 1.0, out
    assert post[-1] > 18.0, out

    baked.clear()
    resumed = cfg.replace(expname="r", N_iters=120, i_weights=120,
                          i_testset=0)
    loop.train(resumed, device="cpu")
    loop.train(resumed.replace(N_iters=200), device="cpu")
    assert "resumed from checkpoint at step 120" in capsys.readouterr().out
    assert baked == [61, 101, 121, 161]


@pytest.mark.parametrize("flags", ["grid_train", "render_grid"])
def test_render_only_grid_matches_jax(tmp_path, flags, _in_tmp):
    """``--render_only --render_test`` of one exported ``.tar`` on one
    JAX-written NDC scene: with ``--grid_train`` (the grid baked at
    ``grid_train_res``, fine-only and ``grid_train_samples`` from the
    grid-train flags) and with ``--render_grid``; ``000.npz`` equal to
    JAX's at the serving tests' float32 limits."""
    import jax

    from depth_lidar_nerf_tpu.data.synthetic import make_scene as jmake
    from depth_lidar_nerf_tpu.train.config import TrainConfig as JCfg
    from depth_lidar_nerf_tpu.train.config import render_config_from
    from depth_lidar_nerf_tpu.train.loop import train as jtrain
    from depth_lidar_nerf_tpu.train.state import build_models, init_train_state
    from depth_lidar_nerf_tpu.train.torch_import import \
        export_reference_checkpoint
    from depth_lidar_nerf_tpu_torch.train.config import TrainConfig
    from depth_lidar_nerf_tpu_torch.train.loop import train

    scene = str(tmp_path / "scene")
    jmake(scene, n_images=3, H=20, W=28, focal=24.0, n_depth_points=30,
          backdrop=True)
    kw = dict(no_ndc=False, N_samples=16, N_importance=16, render_only=True,
              render_test=True)
    if flags == "grid_train":
        kw.update(grid_train_res=20, grid_train_fine_only=True,
                  grid_train_samples=32)
    else:
        kw.update(grid_train=False, render_grid=20, render_grid_samples=24)
    jc = JCfg(**_fields(scene, tmp_path, **kw))
    rcfg = render_config_from(jc, 0, 0.0, 1.0)
    js = init_train_state(jc, rcfg, build_models(jc, rcfg),
                          jax.random.key(3))
    params = jax.tree.map(np.asarray, js.params)
    for k in ("coarse", "fine"):
        sig = params[k]["params"]["sigma"]
        sig["bias"] = sig["bias"] + 2.0
    tar = export_reference_checkpoint(js.replace(params=params, step=7),
                                      str(tmp_path / "ref.tar"),
                                      verbose=False)
    jtrain(JCfg(**_fields(scene, tmp_path / "jax", ft_path=tar, **kw)))
    train(TrainConfig(**_fields(scene, tmp_path / "port", ft_path=tar, **kw)),
          device="cpu")
    sub = os.path.join("t", "renderonly_test_000007")
    ref = np.load(tmp_path / "jax" / sub / "000.npz")
    got = np.load(tmp_path / "port" / sub / "000.npz")
    acc = ref["acc"]
    assert acc.max() > 0.1  # the field is not transparent
    for k in ("rgb", "acc", "depth", "disp"):
        a, b = ref[k], got[k]
        assert a.shape == b.shape and a.dtype == b.dtype, k
        if k == "disp":
            a, b = a[acc > 1e-3], b[acc > 1e-3]
        np.testing.assert_allclose(b, a, rtol=1e-4, atol=1e-5, err_msg=k)
