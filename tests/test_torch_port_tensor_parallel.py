"""Tensor parallelism of the port (``mesh_shape [dp, tp]``: the ``dp x tp``
grid, ``parallel/tensor.py``, ``ColumnParallelNeRFMLP``, the gathered
checkpoints) on the CPU against JAX's four tests of it
(``tests/test_parallel.py:355-460``). Four gloo ranks on a ``[2, 2]`` grid,
spawned once for the module (``torch_port_parallel_helpers.
tensor_parallel_cases``), run the layer functions, the JAX-paired base step,
every step variant, a frame and the driver; the tests compare what they
saved.

Limits: JAX's own for its tensor-parallel step and frame
(``tests/test_parallel.py:417-422, 456-458``): loss rtol 1e-5 / atol 1e-6,
parameters and frames rtol 2e-4 / atol 2e-5; the split layers' sums run in
another order. Every rank of the grid holds the same metrics and whole
parameters; the parameters that each rank holds whole get the same
gradient on every rank, bit for bit."""

import os

import numpy as np
import pytest
import torch

from torch_port_parallel_helpers import (TP_DRIVER, VARIANTS,
                                         assert_same, join_group,
                                         spawn_group, tensor_parallel_cases)

LOSS_TOL = dict(rtol=1e-5, atol=1e-6)
PARAM_TOL = dict(rtol=2e-4, atol=2e-5)


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """The four ranks' results, and JAX's single-device and ``mesh_shape
    [2, 2]`` Flax steps on the inputs of the ranks' JAX-paired step
    (computed while the ranks run)."""
    import jax

    from depth_lidar_nerf_tpu.parallel.mesh import (make_mesh, replicate,
                                                    shard_params)
    from depth_lidar_nerf_tpu.train import state as jstate
    from depth_lidar_nerf_tpu.train import step as jstep
    from depth_lidar_nerf_tpu_torch.data.synthetic import make_scene
    from torch_port_train_helpers import (_jax_state_dicts, jax_step_indices,
                                          train_pair)

    d = tmp_path_factory.mktemp("tensor_parallel")
    scene = str(d / "scene")
    make_scene(scene, n_images=3, H=20, W=24, focal=22.0, n_depth_points=80)
    basedir = str(d / "driver")
    os.makedirs(basedir)
    with pytest.MonkeyPatch.context() as mp:
        t = train_pair(mp, cull_eps=1e-4)
        j_rgb, j_dep = t["jax_tables"]
        rng = jax.random.key(100)
        idx, idx_d = jax_step_indices(rng, t["n_rgb"], t["n_depth"],
                                      j_rgb.origins.shape[0],
                                      j_dep.origins.shape[0])
        path = str(d / "jax_inputs.pt")
        m = t["port_state"].models
        tc, tr, hwf = t["port_cfg"]
        torch.save({"cfg": (tc.replace(use_fused_mlp=False), tr, hwf),
                    "coarse": m.coarse.state_dict(),
                    "fine": m.fine.state_dict(), "tables": t["port_tables"],
                    "idx": idx, "idx_d": idx_d}, path)
        procs, paths = spawn_group(4, tensor_parallel_cases,
                                   (path, scene, basedir), str(d))
        try:
            js_host = jax.device_get(t["jax_state"])
            jc, jr, _, hwf = t["jax_cfg"]
            steps = {}
            for name, shape in (("single", None), ("mesh22", [2, 2])):
                jc2 = jc.replace(use_fused_mlp=False, mesh_shape=shape)
                models = jstate.build_models(jc2, jr)
                if shape is None:
                    step = jstep.make_train_step(jc2, jr, models, hwf)
                    steps[name] = step(jax.tree.map(np.copy, js_host), j_rgb,
                                       j_dep, None, None, rng)
                    continue
                mesh = make_mesh(shape)
                with mesh:
                    step = jstep.make_train_step(jc2, jr, models, hwf,
                                                 mesh=mesh)
                    sharded = shard_params(mesh, js_host)
                    trunk = sharded.params["coarse"]["params"]["trunk_0"]
                    assert trunk["kernel"].sharding.spec[-1] == "model"
                    steps[name] = step(sharded, replicate(mesh, j_rgb),
                                       replicate(mesh, j_dep), None, None,
                                       rng)
        finally:
            out = join_group(procs, paths)
    jax_out = {}
    for name, (st, mt) in steps.items():
        params = _jax_state_dicts(st)[0]
        jax_out[name] = {
            "metrics": {k: float(v) for k, v in mt.items()},
            "params": {f"{net}.{k}": v.numpy() for net in params
                       for k, v in params[net].items()}}
    return out, jax_out, basedir


def test_grid_places_ranks_row_major(ranks):
    """Rank ``d * tp + t`` has ray index ``d`` and model index ``t`` (JAX
    ``make_mesh``' ``reshape(dp, tp)``)."""
    out, _, _ = ranks
    assert [(r["ray_rank"], r["tp_rank"]) for r in out] == [
        (0, 0), (0, 1), (1, 0), (1, 1)]


@pytest.mark.parametrize("route", ["column", "column_bf16"])
def test_column_parallel_layer_matches_linear(ranks, route):
    """``column_parallel_linear`` against ``nn.Linear`` (``F.linear`` on the
    whole layer): the whole output and input gradient on every rank, the
    rank's rows of the weight and bias gradients, and a no-grad call. The
    input gradient is the whole layer's product of the same operands: equal
    to ``F.linear``'s backward bit for bit, in bfloat16 too."""
    out, _, _ = ranks
    tol = (dict(rtol=1.6e-2, atol=1.6e-2) if route.endswith("bf16")
           else dict(rtol=1e-6, atol=1e-6))
    whole_key = "whole_bf16" if route.endswith("bf16") else "whole"
    for r in out:
        got, want = r["linear"][route], r["linear"][whole_key]
        rows = slice(8 * r["tp_rank"], 8 * r["tp_rank"] + 8)
        np.testing.assert_allclose(got["y"], want["y"], **tol)
        assert np.array_equal(got["dx"], want["dx"])
        np.testing.assert_allclose(got["dw"], want["dw"][rows], **tol)
        np.testing.assert_allclose(got["db"], want["db"][rows], **tol)
        assert got["dw"].shape == (8, 12)
        np.testing.assert_allclose(r["linear"]["no_grad"],
                                   r["linear"]["whole"]["y"], rtol=1e-6,
                                   atol=1e-6)


@pytest.mark.parametrize("ref", ["single", "mesh22"])
def test_model_parallel_step_matches_jax(ranks, ref):
    """JAX ``test_model_parallel_step_matches_single_device`` across
    packages: the port's ``[2, 2]`` step from JAX's weights and ray indices
    against JAX's single-device Flax step and its ``make_mesh([2, 2])``
    tensor-parallel step, at that test's limits; every rank holds the
    same."""
    out, jax_out, _ = ranks
    for r in out[1:]:
        assert_same(r["jax_base"], out[0]["jax_base"], "jax_base")
    got, want = out[0]["jax_base"], jax_out[ref]
    assert set(got["metrics"]) == set(want["metrics"])
    for k, v in want["metrics"].items():
        np.testing.assert_allclose(got["metrics"][k], v, err_msg=k,
                                   **LOSS_TOL)
    for k, v in want["params"].items():
        np.testing.assert_allclose(got["params"][k], v, err_msg=k,
                                   **PARAM_TOL)


def test_split_weights_are_really_split(ranks):
    """Each rank holds ``out / tp`` rows of every wide layer (the trunk,
    ``feature``, ``views_0``, ``semantic_0``) and the narrow heads whole
    (``sigma``, ``rgb``, ``semantic_1``), as JAX's ``_tp_spec`` places
    them."""
    out, _, _ = ranks
    for r in out:
        shapes = r["variants"]["semantic"]["tp"]["shapes"]
        assert shapes["coarse.trunk_0.weight"] == (64, 27)
        assert shapes["coarse.trunk_1.bias"] == (64,)
        assert shapes["fine.feature.weight"] == (64, 128)
        assert shapes["fine.views_0.weight"] == (32, 143)
        assert shapes["fine.semantic_0.weight"] == (32, 128)
        assert shapes["fine.sigma.weight"] == (1, 128)
        assert shapes["fine.rgb.weight"] == (3, 64)
        assert shapes["fine.semantic_1.weight"] == (19, 64)


def test_model_parallel_rejects_fused_path(tmp_path):
    """JAX ``test_model_parallel_rejects_fused_path``: ``use_fused_mlp``
    with ``tp > 1`` raises ``ValueError`` naming the model axis, in
    ``build_models`` and in ``train`` before anything is written."""
    from depth_lidar_nerf_tpu_torch.train.config import (TrainConfig,
                                                         render_config_from)
    from depth_lidar_nerf_tpu_torch.train.loop import train
    from depth_lidar_nerf_tpu_torch.train.state import (build_models,
                                                        check_tp_route)

    cfg = TrainConfig(N_rand=64, N_samples=16, N_importance=16, netdepth=2,
                      netwidth=128, netdepth_fine=2, netwidth_fine=128,
                      use_viewdirs=True, no_ndc=True, multires=4,
                      multires_views=2, use_fused_mlp=True,
                      mesh_shape=[2, 4], basedir=str(tmp_path),
                      datadir=str(tmp_path / "none"))
    rcfg = render_config_from(cfg, 0, 2.0, 6.0)
    with pytest.raises(ValueError, match="model"):
        build_models(cfg, rcfg, device="cpu")
    with pytest.raises(ValueError, match="model"):
        train(cfg, device="cpu")
    assert os.listdir(tmp_path) == []
    build_models(cfg.replace(mesh_shape=[8]), rcfg, device="cpu")
    # JAX's frozen-alpha branch returns before its check.
    check_tp_route(cfg.replace(alpha_model_path="alpha.pt"))


def test_split_and_gather_round_trip_and_drift_refused():
    """``ColumnParallelNeRFMLP`` made from a whole MLP holds
    ``shard_mlp_state_dict``'s part of it on each model rank (no value left
    on the meta device); ``gather_mlp_state_dict`` of the parts is the
    whole state dict bit for bit, and refuses parts whose whole (replicated)
    entries differ."""
    import types

    from depth_lidar_nerf_tpu_torch.models.nerf_mlp import (
        ColumnParallelNeRFMLP, NeRFMLP)
    from depth_lidar_nerf_tpu_torch.weights import (gather_mlp_state_dict,
                                                    shard_mlp_state_dict)

    whole = NeRFMLP(depth=2, width=32, in_channels=27, in_channels_views=15,
                    num_semantic_classes=5,
                    generator=torch.Generator().manual_seed(3))
    sd = whole.state_dict()
    parts = []
    for t in range(2):
        mesh = types.SimpleNamespace(tp=2, tp_rank=t, model_group=None)
        part = ColumnParallelNeRFMLP(whole=whole, mesh=mesh)
        want = shard_mlp_state_dict(sd, 2, t)
        got = part.state_dict()
        assert set(got) == set(want)
        for k in want:
            assert got[k].device.type == "cpu"
            assert torch.equal(got[k], want[k]), k
        assert part.sharded == {"trunk_0", "trunk_1", "feature", "views_0",
                                "semantic_0"}
        parts.append(got)
    full = gather_mlp_state_dict(parts, part.full_shapes)
    assert all(torch.equal(full[k], sd[k]) for k in sd)
    parts[1] = dict(parts[1], **{"sigma.bias": parts[1]["sigma.bias"] + 1})
    with pytest.raises(RuntimeError, match="sigma.bias"):
        gather_mlp_state_dict(parts, part.full_shapes)


def test_tp_spec_matches_jax():
    """``tp_spec`` (torch's ``[out, in]`` layout) splits what JAX's
    ``_tp_spec`` splits (Flax's ``[in, out]``), over widths, heads,
    biases and degrees."""
    import jax.numpy as jnp

    from depth_lidar_nerf_tpu.parallel.mesh import _tp_spec
    from depth_lidar_nerf_tpu_torch.parallel.mesh import tp_spec

    shapes = [(63, 256), (256, 1), (283, 128), (128, 3), (128, 19),
              (128, 20), (64, 8), (64, 7), (64, 4), (256,), (1,), (19,),
              (20,), (8,), (3, 3, 3, 32), (2, 4, 6)]
    for tp in (2, 4):
        for shape in shapes:
            x = jnp.zeros(shape)
            want = len(_tp_spec(x, tp)) > 0 and _tp_spec(x, tp)[-1] == "model"
            torch_shape = shape[::-1] if len(shape) == 2 else shape
            assert (tp_spec(torch_shape, tp) == 0) == want, (shape, tp)
            if len(shape) not in (1, 2):
                assert tp_spec(torch_shape, tp) is None


@pytest.mark.parametrize("name", list(VARIANTS))
def test_step_variant_matches_one_process(ranks, name):
    """Every step variant on the ``[2, 2]`` grid against one process's
    plain modules: the same draws and batch, the wide layers' sums split;
    every rank holds the same metrics and whole parameters."""
    out, _, _ = ranks
    for r in out[1:]:
        assert_same(r["variants"][name]["tp"]["metrics"],
                    out[0]["variants"][name]["tp"]["metrics"], name)
        assert_same(r["variants"][name]["tp"]["params"],
                    out[0]["variants"][name]["tp"]["params"], name)
    one, tp = out[0]["variants"][name]["one"], out[0]["variants"][name]["tp"]
    for i, (a, b) in enumerate(zip(one["metrics"], tp["metrics"])):
        assert set(a) == set(b)
        for k in a:
            np.testing.assert_allclose(b[k], a[k], err_msg=f"{name} {i} {k}",
                                       **LOSS_TOL)
    assert set(one["params"]) == set(tp["params"])
    for k, v in one["params"].items():
        np.testing.assert_allclose(tp["params"][k], v, err_msg=f"{name} {k}",
                                   **PARAM_TOL)


@pytest.mark.parametrize("name", ["base", "gan", "alpha"])
def test_replicated_gradients_equal_across_model_group(ranks, name):
    """A parameter every rank holds whole (the narrow heads) gets the same
    gradient on both ranks of a model group, bit for bit, so it needs no
    reduction over the model axis."""
    out, _, _ = ranks
    for group in ((0, 1), (2, 3)):
        a, b = (out[r]["variants"][name]["tp"]["replicated_grads"]
                for r in group)
        assert {"coarse.rgb.weight", "fine.rgb.bias"} <= set(a)
        assert_same(a, b, name)


def test_model_parallel_eval_render_matches_single_device(ranks):
    """JAX ``test_model_parallel_eval_render_matches_single_device``: a
    frame with split parameters, split by rays over the ray groups, against
    one process's frame."""
    out, _, _ = ranks
    one = out[0]["frame"]["one"]
    for r in out:
        for k in ("rgb_map", "depth_map", "acc_map"):
            np.testing.assert_allclose(r["frame"]["tp"][k], one[k],
                                       err_msg=k, **PARAM_TOL)
    assert one["rgb_map"].shape == (12, 16, 3)


def test_cli_train_with_model_parallel_mesh(ranks):
    """JAX ``test_cli_train_with_model_parallel_mesh``: the driver with
    colmap depth on ``[2, 2]`` takes 10 steps with split trunks, resumes to
    15 on the same mesh, prints JAX's mesh line once; its checkpoint holds
    whole parameters, which one process loads and which equal the ranks'
    gathered parameters bit for bit."""
    from depth_lidar_nerf_tpu_torch.train import checkpoint
    from depth_lidar_nerf_tpu_torch.train.config import (TrainConfig,
                                                         render_config_from)
    from depth_lidar_nerf_tpu_torch.train.state import (build_models,
                                                        init_train_state)

    out, _, basedir = ranks
    for r in out:
        assert r["driver"]["steps"] == [10, 15]
        assert r["driver"]["trunk"] == (16, 27)
        assert_same(r["driver"]["params"], out[0]["driver"]["params"],
                    "driver")
    printed = out[0]["driver"]["printed"]
    assert printed.count("ray-DP x 2-way model-TP mesh over 4 devices") == 2
    assert "resumed from checkpoint at step 10" in printed
    assert all(r["driver"]["printed"] == "" for r in out[1:])
    ckdir = checkpoint.ckpt_dir(basedir, "mesh")
    assert checkpoint.steps(ckdir) == [10, 15]
    cfg = TrainConfig(use_viewdirs=True, multires=4, multires_views=2,
                      **TP_DRIVER)
    rcfg = render_config_from(cfg, 0, 0.0, 1.0)
    state = init_train_state(cfg, build_models(cfg, rcfg, device="cpu"))
    checkpoint.restore(checkpoint.load_file(checkpoint.path_of(ckdir, 15)),
                       state, checkpoint.topology(cfg, 0))
    assert state.step == 15
    got = {f"{n}.{k}": v.numpy() for n, m in (("coarse", state.models.coarse),
                                              ("fine", state.models.fine))
           for k, v in m.state_dict().items()}
    assert_same(got, out[0]["driver"]["params"], "checkpoint")
