"""Ray data parallelism of the port (``parallel/``, the sharded step,
sharded frames and bakes) on the CPU: two gloo ranks, spawned once for the
module (``torch_port_parallel_helpers.parallel_cases``), run every step
variant, the frames, the density grid and the JAX-paired base step; the
tests compare what they saved.

Limits: the two ranks agree bit for bit; a 2-rank step matches one
process's at JAX's own limits for its sharded step
(``tests/test_parallel.py:133-137``: loss rtol 1e-5 / atol 1e-6,
parameters rtol 2e-4 / atol 2e-5; only the order of the gradient sum
differs); a 1-rank mesh, a sharded frame and a sharded bake equal one
process bit for bit. On the CPU the kernels' plain twins run; their matrix
products give each row the same value whatever the other rows (BLAS takes
another path for a single row, so no shard here is one row long)."""

import os

import numpy as np
import pytest
import torch

from torch_port_parallel_helpers import (FRAMES, VARIANTS, assert_same,
                                         join_group, parallel_cases,
                                         spawn_group)

STEP_TOL = {"loss": (1e-5, 1e-6), "params": (2e-4, 2e-5)}


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """Both ranks' results, and JAX's single-device and ``mesh_shape=[2]``
    base steps on the inputs of the ranks' JAX-paired step (computed while
    the ranks run)."""
    import jax

    from depth_lidar_nerf_tpu.parallel.mesh import make_mesh, replicate
    from depth_lidar_nerf_tpu.train import state as jstate
    from depth_lidar_nerf_tpu.train import step as jstep
    from torch_port_train_helpers import (_jax_state_dicts, jax_step_indices,
                                          train_pair)

    d = tmp_path_factory.mktemp("parallel")
    with pytest.MonkeyPatch.context() as mp:
        t = train_pair(mp, cull_eps=1e-4)
        j_rgb, j_dep = t["jax_tables"]
        rng = jax.random.key(100)
        idx, idx_d = jax_step_indices(rng, t["n_rgb"], t["n_depth"],
                                      j_rgb.origins.shape[0],
                                      j_dep.origins.shape[0])
        path = str(d / "jax_inputs.pt")
        m = t["port_state"].models
        torch.save({"cfg": t["port_cfg"], "coarse": m.coarse.state_dict(),
                    "fine": m.fine.state_dict(), "tables": t["port_tables"],
                    "idx": idx, "idx_d": idx_d}, path)
        procs, paths = spawn_group(2, parallel_cases, (path,), str(d))
        try:
            js = t["jax_state"]
            js_host = jax.device_get(js)  # the step donates its state
            js1, jm1 = t["jax_step"](js, j_rgb, j_dep, None, None, rng)
            jc, jr, _, hwf = t["jax_cfg"]
            jc2 = jc.replace(mesh_shape=[2])
            mesh = make_mesh([2])
            with mesh:
                step2 = jstep.make_train_step(
                    jc2, jr, jstate.build_models(jc2, jr), hwf, mesh=mesh)
                js2, jm2 = step2(replicate(mesh, js_host),
                                 replicate(mesh, j_rgb),
                                 replicate(mesh, j_dep), None, None, rng)
        finally:
            out = join_group(procs, paths)
    jax_out = {}
    for name, (st, mt) in (("single", (js1, jm1)), ("mesh2", (js2, jm2))):
        params = _jax_state_dicts(st)[0]
        jax_out[name] = {
            "metrics": {k: float(v) for k, v in mt.items()},
            "params": {f"{net}.{k}": v.numpy() for net in params
                       for k, v in params[net].items()}}
    return out, jax_out


def _close(got, want, tol, what):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               rtol=tol[0], atol=tol[1], err_msg=what)


@pytest.mark.parametrize("name", list(VARIANTS))
def test_step_ranks_agree_bit_for_bit(ranks, name):
    """Both ranks hold the same metrics and parameters (the discriminator
    and the grid variant's baked rows included) after every step."""
    (r0, r1), _ = ranks
    assert_same(r0["variants"][name]["dp"], r1["variants"][name]["dp"], name)


@pytest.mark.parametrize("name", list(VARIANTS))
def test_step_matches_one_process(ranks, name):
    """Two ranks against one process: the same draws, the same batch, the
    gradient summed in another order."""
    (r0, _), _ = ranks
    one, dp = r0["variants"][name]["one"], r0["variants"][name]["dp"]
    for i, (a, b) in enumerate(zip(one["metrics"], dp["metrics"])):
        assert set(a) == set(b)
        for k in a:
            _close(b[k], a[k], STEP_TOL["loss"], f"{name} step {i} {k}")
    for k, v in one["params"].items():
        _close(dp["params"][k], v, STEP_TOL["params"], f"{name} {k}")
    if "cdf" in one:
        assert_same(one["cdf"], dp["cdf"], f"{name} baked rows")


@pytest.mark.parametrize("name", list(VARIANTS))
def test_world_size_one_is_bit_for_bit(ranks, name):
    """A mesh of one rank takes the steps of one process, bit for bit: the
    draws, the gathers and the gradient sum change nothing."""
    (r0, _), _ = ranks
    assert_same(r0["variants"][name]["world1"], r0["variants"][name]["one"],
                name)


@pytest.mark.parametrize("name", list(FRAMES))
def test_sharded_frame_is_bit_for_bit(ranks, name):
    """A frame split over two ranks, tile by tile, equals one process's
    frame on both ranks: the plain modules, the kernels' twins, the int8
    twins, and the coarse-downsampled frame."""
    (r0, r1), _ = ranks
    one = r0["frames"][name]["one"]
    assert_same(r0["frames"][name]["dp"], one, name)
    assert_same(r1["frames"][name]["dp"], one, name)
    assert one["rgb_map"].shape == (12, 16, 3)


def test_sharded_density_grid_is_bit_for_bit(ranks):
    (r0, r1), _ = ranks
    assert_same(r0["grid"]["dp"], r0["grid"]["one"], "grid")
    assert_same(r1["grid"]["dp"], r0["grid"]["one"], "grid")


@pytest.mark.parametrize("ref", ["single", "mesh2"])
def test_two_rank_step_matches_jax(ranks, ref):
    """The 2-rank base step from JAX's weights and ray indices against
    JAX's single-device step and its ``mesh_shape=[2]`` sharded step, at
    the port's step limits (``torch_port_train_helpers.
    three_steps_against_jax``)."""
    (r0, r1), jax_out = ranks
    assert_same(r0["jax_base"], r1["jax_base"], "jax_base")
    got, want = r0["jax_base"], jax_out[ref]
    assert set(got["metrics"]) == set(want["metrics"])
    for k, v in want["metrics"].items():
        np.testing.assert_allclose(got["metrics"][k], v, rtol=1e-4,
                                   err_msg=k)
    for k, v in want["params"].items():
        np.testing.assert_allclose(got["params"][k], v, rtol=1e-4,
                                   atol=2.5e-5, err_msg=k)


def test_pad_rows_and_row_slice_match_jax(monkeypatch):
    """``pad_rows`` (row 0 repeated) and ``process_row_slice`` against
    JAX's, the process count and index patched into both."""
    import jax

    from depth_lidar_nerf_tpu.parallel import distributed as jd
    from depth_lidar_nerf_tpu_torch.parallel import distributed as td
    from depth_lidar_nerf_tpu_torch.train.tables import DepthRayTable

    rng = np.random.default_rng(0)
    for rows, mult in ((10, 4), (12, 4), (7, 1), (5, 8)):
        t = DepthRayTable(*(rng.normal(size=(rows, 3)).astype(np.float32)
                            for _ in range(3)),
                          rng.normal(size=rows).astype(np.float32), None)
        want, n_want = jd.pad_rows(t, mult)
        got, n_got = td.pad_rows(t, mult)
        tt, _ = td.pad_rows(DepthRayTable(*(None if x is None else
                                            torch.from_numpy(x) for x in t)),
                            mult)
        assert n_got == n_want and n_got % mult == 0
        for a, b, c in zip(want, got, tt):
            assert (a is None) == (b is None) == (c is None)
            if a is not None:
                np.testing.assert_array_equal(b, a)
                np.testing.assert_array_equal(c.numpy(), a)
    for n, pid in ((1, 0), (2, 0), (2, 1), (4, 3)):
        monkeypatch.setattr(jax, "process_count", lambda n=n: n)
        monkeypatch.setattr(jax, "process_index", lambda pid=pid: pid)
        monkeypatch.setattr(td, "_process", lambda group=None, n=n, pid=pid:
                            (pid, n))
        for rows in (8, 16):
            for shard in (True, False):
                assert (td.process_row_slice(rows, shard)
                        == jd.process_row_slice(rows, shard))
        if n > 1:
            with pytest.raises(AssertionError, match="pad the table first"):
                td.process_row_slice(10 * n + 1)


@pytest.mark.parametrize("n", [0, 1, 5, 63, 64, 16384])
def test_ray_range_is_contiguous_and_even(n):
    from depth_lidar_nerf_tpu_torch.parallel.mesh import ray_range

    class M:
        pass

    for size in (1, 2, 3, 8):
        bounds = []
        for rank in range(size):
            m = M()
            m.size, m.rank = size, rank
            bounds.append(ray_range(n, m))
        assert bounds[0][0] == 0 and bounds[-1][1] == n
        assert all(a[1] == b[0] for a, b in zip(bounds, bounds[1:]))
        sizes = [hi - lo for lo, hi in bounds]
        assert max(sizes) - min(sizes) <= 1 and sizes == sorted(sizes)[::-1]
    assert ray_range(n, None) == (0, n)


def test_make_mesh_errors_and_tensor_parallel_refused(monkeypatch, tmp_path):
    """``make_mesh`` carries JAX's error text, needs a process group and a
    grid that names every rank; ``train`` and ``build_models`` refuse
    ``mesh_shape [2, 2]`` on the fused kernels with JAX's ``ValueError``
    before anything is written (tensor parallelism takes the plain
    modules, ``test_torch_port_tensor_parallel.py``)."""
    import jax
    import torch.distributed as dist

    from depth_lidar_nerf_tpu.parallel.mesh import make_mesh as jax_mesh
    from depth_lidar_nerf_tpu_torch.parallel.mesh import make_mesh
    from depth_lidar_nerf_tpu_torch.train.config import (TrainConfig,
                                                         render_config_from)
    from depth_lidar_nerf_tpu_torch.train.loop import train
    from depth_lidar_nerf_tpu_torch.train.state import build_models

    with pytest.raises(RuntimeError, match="needs a process group"):
        make_mesh([2], device="cpu")
    with pytest.raises(ValueError) as want:
        jax_mesh([2, 4], jax.devices()[:2])
    monkeypatch.setattr(dist, "is_initialized", lambda: True)
    monkeypatch.setattr(dist, "get_rank", lambda group=None: 0)
    monkeypatch.setattr(dist, "get_world_size", lambda group=None: 2)
    with pytest.raises(ValueError) as got:
        make_mesh([2, 4], device="cpu")
    assert str(got.value) == str(want.value)
    with pytest.raises(ValueError, match=r"mesh_shape \[4\] needs 4 devices, "
                       "have 2"):
        make_mesh([4], device="cpu")
    with pytest.raises(ValueError, match="names 1 of the 2 ranks"):
        make_mesh([1], device="cpu")
    mesh = make_mesh([2, 1], device="cpu")
    assert (mesh.size, mesh.rank, mesh.tp) == (2, 0, 1)
    monkeypatch.setattr(dist, "get_world_size", lambda group=None: 4)
    with pytest.raises(ValueError, match=r"mesh_shape \[3, 2\] needs 6 "
                       "devices, have 4"):
        make_mesh([3, 2], device="cpu")
    with pytest.raises(ValueError, match="names 2 of the 4 ranks"):
        make_mesh([1, 2], device="cpu")
    monkeypatch.undo()

    cfg = TrainConfig(basedir=str(tmp_path), expname="tp", mesh_shape=[2, 2],
                      datadir=str(tmp_path / "none"))
    assert cfg.use_fused_mlp
    with pytest.raises(ValueError, match="model-TP mesh"):
        train(cfg, device="cpu")
    with pytest.raises(ValueError, match="model-TP mesh"):
        build_models(cfg, render_config_from(cfg, 0, 0.0, 1.0), device="cpu")
    assert os.listdir(tmp_path) == []

def test_multihost_mesh_ignores_mesh_shape(monkeypatch):
    """Under ``dist_coordinator`` JAX builds the ray mesh over every device
    and ignores ``mesh_shape`` (``train/loop.py:727-736``); so does the
    port (it used to hand ``mesh_shape`` to ``make_mesh``, which refused
    ``[4]`` on two processes and would have split the MLPs on ``[1, 2]``)."""
    import torch.distributed as dist

    from depth_lidar_nerf_tpu_torch.train import loop
    from depth_lidar_nerf_tpu_torch.train.config import TrainConfig

    monkeypatch.setattr(dist, "is_initialized", lambda: True)
    monkeypatch.setattr(dist, "get_rank", lambda group=None: 1)
    monkeypatch.setattr(dist, "get_world_size", lambda group=None: 2)
    monkeypatch.setattr(loop, "_train", lambda cfg, hook, device, mesh: mesh)
    for shape in ([4], [1, 2], None):
        mesh = loop._train_rank(TrainConfig(dist_coordinator="h:1",
                                            mesh_shape=shape,
                                            use_fused_mlp=False),
                                None, "cpu")
        assert (mesh.size, mesh.rank, mesh.tp, mesh.row_sliced) == (
            2, 1, 1, True)
