"""The port's data-parallel driver on the CPU (gloo): two processes joined
as ``dist_coordinator`` hosts, each keeping only its row slice of the ray
tables, and ``mesh_shape [2]``, whose process starts the second rank
itself; both against one process (JAX's gate, ``tests/
test_multihost.py:77-96``: the metrics at rtol 1e-4 / atol 1e-6), the
checkpoint written by rank 0 alone and a resumed multi-host run."""

import os

import numpy as np
import pytest
import torch

from torch_port_parallel_helpers import (DRIVER_STEPS, assert_same,
                                         driver_fields, join_group,
                                         multihost_driver, spawn_group)

GATE = dict(rtol=1e-4, atol=1e-6)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The 2-process multi-host runs (spawned first), one process's
    uninterrupted run, and a ``mesh_shape [2]`` run with held-out frames,
    all on one scene."""
    from depth_lidar_nerf_tpu_torch.data.synthetic import make_scene
    from depth_lidar_nerf_tpu_torch.parallel.distributed import free_port
    from depth_lidar_nerf_tpu_torch.train.config import TrainConfig
    from depth_lidar_nerf_tpu_torch.train.loop import train

    root = tmp_path_factory.mktemp("multihost")
    scene = str(root / "scene")
    make_scene(scene, n_images=3, H=20, W=24, focal=22.0, n_depth_points=80)
    basedirs = [str(root / f"host{r}") for r in range(2)]
    for b in basedirs + [str(root / "one"), str(root / "mesh")]:
        os.makedirs(b)
    procs, paths = spawn_group(
        2, multihost_driver,
        (scene, basedirs, f"127.0.0.1:{free_port()}"), str(root))
    cwd, threads = os.getcwd(), torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        out = {}
        for name, kw in (("one", {}), ("mesh", dict(mesh_shape=[2]))):
            os.chdir(str(root / name))
            hist = []
            cfg = TrainConfig(**driver_fields(
                scene, str(root / name), i_testset=2 * DRIVER_STEPS, **kw))
            st = train(cfg, device="cpu",
                       metrics_hook=lambda i, m, h=hist: h.append((i, m)))
            out[name] = {"metrics": hist, "step": int(st.step),
                         "root": str(root / name)}
    finally:
        os.chdir(cwd)
        torch.set_num_threads(threads)
        hosts = join_group(procs, paths)
    return hosts, out


def _gate(got, want):
    assert [i for i, _ in got] == [i for i, _ in want]
    for (i, a), (_, b) in zip(got, want):
        assert set(a) == set(b)
        for k in b:
            np.testing.assert_allclose(a[k], b[k], err_msg=f"{i} {k}", **GATE)


def test_each_process_keeps_its_row_slice(runs):
    """Each process built its tables and kept rows ``[r * M / 2, (r + 1) *
    M / 2)`` of each: 960 rgb rays and 160 depth rays over two."""
    hosts, _ = runs
    for r, h in enumerate(hosts):
        # Two runs, each slicing both tables.
        assert h["kept"] == [("RgbRayTable", 480 * r, 480, 960),
                             ("DepthRayTable", 80 * r, 80, 160)] * 2


def test_processes_agree_bit_for_bit(runs):
    hosts, _ = runs
    assert [i for i, _ in hosts[0]["metrics"]] == \
        [i for i, _ in hosts[1]["metrics"]]
    assert_same([m for _, m in hosts[0]["metrics"]],
                [m for _, m in hosts[1]["metrics"]], "metrics")
    assert_same(hosts[0]["params"], hosts[1]["params"], "params")


def test_multihost_matches_one_process(runs):
    """Rank 0's metrics over both runs (steps 4-8, then the resumed 12-16)
    against one process's uninterrupted run."""
    hosts, out = runs
    _gate(hosts[0]["metrics"], out["one"]["metrics"])


def test_rank0_writes_and_the_resume_continues(runs):
    """Rank 0 alone wrote (the checkpoints at 8 and 16, ``args.txt``);
    rank 1's disk holds no checkpoint, and its resumed run started from
    rank 0's state at step 8 all the same."""
    hosts, _ = runs
    assert hosts[0]["steps"] == hosts[1]["steps"] == [DRIVER_STEPS,
                                                      2 * DRIVER_STEPS]
    ck = sorted(f for f in hosts[0]["files"]
                if f.startswith(os.path.join("mh", "checkpoints")))
    assert ck == sorted(os.path.join("mh", "checkpoints", f"{s}.pt")
                        for s in (DRIVER_STEPS, 2 * DRIVER_STEPS))
    assert os.path.join("mh", "args.txt") in hosts[0]["files"]
    assert not any(f.startswith("mh") for f in hosts[1]["files"])
    # The resumed run's first print is past the checkpoint.
    steps = [i for i, _ in hosts[1]["metrics"]]
    assert steps == [4, 8, 12, 16]


def test_mesh_shape_run_matches_one_process(runs):
    """``mesh_shape [2]``: this process is rank 0 and starts rank 1; its
    metrics pass the gate, and rank 0 wrote the held-out frames."""
    _, out = runs
    assert out["mesh"]["step"] == 2 * DRIVER_STEPS
    _gate(out["mesh"]["metrics"], out["one"]["metrics"])
    testdir = os.path.join(out["mesh"]["root"], "mh",
                           f"testset_{2 * DRIVER_STEPS:06d}")
    assert sorted(os.listdir(testdir)) == ["000.npz", "000.png",
                                           "000_depth.png"]
