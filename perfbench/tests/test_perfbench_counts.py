"""The frozen work counts and the profile reduction, at known values."""

import json

import harness_helpers as h
import pytest

from yardstick import cell, counts, trace


def _plain(name):
    b = json.loads((h.REPO / "BENCHMARK.json").read_text())
    return cell.plain(cell.config(b, name, h.REPO))


@pytest.mark.parametrize("config,kind,n_rays,tflop", [
    ("rgb_only", "frame", 94 * 352, 6.32),
    ("kitti360", "step", 16384, 9.88),
    ("rgb_only", "step", 16384, 9.22)])
def test_flops(config, kind, n_rays, tflop):
    fn = counts.frame_flops if kind == "frame" else counts.step_flops
    assert fn(_plain(config), n_rays) / 1e12 == pytest.approx(tflop, abs=0.005)


def test_kernel_one_bound():
    # The kernel table's bound of kernel 1 on a 94x352 frame: 6.388 ms.
    assert counts.frame_fwd_bound_s(_plain("rgb_only"), 94 * 352) * 1e3 == \
        pytest.approx(6.388, abs=0.001)


def test_bound_takes_the_larger():
    assert counts.bound_s(989e12, 0) == pytest.approx(1.0)
    assert counts.bound_s(0, 3.35e12) == pytest.approx(1.0)


def _tr(device, spans=(), t1=10.0):
    return trace.Trace(sorted(device, key=lambda x: x[1]), list(spans), 0.0, t1)


def test_union_counts_overlap_once():
    tr = _tr([("k", 0.0, 2.0), ("ncclDevKernel_AllReduce", 1.0, 3.0), ("k", 5.0, 6.0)])
    assert trace.busy_s(tr) == pytest.approx(4.0)
    assert trace.exposed_nccl_s(tr) == pytest.approx(1.0)


def test_names_and_reduce_attribution():
    n = "void (anonymous namespace)::fused_nerf_bwd_acts_kernel<__nv_bfloat16, 256, true>(fnerf::Net)"
    assert trace.short_name(n) == "fused_nerf_bwd_acts_kernel"
    tr = _tr([("fused_nerf_bwd_recompute_kernel", 0, 1), ("fused_nerf_grad_reduce_kernel", 1, 1.5),
              ("fused_nerf_wgrad_kernel", 2, 3), ("fused_nerf_grad_reduce_kernel", 3, 3.25)])
    assert trace.reduce_after(tr, "fused_nerf_grad_reduce_kernel",
                              "fused_nerf_wgrad_kernel") == pytest.approx(0.25)


def test_idle_gaps_named_by_innermost_span():
    tr = _tr([("k", 0.0, 1.0), ("k", 4.0, 5.0)],
             [("bench.window", 0.0, 10.0), ("bench.fetch", 0.5, 3.0)])
    gaps = trace.idle_gaps(tr)
    assert gaps[0] == ["bench.window", pytest.approx(5.0)]
    assert gaps[1] == ["bench.fetch", pytest.approx(3.0)]
    assert trace.top_ops(tr) == [["k", pytest.approx(2.0)]]


def test_seed_orders_units_without_changing_the_function():
    """Every seed gets the same work: the seed draws the order of each
    hidden layer's units, which leaves what the nets compute unchanged."""
    import torch

    from yardstick import reference, scene

    b = json.loads((h.TINY / "BENCHMARK.json").read_text())
    pl = cell.plain(cell.config(b, "tiny_kitti", h.REPO))
    a, c = scene.make_weights(pl, 1, "cpu"), scene.make_weights(pl, 2**31 + 9, "cpu")
    data = scene.make_scene(pl, 1, "cpu")
    rows = torch.arange(pl["H"], dtype=torch.float32).repeat_interleave(pl["W"])
    cols = torch.arange(pl["W"], dtype=torch.float32).repeat(pl["H"])
    ro, rd = reference.pixel_rays(pl["H"], pl["W"], pl["focal"], data.poses[0], rows, cols)
    rays = reference.make_rays(pl, ro, rd)
    z = reference.unit_linspace(16, "cpu").expand(rows.shape[0], -1)
    for net in ("coarse", "fine"):
        assert any(not torch.equal(a[net][k], c[net][k]) for k in a[net])
        ra = reference.query(a[net], pl["nets"][net], pl, rays, z)
        rc = reference.query(c[net], pl["nets"][net], pl, rays, z)
        assert torch.allclose(ra, rc, rtol=1e-5, atol=1e-5)
    assert torch.equal(data.images, scene.make_scene(pl, 7, "cpu").images)
