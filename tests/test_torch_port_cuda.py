"""The port's CUDA kernels against their plain PyTorch versions on the card.

Marked ``cuda``: they skip where no CUDA device is present (the fixture
decides at run time) and run on an H100 with
``python -m pytest tests/test_torch_port_cuda.py -q``. Each builds its
kernel from ``csrc/`` with nvcc at first use.
"""

import numpy as np
import pytest
import torch

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("depth,width,S,N", [(4, 256, 64, 37), (8, 256, 128, 20),
                                             (8, 128, 128, 9), (4, 128, 16, 50),
                                             (2, 128, 3, 70)])
def test_fused_fwd_kernel_matches_plain(cuda, depth, width, S, N, dtype):
    from depth_lidar_nerf_tpu_torch.models.nerf_mlp import NeRFMLP
    from depth_lidar_nerf_tpu_torch.ops import fused_mlp_t as f

    g = torch.Generator().manual_seed(depth * 100 + S)
    m = NeRFMLP(depth=depth, width=width, generator=g).to(cuda)
    params = {k: v.detach() for k, v in m.named_parameters()}
    rng = np.random.default_rng(S)
    pts = torch.from_numpy(rng.uniform(-1, 1, (3, N * S)).astype(np.float32)).to(cuda)
    vd = torch.nn.functional.normalize(
        torch.from_numpy(rng.normal(size=(N, 3)).astype(np.float32)), dim=-1).T.to(cuda)
    kw = dict(depth=depth, width=width, multires=10, multires_views=4,
              dtype=dtype, skips=(4,))
    n0 = f.fused_nerf_fwd.launches
    got = f.fused_nerf_fwd(params, pts, vd, S, **kw)
    torch.cuda.synchronize()
    assert f.fused_nerf_fwd.launches == n0 + 1
    ref = f.fused_nerf_fwd_plain(params, pts, vd, S, **kw)
    scale = ref.abs().max().item()
    tol = 1e-4 * scale if dtype == torch.float32 else 2e-2 * scale
    assert (got - ref).abs().max().item() <= tol


def _mlp_inputs(cuda, depth, width, S, N, seed):
    from depth_lidar_nerf_tpu_torch.models.nerf_mlp import NeRFMLP

    g = torch.Generator().manual_seed(seed)
    m = NeRFMLP(depth=depth, width=width, generator=g).to(cuda)
    with torch.no_grad():
        m.sigma.bias += 0.5  # some negative pre-activations, some positive
    params = {k: v.detach() for k, v in m.named_parameters()}
    rng = np.random.default_rng(seed)
    pts = torch.from_numpy(rng.uniform(-1, 1, (3, N * S)).astype(np.float32)).to(cuda)
    vd = torch.nn.functional.normalize(
        torch.from_numpy(rng.normal(size=(N, 3)).astype(np.float32)), dim=-1).T.to(cuda)
    gt = torch.from_numpy(rng.normal(size=(4, N * S)).astype(np.float32)).to(cuda)
    # Per-ray zero suffixes, as cull_eps-masked compositing makes them.
    lengths = torch.from_numpy(rng.integers(0, S + 1, N)).to(cuda)
    live = torch.arange(S, device=cuda)[None] < lengths[:, None]
    return params, pts, vd, gt * live.reshape(1, -1)


def _grad_err(got, ref, depth, width):
    """Worst over the JAX kernel's gradient tensors of max abs error / mean
    abs of the reference."""
    from depth_lidar_nerf_tpu_torch.ops.fused_mlp_t import grad_blocks

    got, ref = (grad_blocks(x, depth, width, 10, (4,)) for x in (got, ref))
    return max(((got[k] - ref[k]).abs().max() / (ref[k].abs().mean() + 1e-12)).item()
               for k in ref)


_TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}
# Kernel 3 against kernel 2: in bfloat16 kernel 3 rounds a ray's view-layer
# gradient sum per 16-sample block (as the JAX culled kernel does), kernel 2
# per ray within a 64-point tile; the CPU twins differ by up to 1.9e-2 there.
_TOL_CULL = {torch.float32: 1e-4, torch.bfloat16: 5e-2}
_MLP_SHAPES = [(4, 256, 64, 37), (8, 256, 128, 20), (8, 128, 128, 9), (4, 128, 16, 50),
               (2, 128, 3, 70)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("depth,width,S,N", _MLP_SHAPES)
def test_fused_fwd_acts_kernel_matches_plain(cuda, depth, width, S, N, dtype):
    from depth_lidar_nerf_tpu_torch.ops import fused_mlp_t as f

    params, pts, vd, _ = _mlp_inputs(cuda, depth, width, S, N, depth + S)
    kw = dict(depth=depth, width=width, multires=10, multires_views=4, dtype=dtype,
              skips=(4,))
    n0 = f.fused_nerf_fwd_acts.launches
    raw, acts = f.fused_nerf_fwd_acts(params, pts, vd, S, **kw)
    torch.cuda.synchronize()
    assert f.fused_nerf_fwd_acts.launches == n0 + 1
    raw_ref, acts_ref = f.fused_nerf_fwd_acts_plain(params, pts, vd, S, **kw)
    tol = _TOL[dtype]
    assert (raw - raw_ref).abs().max().item() <= tol * raw_ref.abs().max().item()
    P = N * S
    for a, b in zip(f.split_acts(acts, P, depth, width),
                    f.split_acts(acts_ref, P, depth, width)):
        assert (a.float() - b.float()).abs().max().item() <= \
            tol * b.float().abs().max().item()


@pytest.mark.parametrize("depth,S", [(4, 64), (8, 128)])
def test_bf16_tile_against_float64_witness(cuda, depth, S):
    """The bfloat16 tile's accuracy, independent of its layout twin: at 256
    rays, summed over the net's layers, kernel 4's activations round
    otherwise than the float64 recomputation from their own inputs no more
    often than float32 products on those inputs do (chip_smoke.py's
    WITNESS_RATIO)."""
    from depth_lidar_nerf_tpu_torch.ops import fused_mlp_t as f

    params, pts, vd, _ = _mlp_inputs(cuda, depth, 256, S, 256, depth * S)
    kw = dict(depth=depth, width=256, multires=10, multires_views=4, skips=(4,))
    _, acts = f.fused_nerf_fwd_acts(params, pts, vd, S, dtype=torch.bfloat16, **kw)
    wit = f.bf16_product_witness(params, pts, vd, acts, S, **kw)
    assert sum(wit["kernel"]) <= sum(wit["float32"])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("depth,width,S,N", _MLP_SHAPES)
def test_fused_bwd_kernels_match_plain(cuda, depth, width, S, N, dtype):
    """Kernels 2 (dense), 3 (culled) and 5 (saved activations; in bfloat16
    the split backward, phases 1 and 2) against their twins; kernel 3 equals
    kernel 2; kernels 2 and 5 are bit-identical run to run."""
    from depth_lidar_nerf_tpu_torch.ops import fused_mlp_t as f

    params, pts, vd, g = _mlp_inputs(cuda, depth, width, S, N, depth * S)
    kw = dict(depth=depth, width=width, multires=10, multires_views=4, dtype=dtype,
              skips=(4,))
    tol = _TOL[dtype]
    n0 = (f.fused_nerf_bwd.launches, f.fused_nerf_bwd_acts.launches,
          f.fused_nerf_bwd_culled.launches, f.grad_reduce.launches,
          f.fused_nerf_bwd_chain.launches, f.bwd_weight_grads.launches)
    dense = f.fused_nerf_bwd(params, pts, vd, g, S, **kw)
    again = f.fused_nerf_bwd(params, pts, vd, g, S, **kw)
    _, acts = f.fused_nerf_fwd_acts(params, pts, vd, S, **kw)
    from_acts = f.fused_nerf_bwd_acts(params, pts, vd, g, acts, S, **kw)
    again5 = f.fused_nerf_bwd_acts(params, pts, vd, g, acts, S, **kw)
    torch.cuda.synchronize()
    assert all(torch.equal(dense[k], again[k]) for k in dense)
    assert all(torch.equal(from_acts[k], again5[k]) for k in from_acts)
    ref = f.fused_nerf_bwd_plain(params, pts, vd, g, S, **kw)
    assert _grad_err(dense, ref, depth, width) <= tol
    assert _grad_err(from_acts, ref, depth, width) <= tol
    n_culled = 0
    if f.cull_blocks_ok(S):
        xb, vb, gb, flags = f.culled_layout(pts, vd, g, S)
        culled = f.fused_nerf_bwd_culled(params, xb, vb, gb, f.SAMPLE_BLOCK, flags, **kw)
        torch.cuda.synchronize()
        assert 0 < int(flags.sum()) < flags.numel()
        ref_c = f.fused_nerf_bwd_plain(params, xb, vb, gb, f.SAMPLE_BLOCK, flags=flags,
                                       **kw)
        assert _grad_err(culled, ref_c, depth, width) <= tol
        assert _grad_err(culled, dense, depth, width) <= _TOL_CULL[dtype]
        n_culled = 1
    split = int(dtype == torch.bfloat16)  # one chunk: one launch of each phase
    assert (f.fused_nerf_bwd.launches, f.fused_nerf_bwd_acts.launches,
            f.fused_nerf_bwd_culled.launches, f.grad_reduce.launches,
            f.fused_nerf_bwd_chain.launches, f.bwd_weight_grads.launches) == \
        (n0[0] + 2, n0[1] + 2, n0[2] + n_culled, n0[3] + 4 + n_culled,
         n0[4] + 2 * split, n0[5] + 2 * split)


@pytest.mark.parametrize("P,shapes", [
    (4096, [(256, 256, 256, 256)]),                   # a trunk layer
    (40000, [(64, 63, 256, 256), (256, 256, 128, 128)]),  # encoding rows; views
    (1000, [(256, 256, 256, 256), (64, 63, 256, 256), (128, 128, 64, 64)]),
    (77, [(128, 128, 128, 128)])])                    # ragged P, one stage
def test_wgrad_kernel_matches_plain(cuda, P, shapes):
    """Phase 2's GEMM (``fused_nerf_wgrad_kernel``) against its twin on one
    table of products (m_op, m_keep, n, ldo): A^T B over P points of
    bfloat16 operands, the encoding operand's padded column dropped (and
    filled with garbage here), split over the points into several partial
    rows. Both sum exact bfloat16 products in float32 in other orders:
    within 1e-5 of the largest output."""
    from depth_lidar_nerf_tpu_torch.ops import fused_mlp_t as f

    gen = torch.Generator(device=cuda).manual_seed(P)
    ents, out = [], 0
    for m_op, m_keep, n, ldo in shapes:
        a = torch.randn((P, m_op), device=cuda, generator=gen).to(torch.bfloat16)
        b = torch.randn((P, n), device=cuda, generator=gen).to(torch.bfloat16)
        ents.append((a, b, m_keep, out, ldo))
        out += m_keep * ldo + 4
    part = torch.zeros((264, out + 4), device=cuda)
    n0 = f.bwd_weight_grads.launches
    f.bwd_weight_grads(ents, part, P)
    torch.cuda.synchronize()
    assert f.bwd_weight_grads.launches == n0 + 1
    rows = f._wgrad_splits(ents, P, part.device)
    assert P < 1000 or rows > 1
    assert not part[rows:].any()
    ref = torch.zeros((1, out + 4), device=cuda)
    f.bwd_weight_grads_plain(ents, ref)
    got = part.sum(0)
    assert (got - ref[0]).abs().max().item() <= 1e-5 * ref.abs().max().item()
    for a, b, m_keep, o, ldo in ents:  # nothing past m_keep rows, n columns
        blk = got[o:o + m_keep * ldo].view(m_keep, ldo)
        assert not blk[:, b.shape[1]:].any()


@pytest.mark.parametrize("depth,S,N,sem", [(4, 64, 37, False), (8, 128, 20, True)])
def test_split_backward_chunks_on_card(cuda, monkeypatch, depth, S, N, sem):
    """Kernels 5 and 8 in bfloat16 over chunks of 1,024 points (the last
    ragged): against their twins at _TOL, bit-identical run to run, and
    within float32 rounding of the one-chunk run (only the order of the
    partial sums moves)."""
    from depth_lidar_nerf_tpu_torch.ops import fused_mlp_t as f

    dtype = torch.bfloat16
    kw = dict(depth=depth, width=256, multires=10, multires_views=4, dtype=dtype,
              skips=(4,))
    if sem:
        params, pts, vd, g, gsem = _sem_inputs(cuda, depth, 256, S, N, 19, depth)
        _, acts, _, sem_acts = f.fused_nerf_fwd_acts_sem(params, pts, vd, S, **kw)

        def run():
            return f.fused_nerf_bwd_acts_sem(params, pts, vd, g, gsem, acts, sem_acts,
                                             S, **kw)
        ref = f.fused_nerf_bwd_acts_sem_plain(params, pts, vd, g, gsem, acts,
                                              sem_acts, S, **kw)
    else:
        params, pts, vd, g = _mlp_inputs(cuda, depth, 256, S, N, depth)
        _, acts = f.fused_nerf_fwd_acts(params, pts, vd, S, **kw)

        def run():
            return f.fused_nerf_bwd_acts(params, pts, vd, g, acts, S, **kw)
        ref = f.fused_nerf_bwd_acts_plain(params, pts, vd, g, acts, S, **kw)
    whole = run()
    monkeypatch.setattr(f, "BWD_CHUNK", 1024)
    n0 = f.fused_nerf_bwd_chain.launches
    got, again = run(), run()
    torch.cuda.synchronize()
    assert f.fused_nerf_bwd_chain.launches == n0 + 2 * -(-N * S // 1024)
    assert all(torch.equal(got[k], again[k]) for k in got)
    assert _sem_grad_err(got, ref, depth, 256) <= _TOL[dtype]
    for k in got:
        assert (got[k] - whole[k]).abs().max().item() <= \
            1e-5 * whole[k].abs().max().item(), k


@pytest.mark.parametrize("depth,S,N", [(4, 64, 37), (8, 128, 20)])
def test_sem_bwd_tc_chain_on_card(cuda, depth, S, N):
    """Kernel 8 in bfloat16, its chain's input products on the tensor
    cores, within its limit of the twin (chip_smoke.py SEM_TOL),
    bit-identical run to run."""
    import chip_smoke as cs
    from depth_lidar_nerf_tpu_torch.ops import fused_mlp_t as f

    kw = dict(depth=depth, width=256, multires=10, multires_views=4,
              dtype=torch.bfloat16, skips=(4,))
    params, pts, vd, g, gsem = _sem_inputs(cuda, depth, 256, S, N, 19, depth + S)
    _, acts, _, sem_acts = f.fused_nerf_fwd_acts_sem(params, pts, vd, S, **kw)
    args = (params, pts, vd, g, gsem, acts, sem_acts, S)
    got, again = (f.fused_nerf_bwd_acts_sem(*args, **kw) for _ in range(2))
    torch.cuda.synchronize()
    ref = f.fused_nerf_bwd_acts_sem_plain(*args, **kw)
    assert _sem_grad_err(got, ref, depth, 256) <= \
        cs.SEM_TOL["bfloat16"]["fused_nerf_bwd_acts_sem"]
    assert all(torch.equal(got[k], again[k]) for k in got)


@pytest.mark.parametrize("depth,S", [(4, 64), (8, 128)])
def test_sem_bwd_witness_on_card(cuda, depth, S):
    """Kernel 8's chain against the float64 witness, with the semantic
    head's ray rows: at 256 rays, summed over the layers, its cotangents
    round otherwise than float64 products of their own inputs no more often
    than float32 products do (chip_smoke.py's WITNESS_RATIO)."""
    import chip_smoke as cs
    from depth_lidar_nerf_tpu_torch.ops import fused_mlp_t as f

    bf = torch.bfloat16
    kw = dict(depth=depth, width=256, multires=10, multires_views=4, skips=(4,))
    params, pts, vd, g, gsem = _sem_inputs(cuda, depth, 256, S, 256, 19, depth * S + 2)
    _, acts, _, sem_acts = f.fused_nerf_fwd_acts_sem(params, pts, vd, S, dtype=bf, **kw)
    grads = f.fused_nerf_bwd_acts_sem(params, pts, vd, g, gsem, acts, sem_acts, S,
                                      dtype=bf, **kw)
    _, dfeat_ray = f.sem_head_bwd_plain(gsem, sem_acts, f.pack_sem(params, bf, cuda), S)
    part = torch.zeros((132, 10 ** 6), device=cuda)
    cot = f.fused_nerf_bwd_chain(params, pts.contiguous(), vd.contiguous(), g, acts,
                                 S, 0, 256 * S, part, dtype=bf, dfeat_ray=dfeat_ray,
                                 **kw)
    wit = f.bwd_product_witness(params, g, acts, cot, grads, S, depth=depth,
                                width=256, multires=10, skips=(4,),
                                dfeat_ray=dfeat_ray)
    assert sum(wit["kernel"]) <= cs.WITNESS_RATIO * sum(wit["float32"]), wit
    assert all(np.isfinite(v) for v in wit["wgrad_kernel"].values())


@pytest.mark.parametrize("depth,S", [(4, 64), (8, 128)])
def test_bwd_witness_on_card(cuda, depth, S):
    """The bfloat16 backward's accuracy, independent of its float32 twin: at
    256 rays, summed over the layers, phase 1's cotangents round otherwise
    than float64 products of their own inputs no more often than float32
    products do (chip_smoke.py's WITNESS_RATIO); the weight gradients'
    errors against float64 products are reported beside float32's."""
    from depth_lidar_nerf_tpu_torch.ops import fused_mlp_t as f

    params, pts, vd, g = _mlp_inputs(cuda, depth, 256, S, 256, depth * S + 1)
    kw = dict(depth=depth, width=256, multires=10, multires_views=4, skips=(4,))
    bf = torch.bfloat16
    _, acts = f.fused_nerf_fwd_acts(params, pts, vd, S, dtype=bf, **kw)
    grads = f.fused_nerf_bwd_acts(params, pts, vd, g, acts, S, dtype=bf, **kw)
    part = torch.zeros((132, 10 ** 6), device=cuda)
    cot = f.fused_nerf_bwd_chain(params, pts.contiguous(), vd.contiguous(), g, acts,
                                 S, 0, 256 * S, part, dtype=bf, **kw)
    wit = f.bwd_product_witness(params, g, acts, cot, grads, S, depth=depth,
                                width=256, multires=10, skips=(4,))
    assert sum(wit["kernel"]) <= sum(wit["float32"])
    assert all(np.isfinite(v) for v in wit["wgrad_kernel"].values())


@pytest.mark.parametrize("B", [2, 9, 63, 64, 129])
@pytest.mark.parametrize("N", [1, 31, 33, 320, 16384, 33088])
def test_inverse_cdf_kernel_matches_plain(cuda, N, B):
    """Kernel 14 equals its twin bit for bit (the same float32 operations
    in the same order) at every V of ``chip_smoke.SAMPLE_PDF_VS``, with
    deterministic and random draws, on contiguous inputs and on the
    renderer's (the weights a slice with row stride B + 1, det's u an
    ``expand`` with row stride 0); one launch a call."""
    import chip_smoke as cs
    from depth_lidar_nerf_tpu_torch.ops import sampling_cuda as s

    for V in cs.SAMPLE_PDF_VS:
        for det in (True, False):
            for layout in ("contiguous", "renderer"):
                bins, w, u = cs.sample_pdf_inputs(cuda, N, B, V, det, layout,
                                                  seed=N + B + V)
                n0 = s.inverse_cdf.launches
                got = s.inverse_cdf(bins, w, u)
                torch.cuda.synchronize()
                assert s.inverse_cdf.launches == n0 + 1
                ref = s.inverse_cdf_plain(bins, w, u)
                assert torch.equal(got, ref), (
                    V, det, layout, (got - ref).abs().max().item())


@pytest.mark.parametrize("det", [True, False])
@pytest.mark.parametrize("B", [9, 63, 129])
def test_inverse_cdf_u_one_above_one(cuda, B, det):
    """Draws u = 1 on rays whose sequential float32 CDF ends above 1.0 and
    whose last bin holds the 1e-5 floor alone: the reference puts the
    sample a whole bin below ``bins[B-1]``. The kernel equals its twin
    there bit for bit."""
    import chip_smoke as cs
    from depth_lidar_nerf_tpu_torch.ops import sampling_cuda as s

    bins, w, u = cs.sample_pdf_inputs(cuda, 4096, B, 64, det, "renderer",
                                      seed=B, u_one=True)
    assert (cs.sequential_cdf_np(w.cpu().numpy())[:, -1] > 1.0).all()
    got = s.inverse_cdf(bins, w, u)
    ref = s.inverse_cdf_plain(bins, w, u)
    assert torch.equal(got, ref)
    if B == 63:  # the last bin's mass ~1e-7 < 1e-5: the guard fires
        last = (bins[:, -1] - got[:, -1]) / (bins[:, -1] - bins[:, -2])
        assert (last > 0.99).all()


def test_inverse_cdf_refuses_what_the_kernel_does_not_take(cuda):
    """A last dimension with a stride other than 1, a dtype other than
    float32 and inputs on several devices raise; nothing launches."""
    import chip_smoke as cs
    from depth_lidar_nerf_tpu_torch.ops import sampling_cuda as s

    bins, w, u = cs.sample_pdf_inputs(cuda, 64, 9, 16, False)
    n0 = s.inverse_cdf.launches
    with pytest.raises(ValueError, match="stride"):
        s.inverse_cdf(bins, w, u.t().contiguous().t())
    with pytest.raises(ValueError, match="stride"):
        s.inverse_cdf(bins.t().contiguous().t(), w, u)
    with pytest.raises(ValueError, match="float32"):
        s.inverse_cdf(bins.double(), w, u)
    with pytest.raises(ValueError, match="float32"):
        s.inverse_cdf(bins, w.half(), u)
    with pytest.raises(ValueError, match="several devices"):
        s.inverse_cdf(bins, w.cpu(), u)
    assert s.inverse_cdf.launches == n0


@pytest.mark.parametrize("det", [True, False])
def test_sample_pdf_reads_renderer_inputs_without_copies(cuda, det):
    """One ``sample_pdf_cuda`` call on the renderer's strided inputs (the
    coarse weights' slice ``[..., 1:-1]``; with ``det`` the draws an
    ``expand``) under torch.profiler: ``sample_pdf_kernel`` launched once,
    no copy."""
    from torch.profiler import ProfilerActivity, profile

    import chip_smoke as cs
    from depth_lidar_nerf_tpu_torch.ops import sampling_cuda as s

    bins, w, _ = cs.sample_pdf_inputs(cuda, 32768, 63, 64, det, "renderer")
    assert w.stride() == (64, 1)

    def call():
        return s.sample_pdf_cuda(bins, w, 64, det=det,
                                 generator=torch.Generator(device=cuda).manual_seed(0))

    call()  # the build
    torch.cuda.synchronize()
    n0 = s.inverse_cdf.launches
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        call()
        torch.cuda.synchronize()
    assert s.inverse_cdf.launches == n0 + 1
    events = prof.key_averages()
    assert sum(e.count for e in events if "sample_pdf_kernel" in e.key) == 1
    copies = [e.key for e in events
              if "copy_" in e.key or "contiguous" in e.key or "copy_kernel" in e.key]
    assert not copies, copies


@pytest.mark.parametrize("flag", [False, True])
def test_render_on_card_always_runs_both_kernels(cuda, flag):
    """On the card the renderer takes both kernels whatever
    ``use_fused_mlp`` and ``use_pallas_sampling`` say."""
    from depth_lidar_nerf_tpu_torch.ops import fused_mlp_t as f
    from depth_lidar_nerf_tpu_torch.ops import sampling_cuda as s
    from depth_lidar_nerf_tpu_torch.ops.rays import camera_rays
    from depth_lidar_nerf_tpu_torch.render.renderer import (make_rays,
                                                            render_rays)
    from depth_lidar_nerf_tpu_torch.train.config import (TrainConfig,
                                                         render_config_from)
    from depth_lidar_nerf_tpu_torch.train.state import build_models

    cfg = TrainConfig(netdepth=4, netdepth_fine=8, netwidth=128,
                      netwidth_fine=128, N_samples=32, N_importance=32,
                      use_viewdirs=True, dataset_type="llff",
                      use_fused_mlp=flag, use_pallas_sampling=flag)
    rcfg = render_config_from(cfg, 0, 0.0, 1.0).eval_mode()
    ms = build_models(cfg, rcfg, device=cuda)
    ro, rd = camera_rays(6, 10, 8.0, torch.eye(4, device=cuda)[:3])
    n0 = (f.fused_nerf_fwd.launches, s.inverse_cdf.launches)
    with torch.no_grad():
        out = render_rays(ms.coarse, ms.fine,
                          make_rays(ro, rd, rcfg, 6, 10, 8.0), rcfg)
    torch.cuda.synchronize()
    assert (f.fused_nerf_fwd.launches - n0[0],
            s.inverse_cdf.launches - n0[1]) == (2, 1)
    assert torch.isfinite(out["rgb_map"]).all()


@pytest.mark.parametrize("cull_eps", [1e-4, 0.0])
def test_train_step_launches_each_kernel_once(cuda, cull_eps):
    """One training step on the card runs kernel 1 (coarse forward), kernel 3
    (coarse culled backward; kernel 2 at cull_eps=0), kernels 4 and 5 (fine
    pass), sampling once, and two gradient reductions."""
    from depth_lidar_nerf_tpu_torch.data.synthetic import draw_scene
    from depth_lidar_nerf_tpu_torch.ops import fused_mlp_t as f
    from depth_lidar_nerf_tpu_torch.ops import sampling_cuda as s
    from depth_lidar_nerf_tpu_torch.train.config import (TrainConfig,
                                                         render_config_from)
    from depth_lidar_nerf_tpu_torch.train.state import (build_models,
                                                        init_train_state)
    from depth_lidar_nerf_tpu_torch.train.step import make_train_step
    from depth_lidar_nerf_tpu_torch.train.tables import (build_depth_table,
                                                         build_rgb_table)

    sc = draw_scene(n_images=2, H=16, W=24, focal=20.0, n_depth_points=50,
                    backdrop=True)
    cfg = TrainConfig(dataset_type="llff", N_rand=256, N_samples=32,
                      N_importance=32, netdepth=4, netwidth=128, netdepth_fine=4,
                      netwidth_fine=128, use_viewdirs=True, no_ndc=True,
                      raw_noise_std=1.0, colmap_depth=True, depth_loss=True,
                      compute_dtype="bfloat16", cull_eps=cull_eps)
    rcfg = render_config_from(cfg, 0, sc.near, sc.far)
    models = build_models(cfg, rcfg)
    state = init_train_state(cfg, models)
    tables = (build_rgb_table(sc.images, sc.poses, [0, 1], *sc.hwf, rcfg),
              build_depth_table(sc.depth_gts, sc.poses, [0, 1], *sc.hwf, rcfg))
    step = make_train_step(cfg, rcfg, models, sc.hwf)
    gen = torch.Generator(device=cuda).manual_seed(0)
    fns = (f.fused_nerf_fwd, f.fused_nerf_bwd, f.fused_nerf_bwd_culled,
           f.fused_nerf_fwd_acts, f.fused_nerf_bwd_acts, s.inverse_cdf,
           f.grad_reduce, f.fused_nerf_bwd_chain, f.bwd_weight_grads)
    n0 = [fn.launches for fn in fns]
    m = step(state, *tables, gen)
    torch.cuda.synchronize()
    culled = cull_eps > 0
    # Kernel 5 in bfloat16: 256 rays x 64 samples are one chunk of the split.
    assert [fn.launches - n for fn, n in zip(fns, n0)] == \
        [1, int(not culled), int(culled), 1, 1, 1, 2, 1, 1]
    assert all(torch.isfinite(v) for v in m.values())


def _sem_inputs(cuda, depth, width, S, N, C, seed):
    """Seeded weights with a semantic head (random biases, so the head's
    S-scaled bias terms count), points, view directions, a raw cotangent
    and a logit cotangent that is zero on the second half of the rays (as
    the step's depth rays give)."""
    from depth_lidar_nerf_tpu_torch.models.nerf_mlp import NeRFMLP

    g = torch.Generator().manual_seed(seed)
    m = NeRFMLP(depth=depth, width=width, num_semantic_classes=C,
                generator=g).to(cuda)
    with torch.no_grad():
        for name, p in m.named_parameters():
            if name.endswith("bias"):
                p.copy_(0.1 * torch.randn(p.shape, generator=g))
        m.sigma.bias += 0.5
    params = {k: v.detach() for k, v in m.named_parameters()}
    rng = np.random.default_rng(seed)
    pts = torch.from_numpy(rng.uniform(-1, 1, (3, N * S)).astype(np.float32)).to(cuda)
    vd = torch.nn.functional.normalize(
        torch.from_numpy(rng.normal(size=(N, 3)).astype(np.float32)), dim=-1).T.to(cuda)
    gt = torch.from_numpy(rng.normal(size=(4, N * S)).astype(np.float32)).to(cuda)
    gsem = torch.from_numpy(rng.normal(size=(N, C)).astype(np.float32)).to(cuda)
    gsem[N // 2:] = 0.0
    return params, pts, vd, gt, gsem


def _sem_grad_err(got, ref, depth, width):
    from depth_lidar_nerf_tpu_torch.ops.fused_mlp_t import grad_blocks

    got, ref = (grad_blocks(x, depth, width, 10, (4,)) for x in (got, ref))
    assert set(got) == set(ref)
    return max(((got[k] - ref[k]).abs().max() / (ref[k].abs().mean() + 1e-12)).item()
               for k in ref)


_SEM_SHAPES = [(4, 256, 64, 37, 19), (8, 256, 128, 20, 19), (8, 128, 128, 9, 4),
               (4, 128, 16, 50, 7), (2, 128, 4, 70, 5), (8, 256, 256, 3, 19)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("depth,width,S,N,C", _SEM_SHAPES)
def test_fused_sem_fwd_kernels_match_plain(cuda, depth, width, S, N, C, dtype):
    """Kernels 6 and 7 and the semantic head kernel against their twins;
    kernels 6 and 7 give the same raw and logits."""
    from depth_lidar_nerf_tpu_torch.ops import fused_mlp_t as f

    params, pts, vd, _, _ = _sem_inputs(cuda, depth, width, S, N, C, depth + S)
    kw = dict(depth=depth, width=width, multires=10, multires_views=4, dtype=dtype,
              skips=(4,))
    n0 = (f.fused_nerf_fwd_sem.launches, f.fused_nerf_fwd_acts_sem.launches,
          f.sem_head.launches)
    raw6, sem6 = f.fused_nerf_fwd_sem(params, pts, vd, S, **kw)
    raw7, acts, sem7, sem_acts = f.fused_nerf_fwd_acts_sem(params, pts, vd, S, **kw)
    torch.cuda.synchronize()
    assert (f.fused_nerf_fwd_sem.launches, f.fused_nerf_fwd_acts_sem.launches,
            f.sem_head.launches) == (n0[0] + 1, n0[1] + 1, n0[2] + 2)
    assert torch.equal(raw6, raw7) and torch.equal(sem6, sem7)
    raw_ref, acts_ref, sem_ref, sem_acts_ref = f.fused_nerf_fwd_acts_sem_plain(
        params, pts, vd, S, **kw)
    tol = _TOL[dtype]
    assert (raw7 - raw_ref).abs().max().item() <= tol * raw_ref.abs().max().item()
    assert (sem7 - sem_ref).abs().max().item() <= tol * sem_ref.abs().max().item()
    for a, b in zip(f.split_acts(acts, N * S, depth, width),
                    f.split_acts(acts_ref, N * S, depth, width)):
        assert (a.float() - b.float()).abs().max().item() <= \
            tol * b.float().abs().max().item()
    assert (sem_acts.float() - sem_acts_ref.float()).abs().max().item() <= \
        tol * sem_acts_ref.float().abs().max().item()
    # The head kernel alone, on partial sums of kernel 7's feature activation.
    feat = f.split_acts(acts, N * S, depth, width)[depth].float()
    fpart = f.sem_tile_partials_plain(feat, S)
    sem = f.pack_sem(params, dtype, cuda)
    logits, head_acts = f.sem_head(fpart, sem, N, S, save=True)
    torch.cuda.synchronize()
    logits_ref, head_acts_ref = f.sem_head_plain(fpart, sem, N, S)
    assert (logits - logits_ref).abs().max().item() <= \
        tol * logits_ref.abs().max().item()
    assert (head_acts.float() - head_acts_ref.float()).abs().max().item() <= \
        tol * head_acts_ref.float().abs().max().item()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("depth,width,S,N,C", _SEM_SHAPES)
def test_fused_sem_bwd_kernel_matches_plain(cuda, depth, width, S, N, C, dtype):
    """Kernel 8 and the head's backward kernel against their twins, on
    kernel 7's activations; kernel 8 bit-identical run to run."""
    from depth_lidar_nerf_tpu_torch.ops import fused_mlp_t as f

    params, pts, vd, g, gsem = _sem_inputs(cuda, depth, width, S, N, C, depth * S)
    kw = dict(depth=depth, width=width, multires=10, multires_views=4, dtype=dtype,
              skips=(4,))
    _, acts, _, sem_acts = f.fused_nerf_fwd_acts_sem(params, pts, vd, S, **kw)
    n0 = (f.fused_nerf_bwd_acts_sem.launches, f.sem_head_bwd.launches,
          f.grad_reduce.launches, f.fused_nerf_bwd_chain.launches,
          f.bwd_weight_grads.launches)
    got = f.fused_nerf_bwd_acts_sem(params, pts, vd, g, gsem, acts, sem_acts, S, **kw)
    again = f.fused_nerf_bwd_acts_sem(params, pts, vd, g, gsem, acts, sem_acts, S, **kw)
    sem = f.pack_sem(params, dtype, cuda)
    flat, dfeat_ray = f.sem_head_bwd(gsem, sem_acts, sem, S)
    torch.cuda.synchronize()
    split = 2 * int(dtype == torch.bfloat16)  # two calls of one chunk each
    assert (f.fused_nerf_bwd_acts_sem.launches, f.sem_head_bwd.launches,
            f.grad_reduce.launches, f.fused_nerf_bwd_chain.launches,
            f.bwd_weight_grads.launches) == \
        (n0[0] + 2, n0[1] + 3, n0[2] + 5, n0[3] + split, n0[4] + split)
    assert set(got) == set(params)
    assert all(torch.equal(got[k], again[k]) for k in got)
    ref = f.fused_nerf_bwd_acts_sem_plain(params, pts, vd, g, gsem, acts, sem_acts, S,
                                          **kw)
    assert _sem_grad_err(got, ref, depth, width) <= _TOL[dtype]
    flat_ref, dfeat_ref = f.sem_head_bwd_plain(gsem, sem_acts, sem, S)
    head, head_ref = (f.unpack_sem_grads(x, width, C) for x in (flat, flat_ref))
    for k in head_ref:
        err = (head[k] - head_ref[k]).abs().max() / (head_ref[k].abs().mean() + 1e-12)
        assert err.item() <= _TOL[dtype], k
    assert (dfeat_ray.float() - dfeat_ref.float()).abs().max().item() <= \
        _TOL[dtype] * dfeat_ref.float().abs().max().item()
    assert not dfeat_ray[N // 2:].any()  # zero logit cotangent, zero rows


def test_semantic_train_step_launches(cuda):
    """One semantic training step on the card: kernels 7 and 8 for both
    passes (with their head kernels), sampling once, no kernel of kernels
    1-5, four gradient reductions (two trunks, two heads)."""
    from depth_lidar_nerf_tpu_torch.data.synthetic import draw_scene
    from depth_lidar_nerf_tpu_torch.ops import fused_mlp_t as f
    from depth_lidar_nerf_tpu_torch.ops import sampling_cuda as s
    from depth_lidar_nerf_tpu_torch.train.config import (TrainConfig,
                                                         render_config_from)
    from depth_lidar_nerf_tpu_torch.train.state import (build_models,
                                                        init_train_state)
    from depth_lidar_nerf_tpu_torch.train.step import make_train_step
    from depth_lidar_nerf_tpu_torch.train.tables import (build_depth_table,
                                                         build_rgb_table)

    sc = draw_scene(n_images=2, H=16, W=24, focal=20.0, n_depth_points=50,
                    backdrop=True, num_classes=19)
    cfg = TrainConfig(dataset_type="llff", N_rand=256, N_samples=32,
                      N_importance=32, netdepth=4, netwidth=128, netdepth_fine=8,
                      netwidth_fine=128, use_viewdirs=True, no_ndc=True,
                      raw_noise_std=1.0, colmap_depth=True, depth_loss=True,
                      semantic_loss=True, semantic_lambda=0.04,
                      compute_dtype="bfloat16", cull_eps=1e-4)
    rcfg = render_config_from(cfg, sc.num_classes, sc.near, sc.far)
    models = build_models(cfg, rcfg)
    state = init_train_state(cfg, models)
    tables = (build_rgb_table(sc.images, sc.poses, [0, 1], *sc.hwf, rcfg,
                              segmentation=sc.segmentation),
              build_depth_table(sc.depth_gts, sc.poses, [0, 1], *sc.hwf, rcfg))
    step = make_train_step(cfg, rcfg, models, sc.hwf)
    gen = torch.Generator(device=cuda).manual_seed(0)
    fns = (f.fused_nerf_fwd, f.fused_nerf_bwd, f.fused_nerf_bwd_culled,
           f.fused_nerf_fwd_acts, f.fused_nerf_bwd_acts, f.fused_nerf_fwd_sem,
           f.fused_nerf_fwd_acts_sem, f.fused_nerf_bwd_acts_sem, f.sem_head,
           f.sem_head_bwd, s.inverse_cdf, f.grad_reduce, f.fused_nerf_bwd_chain,
           f.bwd_weight_grads)
    n0 = [fn.launches for fn in fns]
    m = step(state, *tables, gen)
    torch.cuda.synchronize()
    # Kernel 8's split backward: one chunk a pass.
    assert [fn.launches - n for fn, n in zip(fns, n0)] == \
        [0, 0, 0, 0, 0, 0, 2, 2, 2, 2, 1, 4, 2, 2]
    assert all(torch.isfinite(v) for v in m.values())
    assert {"semantic_loss", "semantic_loss0"} <= set(m)


# Kernels 10 and 11 against their twins, on the three numbers of
# tests/torch_port_q8_helpers.py (max over max, mean over mean, share of
# elements off by more than 1e-5 of the scale), per dtype; the logits on the
# first two. An activation within float32 noise of a .5 boundary rounds to
# the other int8 value in one of the two (their float32 sums run in other
# orders), so the max is loose and the mean and the share carry the check.
# Each about 3x the largest gap measured on an H100 over these shapes: raw
# float32 6.6e-3, 1.2e-5, 1.3e-3; bfloat16 5.6e-3, 1.1e-5, 7.9e-3; logits
# float32 4.5e-4, 1.1e-5; bfloat16 1.5e-3, 1.1e-4.
_Q8_TOL = {torch.float32: (2e-2, 3.5e-5, 4e-3), torch.bfloat16: (1.7e-2, 3.4e-5, 2.4e-2)}
_Q8_LOGIT_TOL = {torch.float32: (1.4e-3, 3.4e-5), torch.bfloat16: (4.6e-3, 3.4e-4)}
# The last five end in a ragged tile (P not a multiple of 64), at W=128 and 256,
# D=2, 4 and 8 skip@4.
_Q8_SHAPES = [(4, 256, 64, 37), (8, 256, 128, 20), (8, 128, 128, 9), (4, 128, 16, 50),
              (2, 128, 4, 70), (4, 256, 16, 37), (8, 256, 16, 45), (8, 128, 32, 75)]


def _q8_gaps(got, ref):
    d = (got.double() - ref.double()).abs()
    scale = ref.double().abs().max()
    return ((d.max() / scale).item(), (d.mean() / ref.double().abs().mean()).item(),
            (d > 1e-5 * scale).double().mean().item())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("depth,width,S,N", _Q8_SHAPES)
def test_fused_q8_kernels_match_plain(cuda, depth, width, S, N, dtype):
    """Kernel 10 and kernel 11 (with the semantic head kernel) against their
    twins; kernel 11's raw equals kernel 10's bit for bit."""
    from depth_lidar_nerf_tpu_torch.ops import fused_mlp_t as f

    params, pts, vd, _, _ = _sem_inputs(cuda, depth, width, S, N, 19, depth * 7 + S)
    trunk = {k: v for k, v in params.items() if not k.startswith("semantic")}
    kw = dict(depth=depth, width=width, multires=10, multires_views=4, dtype=dtype,
              skips=(4,))
    n0 = (f.fused_nerf_fwd_q8.launches, f.fused_nerf_fwd_q8_sem.launches,
          f.sem_head.launches)
    raw10 = f.fused_nerf_fwd_q8(trunk, pts, vd, S, **kw)
    raw11, sem11 = f.fused_nerf_fwd_q8_sem(params, pts, vd, S, **kw)
    torch.cuda.synchronize()
    assert (f.fused_nerf_fwd_q8.launches, f.fused_nerf_fwd_q8_sem.launches,
            f.sem_head.launches) == (n0[0] + 1, n0[1] + 1, n0[2] + 1)
    assert torch.equal(raw10, raw11)
    raw_ref, sem_ref = f.fused_nerf_fwd_q8_sem_plain(params, pts, vd, S, **kw)
    gaps = _q8_gaps(raw10, raw_ref)
    assert all(g <= t for g, t in zip(gaps, _Q8_TOL[dtype])), gaps
    lg = _q8_gaps(sem11, sem_ref)[:2]
    assert all(g <= t for g, t in zip(lg, _Q8_LOGIT_TOL[dtype])), lg


def test_fused_q8_refuses_autograd_on_card(cuda):
    """Under autograd the int8 entry points raise before any launch."""
    from depth_lidar_nerf_tpu_torch.models.nerf_mlp import NeRFMLP
    from depth_lidar_nerf_tpu_torch.ops import fused_mlp_t as f

    m = NeRFMLP(depth=4, width=128).to(cuda)
    params = dict(m.named_parameters())
    ro, rd = torch.randn(8, 3, device=cuda), torch.randn(8, 3, device=cuda)
    vd = torch.nn.functional.normalize(rd, dim=-1)
    z = torch.sort(torch.rand(8, 16, device=cuda), -1).values
    kw = dict(depth=4, width=128, multires=10, multires_views=4)
    n0 = f.fused_nerf_fwd_q8.launches
    with pytest.raises(RuntimeError, match="eval only"):
        f.fused_nerf_apply_rays_q8(params, ro, rd, vd, z, **kw)
    assert f.fused_nerf_fwd_q8.launches == n0
    with torch.no_grad():
        raw = f.fused_nerf_apply_rays_q8(params, ro, rd, vd, z, **kw)
    torch.cuda.synchronize()
    assert f.fused_nerf_fwd_q8.launches == n0 + 1 and raw.shape == (4, 8, 16)


def _serving_models(cuda, semantic=False, **extra):
    from depth_lidar_nerf_tpu_torch.train.config import (TrainConfig,
                                                         eval_render_config,
                                                         render_config_from)
    from depth_lidar_nerf_tpu_torch.train.state import build_models

    cfg = TrainConfig(netdepth=4, netdepth_fine=8, netwidth=128, netwidth_fine=128,
                      N_samples=32, N_importance=32, use_viewdirs=True,
                      dataset_type="llff", compute_dtype="bfloat16", **extra)
    rcfg = render_config_from(cfg, 19 if semantic else 0, 0.0, 1.0)
    ms = build_models(cfg, rcfg, device=cuda)
    with torch.no_grad():
        for m in ms.nerfs():
            m.sigma.weight *= 20.0
    return ms, rcfg, eval_render_config(cfg, rcfg)


@pytest.mark.parametrize("semantic", [False, True])
def test_int8_frame_launches(cuda, semantic):
    """An int8 frame runs kernel 10 (kernel 11 and its head for a semantic
    stack) on both passes of each tile, sampling once a tile, and no bf16
    MLP kernel; its rgb is within JAX's int8 atol (0.03) of the bf16
    frame."""
    from depth_lidar_nerf_tpu_torch.ops import fused_mlp_t as f
    from depth_lidar_nerf_tpu_torch.ops import sampling_cuda as s
    from depth_lidar_nerf_tpu_torch.render.renderer import render_image

    ms, rcfg, ecfg = _serving_models(cuda, semantic, render_int8=True)
    assert ecfg.render_int8 and not rcfg.render_int8
    fns = (f.fused_nerf_fwd, f.fused_nerf_fwd_sem, f.fused_nerf_fwd_q8,
           f.fused_nerf_fwd_q8_sem, f.sem_head, s.inverse_cdf)
    n0 = [fn.launches for fn in fns]
    out = render_image(ms.coarse, ms.fine, 10, 12, 9.0, torch.eye(4)[:3], ecfg,
                       tile=64)
    torch.cuda.synchronize()
    n_tiles = 2  # 120 rays in tiles of 64
    want = ([0, 0, 0, 2 * n_tiles, 2 * n_tiles, n_tiles] if semantic
            else [0, 0, 2 * n_tiles, 0, 0, n_tiles])
    assert [fn.launches - n for fn, n in zip(fns, n0)] == want
    ref = render_image(ms.coarse, ms.fine, 10, 12, 9.0, torch.eye(4)[:3], rcfg,
                       tile=64)
    for k in ("rgb_map", "acc_map"):
        assert torch.isfinite(out[k]).all()
        assert (out[k] - ref[k]).abs().mean().item() <= 0.03, k


def test_downsampled_int8_frame_on_card(cuda):
    """``render_coarse_downsample=2`` with int8: kernel 10 once on the
    (H/2, W/2) coarse pass and once a full-resolution tile, sampling once;
    the frame matches the same render on the CPU twins within the int8
    render tolerance of the CPU tests (max over max 1.1e-3 is for float32;
    here bfloat16 on both sides, mean abs within 0.03 as JAX's atol)."""
    from depth_lidar_nerf_tpu_torch.ops import fused_mlp_t as f
    from depth_lidar_nerf_tpu_torch.ops import sampling_cuda as s
    from depth_lidar_nerf_tpu_torch.render.renderer import render_image

    ms, rcfg, ecfg = _serving_models(cuda, render_int8=True,
                                     render_coarse_downsample=2)
    fns = (f.fused_nerf_fwd, f.fused_nerf_fwd_q8, s.inverse_cdf)
    n0 = [fn.launches for fn in fns]
    out = render_image(ms.coarse, ms.fine, 10, 12, 9.0, torch.eye(4)[:3], ecfg,
                       tile=64)
    torch.cuda.synchronize()
    assert [fn.launches - n for fn, n in zip(fns, n0)] == [0, 1 + 2, 1]
    assert set(out) == {"rgb_map", "disp_map", "acc_map", "depth_map", "rgb0",
                        "depth_map0", "acc0"}
    cpu = [m.to("cpu") for m in ms.nerfs()]
    ref = render_image(cpu[0], cpu[1], 10, 12, 9.0, torch.eye(4)[:3], ecfg,
                       tile=64, device="cpu")
    for k in ("rgb_map", "acc_map", "rgb0"):
        assert torch.isfinite(out[k]).all()
        assert (out[k].cpu() - ref[k]).abs().mean().item() <= 0.03, k


_PACKED_SHAPES = [(4, 256, 64, 300), (2, 256, 8, 1000), (1, 128, 128, 40)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("depth,width,S,N", _PACKED_SHAPES)
def test_packed_kernels_match_plain(cuda, depth, width, S, N, dtype):
    """Kernels 12 and 13 (the packed-lane MLP) against their twins, on
    ``fused_nerf_apply_raw``'s padded input."""
    from depth_lidar_nerf_tpu_torch.models.nerf_mlp import NeRFMLP
    from depth_lidar_nerf_tpu_torch.ops import fused_mlp as fm

    g = torch.Generator().manual_seed(depth * 10 + S)
    m = NeRFMLP(depth=depth, width=width, generator=g).to(cuda)
    with torch.no_grad():
        m.sigma.bias += 0.5
    params = {k: v.detach() for k, v in m.named_parameters()}
    rng = np.random.default_rng(S)
    Nf = N + (-N) % (fm.TILE // S)
    pts = torch.from_numpy(rng.uniform(-1, 1, (Nf, S, 3)).astype(np.float32)).to(cuda)
    vd = torch.nn.functional.normalize(torch.from_numpy(
        rng.normal(size=(Nf, 3)).astype(np.float32)), dim=-1).to(cuda)
    x = fm.pack_encoding(pts, vd, 10, 4, dtype)
    ws = fm.pack_params(params, depth, 63, 27, dtype, cuda)
    gt = torch.from_numpy(rng.normal(size=(Nf * S, 8)).astype(np.float32)).to(cuda)
    n12, n13 = fm.fused_packed_fwd.launches, fm.fused_packed_bwd.launches
    got = fm.fused_packed_fwd(ws, x, depth=depth, e_p=63, e_v=27, dtype=dtype)
    dws = fm.fused_packed_bwd(ws, x, gt, depth=depth, e_p=63, e_v=27, dtype=dtype)
    torch.cuda.synchronize()
    assert (fm.fused_packed_fwd.launches, fm.fused_packed_bwd.launches) == (n12 + 1, n13 + 1)
    ref = fm.fused_packed_fwd_plain(ws, x, depth, dtype, e_p=63, e_v=27)
    tol = 1e-4 if dtype == torch.float32 else 2e-2
    assert (got - ref).abs().max().item() <= tol * ref.abs().max().item()
    unpack = lambda d: fm.unpack_grads(d, params, depth, 63, 27)  # noqa: E731
    got_g, ref_g = unpack(dws), unpack(fm.fused_packed_bwd_plain(ws, x, gt, depth, dtype,
                                                                 e_p=63, e_v=27))
    err = max(((got_g[k] - ref_g[k]).abs().max() / (ref_g[k].abs().mean() + 1e-12)).item()
              for k in ref_g)
    assert err <= (2e-4 if dtype == torch.float32 else 2e-2), err


@pytest.mark.parametrize("depth", [4, 2])
@pytest.mark.parametrize("shape", [(8192, 64), (1000, 8)])
def test_packed_bf16_kernels_match_layout_twins(cuda, depth, shape):
    """Kernels 12 and 13 in bfloat16 (the tensor-core tile and the split
    backward) against their layout twins, which form each product in the
    kernels' 16-k runs, within chip_smoke.py's PACKED_TOL, on its phase-3
    inputs (``chip_smoke.packed_inputs``: its PACKED_SHAPES)."""
    import chip_smoke as cs
    from depth_lidar_nerf_tpu_torch.models.nerf_mlp import NeRFMLP
    from depth_lidar_nerf_tpu_torch.ops import fused_mlp as fm
    from depth_lidar_nerf_tpu_torch.ops import fused_mlp_t as fmt

    bf = torch.bfloat16
    params, pts, vd, gt = cs.packed_inputs(NeRFMLP, fm, cuda, depth, *shape)
    x = fm.pack_encoding(pts, vd, 10, 4, bf)
    ws = fm.pack_params(params, depth, 63, 27, bf, cuda)
    kw = dict(depth=depth, e_p=63, e_v=27, dtype=bf)
    got, dws = fm.fused_packed_fwd(ws, x, **kw), fm.fused_packed_bwd(ws, x, gt, **kw)
    torch.cuda.synchronize()
    twin = fm.fused_packed_fwd_plain(ws, x, depth, bf, e_p=63, e_v=27)
    twin_d = fm.fused_packed_bwd_plain(ws, x, gt, depth, bf, e_p=63, e_v=27)
    e12, mx, mn, _ = cs.packed_gaps(fmt, fm, params, depth, got, twin, dws, twin_d)
    tol = cs.PACKED_TOL["bfloat16"]
    assert e12[1] <= tol[0] and mx <= tol[1] and mn <= tol[2], (e12, mx, mn)


@pytest.mark.parametrize("depth,width", [(4, 256), (1, 128)])
def test_packed_split_on_card(cuda, monkeypatch, depth, width):
    """Kernel 13's bfloat16 split: over chunks of 4,096 points (a ragged
    last one) it launches the chain and phase 2 once a chunk and counts one
    launch of kernel 13, and its gradients stay within PACKED_TOL's max over
    mean of the one-chunk call's; kernel 12's activations (from the chain's recompute)
    and the chain's cotangents round otherwise than float64 products of
    their own inputs no more often than float32 products do
    (WITNESS_RATIO); phase 2 on the chain's buffers is within WGRAD_TOL of
    its twin. Of PACKED_TOL only the max over mean is held here, not the
    mean over mean: at these 300 x 64 rays the sigma bias's gradient, one
    float32 sum of the cotangent's column 3, nearly cancels, and its mean
    over mean read 7.44e-6 (above PACKED_TOL's 3e-6) in both types, the
    earlier float32 FMA kernel included; the smoke's PACKED_SHAPES hold all
    three numbers."""
    import chip_smoke as cs
    from depth_lidar_nerf_tpu_torch.models.nerf_mlp import NeRFMLP
    from depth_lidar_nerf_tpu_torch.ops import fused_mlp as fm
    from depth_lidar_nerf_tpu_torch.ops import fused_mlp_t as fmt

    bf = torch.bfloat16
    m = NeRFMLP(depth=depth, width=width, generator=torch.Generator().manual_seed(depth))
    params = {k: v.detach().to(cuda) for k, v in m.named_parameters()}
    rng = np.random.default_rng(width)
    N, S = 300, 64
    pts = torch.from_numpy(rng.uniform(-1, 1, (N, S, 3)).astype(np.float32)).to(cuda)
    vd = torch.nn.functional.normalize(torch.from_numpy(
        rng.normal(size=(N, 3)).astype(np.float32)), dim=-1).to(cuda)
    x = fm.pack_encoding(pts, vd, 10, 4, bf)
    ws = fm.pack_params(params, depth, 63, 27, bf, cuda)
    g = torch.from_numpy(rng.normal(size=(N * S, 8)).astype(np.float32)).to(cuda)
    kw = dict(depth=depth, e_p=63, e_v=27, dtype=bf)
    whole = fm.fused_packed_bwd(ws, x, g, **kw)
    monkeypatch.setattr(fmt, "BWD_CHUNK", 4096)
    fns = (fm.fused_packed_bwd, fm.fused_packed_chain, fm.packed_wgrad,
           fmt.bwd_weight_grads, fmt.grad_reduce)
    n0 = [f.launches for f in fns]
    chunked = fm.fused_packed_bwd(ws, x, g, **kw)
    torch.cuda.synchronize()
    n_chunks = -(-N * S // 4096)
    assert [f.launches - n for f, n in zip(fns, n0)] == [1, n_chunks, n_chunks, 0, 1]
    # per gradient block, max abs error over mean abs (PACKED_TOL's second)
    got, ref = (fmt.grad_blocks(fm.unpack_grads(d, params, depth, 63, 27), depth, width,
                                10, ()) for d in (chunked, whole))
    mx = max(((got[k] - ref[k]).abs().max() / (ref[k].abs().mean() + 1e-12)).item()
             for k in ref)
    assert mx <= cs.PACKED_TOL["bfloat16"][1], mx

    P = N * S
    kwt = fm.kernel_weights(ws, depth, 63, 27)
    part = torch.zeros((132, -(-kwt.grad_numel // 4) * 4), device=cuda)
    hv = torch.empty((P * width // 2,), dtype=bf, device=cuda)
    acts, cot = fm.fused_packed_chain(ws, x, g, 0, P, part, kw=kwt, hv=hv, **kw)
    for wit in (fm.packed_fwd_witness(ws, x, acts, hv, depth, 63, 27),
                fm.packed_bwd_witness(ws, g, acts, hv, cot, depth)):
        assert sum(wit["kernel"]) <= cs.WITNESS_RATIO * sum(wit["float32"]), wit
    ents = fm.packed_wgrad_entries(x, acts, cot, 0, P, depth, width, 63, 27,
                                   fm.grad_offsets(ws))
    wpart = torch.zeros((fmt._wgrad_splits(ents, P, cuda), part.shape[1]), device=cuda)
    fmt.bwd_weight_grads(ents, wpart, P, counter=fm.packed_wgrad)
    wref = torch.zeros((1, part.shape[1]), device=cuda)
    fmt.bwd_weight_grads_plain(ents, wref)
    assert (wpart.sum(0) - wref[0]).abs().max() <= cs.WGRAD_TOL * wref.abs().max()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("N", [256, 300])
def test_cf_kernel_matches_twin_and_kernel1(cuda, N, dtype, monkeypatch):
    """Kernel 9 on an occluding field: its live blocks equal kernel 1's raw
    on the same points bit for bit, it skips the blocks its twin skips, and
    skipped blocks read (0, 0, 0, -1e10)."""
    from depth_lidar_nerf_tpu_torch.models.nerf_mlp import NeRFMLP
    from depth_lidar_nerf_tpu_torch.ops import fused_mlp_t as f

    S, eps = 128, 1e-4
    g = torch.Generator().manual_seed(N)
    m = NeRFMLP(depth=4, width=256, generator=g).to(cuda)
    with torch.no_grad():
        m.sigma.bias.fill_(30.0)
    params = {k: v.detach() for k, v in m.named_parameters()}
    rng = np.random.default_rng(N)
    rd = torch.from_numpy(rng.normal(size=(N, 3)).astype(np.float32)).to(cuda)
    z = torch.sort(torch.from_numpy(rng.uniform(2, 6, (N, S)).astype(np.float32)),
                   -1).values.to(cuda)
    pts_t = (rd.T[:, :, None] * z[None]).reshape(3, -1).contiguous()
    vd_t = torch.nn.functional.normalize(rd, dim=-1).T.contiguous()
    key = torch.from_numpy(rng.uniform(size=N).astype(np.float32)).to(cuda)
    from depth_lidar_nerf_tpu_torch.ops.compositing import composit_dists
    deltas = composit_dists(z, rd)
    noise = torch.randn((N, S), device=cuda, generator=torch.Generator(
        device=cuda).manual_seed(1))
    kw = dict(depth=4, width=256, multires=10, multires_views=4, dtype=dtype)
    xb, vb, aux, order = f.cf_layout(pts_t, vd_t, key, deltas, noise, S)
    n9 = f.fused_nerf_fwd_cf.launches
    out = f.fused_nerf_fwd_cf(params, xb, vb, aux, S, 0.5 * eps, **kw)
    dense = f.fused_nerf_fwd(params, xb, vb, f.SAMPLE_BLOCK, **kw)
    torch.cuda.synchronize()
    assert f.fused_nerf_fwd_cf.launches == n9 + 1
    dead = (out[3].reshape(-1, 2048) == -1e10).all(1)
    live = ~dead.repeat_interleave(2048)
    assert torch.equal(out[:, live], dense[:, live])
    assert (out[:3, ~live] == 0).all() and (out[3, ~live] == -1e10).all()
    twin = f.fused_nerf_fwd_cf_plain(params, xb, vb, aux, S, 0.5 * eps, **kw)
    assert torch.equal((twin[3].reshape(-1, 2048) == -1e10).all(1), dead)
    if N % 128 == 0:
        assert dead.float().mean().item() > 0.1


def test_sigma_loss_and_cf_steps_launch(cuda, monkeypatch):
    """A ``two_mlp``-shaped step with the sigma loss launches kernels 12 and
    13 once; with ``DLNERF_CULL_FWD=1`` the fine pass launches kernel 9
    and the culled backward, not kernels 4 and 5."""
    from depth_lidar_nerf_tpu_torch.data.synthetic import draw_scene
    from depth_lidar_nerf_tpu_torch.ops import fused_mlp as fm
    from depth_lidar_nerf_tpu_torch.ops import fused_mlp_t as f
    from depth_lidar_nerf_tpu_torch.train.config import TrainConfig, render_config_from
    from depth_lidar_nerf_tpu_torch.train.state import build_models, init_train_state
    from depth_lidar_nerf_tpu_torch.train.step import make_train_step
    from depth_lidar_nerf_tpu_torch.train.tables import build_depth_table, build_rgb_table

    sc = draw_scene(n_images=1, H=16, W=32, focal=20.0, n_depth_points=200, seed=0,
                    backdrop=True)
    cfg = TrainConfig(dataset_type="llff", N_rand=512, N_samples=64, N_importance=64,
                      netdepth=4, netwidth=256, netdepth_fine=4, netwidth_fine=256,
                      use_viewdirs=True, no_ndc=True, raw_noise_std=1.0,
                      colmap_depth=True, depth_loss=True, sigma_loss=True,
                      compute_dtype="bfloat16", cull_eps=1e-4)
    rcfg = render_config_from(cfg, 0, sc.near, sc.far)
    models = build_models(cfg, rcfg, device=cuda)
    tabs = (build_rgb_table(sc.images, sc.poses, [0], *sc.hwf, rcfg, device=cuda),
            build_depth_table(sc.depth_gts, sc.poses, [0], *sc.hwf, rcfg, device=cuda))
    step = make_train_step(cfg, rcfg, models, sc.hwf)
    state = init_train_state(cfg, models)
    gen = torch.Generator(device=cuda).manual_seed(0)
    fns = (fm.fused_packed_fwd, fm.fused_packed_bwd, f.fused_nerf_fwd_cf,
           f.fused_nerf_fwd_acts, f.fused_nerf_bwd_acts, f.fused_nerf_bwd_culled,
           f.fused_nerf_bwd_chain, f.bwd_weight_grads, fm.fused_packed_chain,
           fm.packed_wgrad)
    # phase 2 once for kernel 5's fine pass, and once for kernel 13's chunk
    # in its own count
    for knob, want in (("0", (1, 1, 0, 1, 1, 1, 1, 1, 1, 1)),
                       ("1", (1, 1, 1, 0, 0, 2, 0, 0, 1, 1))):
        monkeypatch.setenv("DLNERF_CULL_FWD", knob)
        n0 = [fn.launches for fn in fns]
        metrics = step(state, *tabs, gen)
        torch.cuda.synchronize()
        assert tuple(fn.launches - n for fn, n in zip(fns, n0)) == want, knob
        assert np.isfinite(metrics["sigma_loss"].item())
