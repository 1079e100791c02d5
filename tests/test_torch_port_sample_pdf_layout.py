"""Kernel 14's work mapping and arithmetic on the CPU (the CUDA kernel itself
runs only on the card).

``csrc/sample_pdf.cu`` cuts the rays into tiles of at most ``kRays`` rays,
walked by blocks of ``kThreads`` threads (tile b, b + blocks, ...). This
file emulates in numpy which thread does what, with the kernel's constants
read from the source:

- staging (``cp.async``): warp w copies rows w, w + 4, ... of the tile's
  weights and bins, its lanes walking 32 columns at a time, at each input's
  row stride (0, 1 and S here), into shared memory at the odd pitch
  ``Bp + 1``, the CDF padded with +inf to Bp, the power of two above B;
- the add chains: lane r of warp 0 runs ray r's total and prefix sum;
- the divisions: every thread, over the same rows and columns as staging;
- the searches: an item is 64 draws of one row, two a lane (draws lane and
  lane + 32); warp w takes
  items w, w + 4, ..., ``kBatch`` at a time; the count of CDF entries <= u
  by halving steps over the padded row, clamped to B.

It shows, at ragged N and every B in {2, 9, 63, 64, 129} and V in {1, 40,
64, 128}, that every output ``(ray, draw)`` is written exactly once, that
staging reads exactly the elements a contiguous copy holds, and that each
step of the add chains hits distinct banks; and it runs the kernel's
float32 arithmetic in that mapping against ``inverse_cdf_plain`` bit for bit.
Then: "divide all, then add in order" gives ``inverse_cdf_plain``'s CDF bit
for bit, and ``inverse_cdf`` on CPU tensors in the renderer's strided layout
equals the call on contiguous copies and JAX's ``sample_pdf_pallas``.
"""

import re
from pathlib import Path

import numpy as np
import pytest
import torch

CU = (Path(__file__).resolve().parents[1] / "depth_lidar_nerf_tpu_torch" / "csrc"
      / "sample_pdf.cu").read_text()


def _constant(name):
    m = re.search(rf"constexpr int {name} = ([\d *]+);", CU)
    assert m, f"{name} not found in csrc/sample_pdf.cu"
    return int(np.prod([int(x) for x in m.group(1).split("*")]))


RAYS, THREADS, SLOTS, BATCH, BLOCKS_PER_SM, STAGES, SMEM_MAX = (
    _constant(n) for n in ("kRays", "kThreads", "kSlots", "kBatch", "kBlocksPerSm",
                           "kStages", "kSmemMax"))
WARPS = THREADS // 32
ROWS_PER_WARP = RAYS // WARPS
SMS = 132  # an H100's SMs (the launcher asks the device)
BS, VS = (2, 9, 63, 64, 129), (1, 40, 64, 128)
N_RAGGED = 2 * RAYS + 7


def _padded(B):
    """The least power of two above B: the padded CDF's length."""
    p = 1
    while p <= B:
        p <<= 1
    return p


def _smem_floats(rays, B):
    return rays * (STAGES * 2 * (_padded(B) + 1) + 1)


def _grid(N, B, sms=SMS):
    """The launcher's rays a tile and blocks: kRays rays a tile, fewer while
    the tiles would leave some of kBlocksPerSm blocks an SM idle, or the
    rows would not fit; at most that many blocks, each walking tiles."""
    slots = sms * BLOCKS_PER_SM
    rays = min(max(-(-N // slots), 1), RAYS)
    while rays > 1 and 4 * _smem_floats(rays, B) > SMEM_MAX:
        rays = (rays + 1) // 2
    return rays, min(-(-N // rays), slots)


def _strided(rng, N, C, stride, sort=False):
    """An ``[N, C]`` float32 view at row stride ``stride`` over a flat
    buffer (rows overlap at stride 1 and coincide at 0), and the buffer."""
    flat = rng.random(max(1, (N - 1) * stride + C), dtype=np.float32)
    if sort:  # every row of every view sorted
        flat.sort()
    view = np.lib.stride_tricks.as_strided(flat, (N, C), (4 * stride, 4))
    return view, flat


def _emulate(N, B, V, bins_flat, sb, w_flat, sw, u_flat, su, rays, blocks):
    """The kernel's grid on flat buffers at ``rays`` rays a tile, the tiles
    walked by ``blocks`` blocks: its outputs, the values it staged, and per
    element how often it was staged, divided and written. Asserts that each
    step of the add chains reads distinct banks."""
    f32 = np.float32
    Bp = _padded(B)
    P, nw = Bp + 1, B - 1
    assert P % 2 == 1
    nch = -(-V // (32 * SLOTS))
    out = np.full((N, V), np.nan, np.float32)
    writes = np.zeros((N, V), int)
    staged_w = np.zeros((N, max(nw, 1)), int)
    staged_b = np.zeros((N, B), int)
    divided = np.zeros((N, max(nw, 1)), int)
    vals_w = np.zeros((N, max(nw, 1)), np.float32)
    vals_b = np.zeros((N, B), np.float32)
    tiles = -(-N // rays)
    walked = sorted(t for b in range(blocks) for t in range(b, tiles, blocks))
    assert walked == list(range(tiles))  # each tile by one block, once
    for tile in range(tiles):
        ray0 = tile * rays
        nr = min(rays, N - ray0)
        cdf = np.full(rays * P, np.nan, np.float32)
        cdf[(np.arange(rays)[:, None] * P + np.arange(B, Bp)).ravel()] = np.inf
        bn = np.full(rays * P, np.nan, np.float32)
        tot = np.zeros(rays, np.float32)
        # staging (cp.async): warp w, rows w + 4 m, lanes along 32 columns
        for warp, c0, m, lane in np.ndindex(WARPS, -(-B // 32), ROWS_PER_WARP, 32):
            r, j = warp + m * WARPS, 32 * c0 + lane
            if r < nr and j < nw:
                vals_w[ray0 + r, j] = w_flat[(ray0 + r) * sw + j]
                cdf[r * P + j + 1] = vals_w[ray0 + r, j]
                staged_w[ray0 + r, j] += 1
            if r < nr and j < B:
                vals_b[ray0 + r, j] = bins_flat[(ray0 + r) * sb + j]
                bn[r * P + j] = vals_b[ray0 + r, j]
                staged_b[ray0 + r, j] += 1
        lanes = np.arange(nr)
        # 1. totals: lane r adds ray r's floored terms; each step's reads
        for j in range(1, nw + 1):
            addr = lanes * P + j
            assert len(set(addr % 32)) == nr, (B, j)
            tot[lanes] = tot[lanes] + (cdf[addr] + f32(1e-5))
        # 2. divisions: warp w, rows w + 4 m, lanes along 32 columns
        for warp, c0, m, lane in np.ndindex(WARPS, -(-nw // 32), ROWS_PER_WARP, 32):
            r, j = warp + m * WARPS, 32 * c0 + lane + 1
            if r < nr and j <= nw:
                cdf[r * P + j] = (cdf[r * P + j] + f32(1e-5)) / tot[r]
                divided[ray0 + r, j - 1] += 1
        # 3. prefix sums
        c = np.zeros(nr, np.float32)
        cdf[lanes * P] = 0.0
        for j in range(1, nw + 1):
            addr = lanes * P + j
            assert len(set(addr % 32)) == nr, (B, j)
            c = c + cdf[addr]
            cdf[addr] = c
        # 4. searches: warp w takes items w, w + 4, ..., kBatch at a time;
        #    item it is row it // nch's draws of chunk it % nch, 64 a chunk
        items = nr * nch
        for warp in range(WARPS):
            for it0 in range(warp, items, WARPS * BATCH):
                for e in range(BATCH):
                    it = it0 + e * WARPS
                    r, ch = divmod(it, nch)
                    row = min(r, nr - 1) * P
                    for lane in range(32):
                        for k in range(SLOTS):
                            q = 32 * SLOTS * ch + lane + 32 * k
                            if it >= items or q >= V:
                                continue
                            x = u_flat[(ray0 + r) * su + q]
                            i, h = 0, Bp >> 1
                            while h:
                                if cdf[row + i + h - 1] <= x:
                                    i += h
                                h >>= 1
                            n = min(i, B)
                            below, above = max(n - 1, 0), min(n, B - 1)
                            c0_, c1 = cdf[row + below], cdf[row + above]
                            b0, b1 = bn[row + below], bn[row + above]
                            denom = c1 - c0_
                            if denom < f32(1e-5):
                                denom = f32(1.0)
                            t = (x - c0_) / denom
                            out[ray0 + r, q] = b0 + t * (b1 - b0)
                            writes[ray0 + r, q] += 1
    counts = {"written": writes, "staged_w": staged_w[:, :nw],
              "staged_b": staged_b, "divided": divided[:, :nw]}
    return out, vals_w[:, :nw], vals_b, counts


@pytest.mark.parametrize("stride", ["0", "1", "S"])
@pytest.mark.parametrize("V", VS)
@pytest.mark.parametrize("B", BS)
def test_work_mapping_covers_each_element_once(B, V, stride):
    """Ragged N at kRays rays a tile (two full tiles and 7 rays, two blocks)
    and at 3 rays a tile (walked by 5 blocks):
    every output once, every element staged and divided once, the staged
    values those of a contiguous copy, and the kernel's float32 arithmetic in
    this mapping equal to ``inverse_cdf_plain`` bit for bit."""
    from depth_lidar_nerf_tpu_torch.ops.sampling_cuda import inverse_cdf_plain

    rng = np.random.default_rng(B * 1000 + V)
    N = N_RAGGED
    sb, sw, su = {"0": (0, 0, 0), "1": (1, 1, 1),
                  "S": (B + 2, B + 1, V + 4)}[stride]
    bins, bins_flat = _strided(rng, N, B, sb, sort=True)
    w, w_flat = _strided(rng, N, B - 1, sw)
    w_flat **= 3
    u, u_flat = _strided(rng, N, V, su)
    u_flat[:: max(1, V // 3)] = 1.0  # draws at the top of the CDF
    ref = inverse_cdf_plain(*(torch.from_numpy(np.ascontiguousarray(a))
                              for a in (bins, w, u))).numpy()
    for rays, blocks in ((RAYS, 2), (3, 5)):  # blocks walking several tiles
        out, vals_w, vals_b, counts = _emulate(N, B, V, bins_flat, sb, w_flat,
                                               sw, u_flat, su, rays, blocks)
        for name, c in counts.items():
            assert (c == 1).all(), (rays, name)
        np.testing.assert_array_equal(vals_w, np.ascontiguousarray(w))
        np.testing.assert_array_equal(vals_b, np.ascontiguousarray(bins))
        np.testing.assert_array_equal(out.view(np.uint32), ref.view(np.uint32))


@pytest.mark.parametrize("N", [1, RAYS - 1, RAYS + 1])
def test_work_mapping_small_grids(N):
    """One ray, a block short of full, one ray over a block, at the
    launcher's grid and at kRays rays a tile: every output once, at V = 41
    and the main path's V = 64."""
    from depth_lidar_nerf_tpu_torch.ops.sampling_cuda import inverse_cdf_plain

    rng = np.random.default_rng(N)
    for V in (41, 64):
        bins, bins_flat = _strided(rng, N, 63, 63, sort=True)
        w, w_flat = _strided(rng, N, 62, 64)
        u, u_flat = _strided(rng, N, V, 0)
        ref = inverse_cdf_plain(*(torch.from_numpy(np.ascontiguousarray(a))
                                  for a in (bins, w, u))).numpy()
        for rays, blocks in (_grid(N, 63), (RAYS, 1)):
            out, vals_w, _, counts = _emulate(N, 63, V, bins_flat, 63, w_flat,
                                              64, u_flat, 0, rays, blocks)
            assert all((c == 1).all() for c in counts.values())
            np.testing.assert_array_equal(vals_w, np.ascontiguousarray(w))
            np.testing.assert_array_equal(out.view(np.uint32), ref.view(np.uint32))


def test_grid_fills_the_card_and_fits():
    """The launcher's grid: rays a tile the fewest that keep the tiles within
    kBlocksPerSm blocks an SM (so a small tile count spreads over every SM),
    at most kRays; shared memory within the limit at any B up to 8,191; no
    more blocks than tiles, each walking tiles."""
    slots = SMS * BLOCKS_PER_SM
    for B in BS + (900, 2047, 2048, 8191):
        for N in (1, 320, 16384, 32768, 33088, 10 ** 6):
            rays, blocks = _grid(N, B)
            tiles = -(-N // rays)
            assert 1 <= rays <= RAYS and blocks == min(tiles, slots)
            assert 4 * _smem_floats(rays, B) <= SMEM_MAX
            if B <= 129:  # shared memory holds kRays rows
                assert tiles <= slots or rays == RAYS
                assert rays == 1 or -(-N // (rays - 1)) > slots
    assert _grid(320, 63) == (1, 320) and _grid(10 ** 6, 63) == (RAYS, slots)
    assert 4 * _smem_floats(1, 8192) > SMEM_MAX


def test_bound_counts_the_bytes_the_inputs_hold():
    """``chip_smoke.sample_pdf_bound_ms``: each input's elements read once,
    an ``expand``ed u (row stride 0) one row, the weights slice its B - 1
    columns a row, the output written once."""
    import chip_smoke as cs

    N, B, V = 40, 63, 64
    cpu = torch.device("cpu")
    for det, u_floats in ((True, V), (False, N * V)):
        calls = [cs.sample_pdf_inputs(cpu, N, B, V, det, "renderer")]
        floats = N * B + N * (B - 1) + u_floats + N * V
        assert cs.sample_pdf_bound_ms(calls) == floats * 4 / cs.PEAK_BYTES * 1e3
        assert cs.sample_pdf_bound_ms(calls * 2) == 2 * cs.sample_pdf_bound_ms(calls)


def _sequential_cdf(w):
    """Divide all, then add in order: the 1e-5 floor, a sequential float32
    total, every division on its own, a sequential float32 prefix sum."""
    w = w.astype(np.float32) + np.float32(1e-5)
    total = np.zeros(w.shape[0], np.float32)
    for j in range(w.shape[1]):
        total = total + w[:, j]
    p = w / total[:, None]  # all at once: no dependence on the running sum
    cdf = np.zeros((w.shape[0], w.shape[1] + 1), np.float32)
    for j in range(w.shape[1]):
        cdf[:, j + 1] = cdf[:, j] + p[:, j]
    return cdf


def _plain_cdf(monkeypatch, bins, w, u):
    """The CDF ``inverse_cdf_plain`` searches, caught at its
    ``torch.searchsorted``."""
    from depth_lidar_nerf_tpu_torch.ops.sampling_cuda import inverse_cdf_plain

    seen = []
    orig = torch.searchsorted

    def spy(sorted_sequence, *a, **k):
        seen.append(sorted_sequence.clone())
        return orig(sorted_sequence, *a, **k)

    monkeypatch.setattr(torch, "searchsorted", spy)
    out = inverse_cdf_plain(bins, w, u)
    monkeypatch.setattr(torch, "searchsorted", orig)
    assert len(seen) == 1
    return seen[0].numpy(), out


@pytest.mark.parametrize("B", BS)
def test_divide_all_then_add_in_order_is_the_plain_cdf(monkeypatch, B):
    import chip_smoke as cs

    rng = np.random.default_rng(B)
    w = rng.random((500, B - 1), dtype=np.float32) ** 3
    w[0] = 0.0
    w[1, : B // 2] = 0.0
    bins = np.sort(rng.random((500, B), dtype=np.float32), -1)
    u = rng.random((500, 7), dtype=np.float32)
    cdf, _ = _plain_cdf(monkeypatch, *map(torch.from_numpy, (bins, w, u)))
    np.testing.assert_array_equal(_sequential_cdf(w).view(np.uint32),
                                  cdf.view(np.uint32))
    # the smoke's row picker uses the same CDF
    np.testing.assert_array_equal(cs.sequential_cdf_np(w).view(np.uint32),
                                  cdf.view(np.uint32))


@pytest.mark.parametrize("B", [9, 63, 129])
def test_u_one_where_the_cdf_ends_above_one(monkeypatch, B):
    """``sample_pdf_inputs(..., u_one=True)``: each ray's sequential CDF
    ends above 1.0 and its last bin holds the floor alone; at B = 63 the
    draw u = 1 lands a whole bin below ``bins[B-1]``."""
    import chip_smoke as cs

    bins, w, u = cs.sample_pdf_inputs(torch.device("cpu"), 256, B, 64, False,
                                      "renderer", seed=B, u_one=True)
    cdf, out = _plain_cdf(monkeypatch, bins, w.contiguous(), u)
    assert (cdf[:, -1] > 1.0).all() and (u[:, -1] == 1.0).all()
    np.testing.assert_array_equal(_sequential_cdf(w.numpy()).view(np.uint32),
                                  cdf.view(np.uint32))
    if B == 63:
        last = (bins[:, -1] - out[:, -1]) / (bins[:, -1] - bins[:, -2])
        assert (last > 0.99).all()


@pytest.mark.parametrize("N,B,V", [(70, 63, 64), (33, 9, 40), (5, 129, 128)])
def test_inverse_cdf_on_renderer_inputs(N, B, V):
    """The renderer's strided inputs (an ``[N, B+1]`` weights tensor's
    ``[:, 1:-1]``, det's ``expand``ed draws) give what contiguous copies
    give, bit for bit, and JAX's Pallas kernel's samples in the interpreter
    at ``tests/test_torch_port_sampling.py``'s inputs and tolerance (JAX
    sums the CDF in another order, and a sparse pdf magnifies that gap by
    the inverse of a bin's mass)."""
    import jax.numpy as jnp

    from depth_lidar_nerf_tpu.ops.sampling_pallas import sample_pdf_pallas
    from depth_lidar_nerf_tpu_torch.ops.sampling import pdf_uniforms
    from depth_lidar_nerf_tpu_torch.ops.sampling_cuda import (inverse_cdf,
                                                              sample_pdf_cuda)

    rng = np.random.default_rng(N)
    bins = torch.from_numpy(np.sort(rng.uniform(0, 1, (N, B)), -1).astype(np.float32))
    coarse = rng.exponential(1.0, (N, B + 1)).astype(np.float32)
    coarse[0] = 0.0  # the 1e-5 floor alone: a uniform pdf
    coarse[1, : B // 2] = 0.0  # a flat CDF stretch: the denominator guard
    w = torch.from_numpy(coarse)[:, 1:-1]
    u = pdf_uniforms(N, V, det=True, generator=None, device="cpu")
    assert w.stride() == (B + 1, 1) and u.stride() == (0, 1)
    got = inverse_cdf(bins, w, u)
    assert torch.equal(got, sample_pdf_cuda(bins, w, V, det=True))
    assert torch.equal(got, inverse_cdf(bins, w.contiguous(), u.contiguous()))
    ref = np.asarray(sample_pdf_pallas(jnp.asarray(bins.numpy()),
                                       jnp.asarray(w.contiguous().numpy()), V,
                                       det=True, interpret=True))
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-5, atol=1e-6)


def test_inverse_cdf_refuses_what_the_kernel_does_not_take():
    """On either device: a last dimension with a stride other than 1, a
    dtype other than float32, inputs on several devices."""
    import chip_smoke as cs
    from depth_lidar_nerf_tpu_torch.ops.sampling_cuda import inverse_cdf

    bins, w, u = cs.sample_pdf_inputs(torch.device("cpu"), 16, 9, 8, False)
    with pytest.raises(ValueError, match="stride"):
        inverse_cdf(bins, w, u.t().contiguous().t())
    with pytest.raises(ValueError, match="stride"):
        inverse_cdf(bins, w.t().contiguous().t(), u)
    with pytest.raises(ValueError, match="float32"):
        inverse_cdf(bins.double(), w, u)
    with pytest.raises(ValueError, match="float32"):
        inverse_cdf(bins, w, u.bfloat16())
    with pytest.raises(ValueError, match="several devices"):
        inverse_cdf(bins, w.to("meta"), u)
    # a column of one element has no stride to speak of
    one = torch.zeros(16, 2).t().contiguous().t()[:, :1]
    assert inverse_cdf(bins[:, :2], one, u).shape == (16, 8)
