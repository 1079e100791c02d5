"""The int8 tile's tensor-core layout on the CPU (numpy only; the CUDA kernel
itself runs only on the card).

``csrc/fused_nerf_q8.cu:tc_q8_mma`` forms each int8 product of kernels 10
and 11 with ``mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32``. This file
emulates that instruction lane by lane from the PTX ISA's fragment contract
for ``.s8`` operands and feeds it the words the kernel loads: A from the
packed activation ``qa`` (``qdot_plain``'s quantization, 4 int8 a word along
K, byte e = row 4k + e, at the kernel's row stride ``kLDQ``), B from
``pack_params_q8(...).wq4`` at ``q_offsets``. Each lane's c0..c3, placed
where the kernel's epilogue (``q8_epilogue``) takes them, must give the
int64 product ``q_act @ q_w`` exactly, for every int8 layer of D=4 and D=8
skip@4 packs at W=128 and 256 (the view layer's N = W/2 included). It also
emulates ``quantize_frag``, which quantizes an activation held in that
fragment layout and packs ``qa`` by swapping int8 pairs between neighbouring
lanes, and checks that the A loads of a warp fall in 32 distinct
shared-memory banks at that stride, and the bounds that make the integer
sums exact.
"""

import re
from pathlib import Path

import numpy as np
import pytest
import torch

CSRC = Path(__file__).resolve().parents[1] / "depth_lidar_nerf_tpu_torch" / "csrc"
TP, MT = 64, 4  # points per tile (kTP), m16 tiles of a tile's points (kMT)


def _constant(name: str, pattern: str) -> str:
    m = re.search(rf"constexpr \w+ {name} = {pattern};",
                  (CSRC / "fused_nerf_q8.cu").read_text())
    assert m, f"{name} not found in csrc/fused_nerf_q8.cu"
    return m.group(1)


def _kldq() -> int:
    return int(_constant("kLDQ", r"(\d+)"))


# The kernel's exact integer <-> float arithmetic: accumulators start at
# kMagicBits, a sum is read back as float(bits) - kMagic, and a product is
# rounded by adding kMagic (its low byte is then rint(x) & 0xff).
MAGIC = np.float32(float(_constant("kMagic", r"([\d.]+)f")))
MAGIC_BITS = int(_constant("kMagicBits", r"(0x[0-9A-Fa-f]+)"), 16)


# ---- the PTX ISA's m16n8k32 fragments for .s8 (element i of a lane's registers,
# four int8 a 32-bit register, the lowest byte first) ----

def _a_row_col(lane, i):
    g, t = lane >> 2, lane % 4
    row = g if (i < 4 or 8 <= i < 12) else g + 8
    col = t * 4 + (i & 3) + (16 if i >= 8 else 0)
    return row, col


def _b_row_col(lane, i):
    g, t = lane >> 2, lane % 4
    return t * 4 + (i & 3) + (16 if i >= 4 else 0), g


def _c_row_col(lane, i):
    g, t = lane >> 2, lane % 4
    return (g if i < 2 else g + 8), t * 2 + (i & 1)


def _fragment_maps(row_col, n):
    """(rows, cols) [32][n] of each lane's element i under ``row_col``."""
    rc = np.array([[row_col(lane, i) for i in range(n)] for lane in range(32)])
    return rc[..., 0], rc[..., 1]


A_MAP, B_MAP, C_MAP = (_fragment_maps(_a_row_col, 16), _fragment_maps(_b_row_col, 8),
                       _fragment_maps(_c_row_col, 4))


def _bytes(words):
    """int32 words [32][R] -> their int8 bytes [32][4 R], lowest byte first."""
    return np.ascontiguousarray(words, np.int32).view(np.int8).reshape(32, -1)


def mma_m16n8k32(a_regs, b_regs, c_regs):
    """The instruction on one warp: a_regs [32][4], b_regs [32][2] int32
    words, c_regs [32][4] int64 accumulators -> d_regs [32][4]."""
    A = np.zeros((16, 32), np.int64)
    B = np.zeros((32, 8), np.int64)
    C = np.zeros((16, 8), np.int64)
    A[A_MAP] = _bytes(a_regs)
    B[B_MAP] = _bytes(b_regs)
    C[C_MAP] = c_regs
    assert (np.bincount((A_MAP[0] * 32 + A_MAP[1]).ravel()) == 1).all()  # a bijection
    return (A @ B + C)[C_MAP]


# ---- the kernel's addresses (tc_q8_mma, q8_epilogue, quantize_frag) ----

LANE = np.arange(32)
G, T = LANE >> 2, LANE % 4


def pack_qa(q, ldq, rng):
    """The packed activation of int8 rows q [TP, K]: word [k4][p] holds
    q[p][4 k4 + e] in byte e, at k4 * ldq + p; the pad columns p >= TP hold
    noise (a load there would show)."""
    K = q.shape[1]
    qa = rng.integers(-2**31, 2**31, (K // 4, ldq), dtype=np.int64).astype(np.int32)
    qa[:, :TP] = np.ascontiguousarray(
        q.astype(np.int8).reshape(TP, K // 4, 4)).view(np.int32)[..., 0].T
    return qa.reshape(-1)


def tile_product(qa, ldq, wq, N, K):
    """The int8 product of one tile as tc_q8_mma forms it: warp ty owns
    columns n0 = 8 NT ty .. of all 64 points; k-steps of 32 (8 words) in
    order; lane (g, t) loads A words (k4 + t) ldq + 16 mt + g (+ 8, + 4 ldq,
    + 4 ldq + 8) and B words (k4 + t) N + n0 + 8 nt + g (and k4 + 4 + t);
    the result [TP, N] placed where its epilogue stores each lane's c0..c3
    (point 16 mt + g + 8 h, column n0 + 8 nt + 2t + j)."""
    NT = N // 64
    out = np.full((TP, N), np.iinfo(np.int64).min, np.int64)
    for ty in range(8):
        n0 = 8 * NT * ty
        acc = np.full((MT, NT, 32, 4), MAGIC_BITS, np.int64)
        for k4 in range(0, K // 4, 8):
            for mt in range(MT):
                a = np.stack([qa[(k4 + T) * ldq + G + 16 * mt + off]
                              for off in (0, 8, 4 * ldq, 4 * ldq + 8)], 1)
                for nt in range(NT):
                    b = np.stack([wq[(k4 + T + kk) * N + n0 + 8 * nt + G] for kk in (0, 4)], 1)
                    acc[mt, nt] = mma_m16n8k32(a, b, acc[mt, nt])
        for mt in range(MT):
            for nt in range(NT):
                for h in range(2):
                    for j in range(2):
                        out[16 * mt + G + 8 * h, n0 + 8 * nt + 2 * T + j] = \
                            acc[mt, nt, :, 2 * h + j]
    assert (out != np.iinfo(np.int64).min).all()  # every element stored once at least
    assert (np.abs(out - MAGIC_BITS) < 2**22).all()
    # the epilogue's float of the sum, float(bits) - kMagic, as an integer
    return (out.astype(np.int32).view(np.float32) - MAGIC).astype(np.int64)


def quantize_frag(h, ldq):
    """qa as quantize_frag packs it from the fragments of the float32
    activation h [TP, N]: lane (g, t) of warp w holds v[mt][nt][2 hh + j] =
    h[16 mt + g + 8 hh, 8 NT w + 8 nt + 2t + j]; per point m = max |h| (the
    kernel's shuffles and partial maxima; a max is exact in any order), r =
    float32(127) / max(m, 1e-30), q = the low byte of float32(v r) + kMagic
    (rounded half to even); each lane packs its pair (j = 0, 1) for both of
    its points, sends the pair of point hh = 1 - (t & 1) to lane t ^ 1, and
    stores the word of point hh = t & 1 at word (8 NT w + 8 nt) / 4 + t // 2,
    point 16 mt + g + 8 hh. Pads hold noise."""
    N = h.shape[1]
    NT = N // 64
    m = np.abs(h).max(1).astype(np.float32)
    r = (np.float32(127) / np.maximum(m, np.float32(1e-30))).astype(np.float32)
    qa = np.random.default_rng(N).integers(-2**31, 2**31, (N // 4) * ldq,
                                            dtype=np.int64).astype(np.int32)
    stored = np.zeros(qa.shape, np.int64)
    for w in range(8):
        n0 = 8 * NT * w
        for mt in range(MT):
            for nt in range(NT):
                pair = []
                for hh in range(2):
                    p = 16 * mt + G + 8 * hh
                    c = n0 + 8 * nt + 2 * T
                    q0, q1 = ((h[p, c + j] * r[p] + MAGIC).view(np.uint32).astype(np.int64)
                              for j in range(2))
                    pair.append((q0 & 0xff) | ((q1 & 0xff) << 8))
                odd = T & 1
                send = np.where(odd == 1, pair[0], pair[1])
                other = send[LANE ^ 1]  # __shfl_xor_sync(.., 1)
                word = np.where(odd == 1, other | (pair[1] << 16), pair[0] | (other << 16))
                addr = ((n0 + 8 * nt) // 4 + (T >> 1)) * ldq + 16 * mt + G + 8 * odd
                qa[addr] = word.astype(np.uint32).view(np.int32)
                stored[addr] += 1
    assert (stored.reshape(N // 4, ldq)[:, :TP] == 1).all()  # every word once, no pad
    assert (stored.reshape(N // 4, ldq)[:, TP:] == 0).all()
    return qa


@pytest.mark.parametrize("width", [128, 256])
def test_quantize_frag_packs_qa(width):
    """The lane-level packing of quantize_frag gives the words of
    qdot_plain's quantization (quant_rows), byte e = row 4 k4 + e."""
    from depth_lidar_nerf_tpu_torch.ops import fused_mlp_t as f

    h = _act_tile(width, seed=width)
    ldq = _kldq()
    got = quantize_frag(h.numpy(), ldq)
    q, _ = f.quant_rows(h)
    want = pack_qa(q.numpy().astype(np.int64), ldq, np.random.default_rng(width))
    np.testing.assert_array_equal(got.reshape(-1, ldq)[:, :TP], want.reshape(-1, ldq)[:, :TP])


def _pack(depth, width):
    from depth_lidar_nerf_tpu_torch.models.nerf_mlp import NeRFMLP
    from depth_lidar_nerf_tpu_torch.ops import fused_mlp_t as f

    m = NeRFMLP(depth=depth, width=width, skips=(4,),
                generator=torch.Generator().manual_seed(depth * width))
    params = {k: v.detach() for k, v in m.named_parameters()}
    return f.pack_params_q8(params, depth, torch.bfloat16, skips=(4,))


def _act_tile(width, seed):
    """A seeded post-ReLU activation tile [TP, width] in bfloat16 with an
    all-zero row and a row of one nonzero value, as the kernel sees them."""
    rng = np.random.default_rng(seed)
    h = np.maximum(rng.normal(size=(TP, width)), 0.0) * rng.uniform(0.1, 30.0, (TP, 1))
    h[5] = 0.0
    h[9] = 0.0
    h[9, 17] = 2.5
    return torch.from_numpy(h.astype(np.float32)).to(torch.bfloat16).float()


_LAYERS = [(d, w, j) for d in (4, 8) for w in (128, 256) for j in range(d + 1)]


@pytest.mark.parametrize("depth,width,j", _LAYERS)
def test_mma_fragments_give_the_int8_product(depth, width, j):
    """Layer j of the pack (trunk_1..trunk_{D-1}, feature, views_0's feature
    rows): the emulated tile product equals the int64 product exactly."""
    from depth_lidar_nerf_tpu_torch.ops import fused_mlp_t as f

    pk = _pack(depth, width)
    q_w = pk.q[j].numpy().astype(np.int64)
    K, N = q_w.shape
    assert K == width and N == (width // 2 if j == depth else width)
    wq = pk.wq4.numpy()[pk.q_offsets[j]:pk.q_offsets[j] + K // 4 * N]
    q_act, _ = f.quant_rows(_act_tile(width, seed=depth * 100 + j))
    q_act = q_act.numpy().astype(np.int64)
    ldq = _kldq()
    qa = pack_qa(q_act, ldq, np.random.default_rng(j))
    np.testing.assert_array_equal(tile_product(qa, ldq, wq, N, K), q_act @ q_w)


@pytest.mark.parametrize("reg", range(4))
def test_a_loads_hit_distinct_banks(reg):
    """Each A register's load of a warp, word (k4 + t + 4 [reg >= 2]) kLDQ +
    16 mt + g + 8 [reg odd], falls in 32 distinct banks for every k-step."""
    ldq = _kldq()
    assert ldq >= TP
    for k4 in range(0, 64, 8):
        for mt in range(MT):
            off = (0, 8, 4 * ldq, 4 * ldq + 8)[reg]
            banks = ((k4 + T) * ldq + G + 16 * mt + off) % 32
            assert len(set(banks.tolist())) == 32, (k4, mt, sorted(banks))


@pytest.mark.parametrize("width", [128, 256])
def test_int8_sums_are_exact(width):
    """The extreme rows: all +127 against a column of all -127 (|acc| = K
    127^2, the most an int8 product of depth K can reach) and alternating
    signs. The emulated tile equals the int64 product: its sums stay below
    2^22 in magnitude, so the accumulators, which start at kMagicBits, hold
    them in int32 and give them back exactly as floats. qdot_plain's float32
    product is exact too (K 127^2 < 2^24), so its output is acc * ((m / 127)
    s) bit for bit."""
    from depth_lidar_nerf_tpu_torch.ops import fused_mlp_t as f

    K = N = width
    q_act = np.full((TP, K), 127, np.int64)
    q_act[1::2, 1::2] = -127
    q_w = np.full((K, N), -127, np.int64)
    q_w[::3, 1:] = 127
    wq = np.ascontiguousarray(q_w.astype(np.int8).reshape(K // 4, 4, N).transpose(0, 2, 1)
                              ).view(np.int32)[..., 0].reshape(-1)
    ldq = _kldq()
    want = q_act @ q_w
    assert np.abs(want).max() == K * 127 * 127 < 2**22 < 2**31 - MAGIC_BITS
    np.testing.assert_array_equal(
        tile_product(pack_qa(q_act, ldq, np.random.default_rng(width)), ldq, wq, N, K), want)

    h = torch.from_numpy(q_act.astype(np.float32))  # m = 127: rint(h 127/127) = h
    srow = torch.linspace(1e-3, 2.0, N).reshape(1, N)
    q, m = f.quant_rows(h)
    assert torch.equal(q, h)
    exact = torch.from_numpy(want.astype(np.float32)) * ((m * f._INV127) * srow)
    assert torch.equal(f.qdot_plain(h, torch.from_numpy(q_w.astype(np.int8)), srow), exact)
