// W8A8 serving forward for Hopper (sm_90a): kernel 10 and, with the per-tile semantic
// partial sums, kernel 11's trunk.
//
// Kernel 10 replaces the Pallas TPU kernel depth_lidar_nerf_tpu/ops/fused_mlp_t.py:_fwd_kernel_q8
// (body _forward_tile_q8, entry _fwd_impl_q8); kernel 11 replaces _fwd_kernel_q8_sem (entry
// _fwd_impl_q8_sem), whose head runs in fused_nerf_fwd.cu's fused_nerf_sem_head kernel on the
// partial sums written here, as for kernel 6. The network is kernel 1's (fused_nerf_fwd.cu),
// with the wide products in int8: for each point and each of trunk layers 1..D-1, the feature
// layer and the feature half of the view layer, with the point's input row h (W values, already
// rounded to T),
//   m   = max_c |h_c|,   r = 127 / max(m, 1e-30),   q_c = rint(h_c r)        (int8, per point)
//   acc = sum_c q_c Wq[c, n]                                                (exact, int32)
//   y_n = acc * ((m * (1/127)) * s_n)                                       (float32)
// where Wq and the column scales s are the int8 weights of JAX _quant_cols (made on the host,
// ops/fused_mlp_t.py:pack_params_q8). Then, as _forward_tile_q8 orders it: a trunk layer adds
// its bias and then, after a live skip, the encoding product enc W_l[:e_p]; the feature layer
// adds its bias; the view layer adds the ray's term and then its bias. ReLU and the rounding to
// T follow as in kernel 1. The first layer and the skip products are kernel 1's side products:
// in bfloat16 on the tensor cores (tc_layer, tc_mac of fused_nerf.cuh, mma.sync m16n8k16, each
// 16-k run summed from zero and added in float32), in float32 on FMA (mac). The sigma and rgb
// heads and the view layer's per-ray half stay on FMA, as in kernel 1. Every rounding step of
// the quantization is IEEE: the division 127 / m is a true division (no --use_fast_math), q is
// rounded half to even (as jnp.round; by an addition of kMagic, below), and the dequantization
// is written with __fmul_rn/__fadd_rn so that nvcc cannot contract it into an FMA that JAX's
// arithmetic lacks.
//
// Bound on the H100: operations. A point costs ~(D + 1/2) W^2 int8 multiply-adds and
// ~(e_p (1 + skips) + W + 3 W / 2) W multiply-adds in T against 28 bytes of input and output:
// a 94 x 352 frame (coarse D=4 at 64 samples, fine D=8 skip@4 at 128, W=256) is 5.97e12 int8
// operations at 1,979 TOPS plus 3.5e11 bfloat16 FLOP at 989 TFLOP/s, 3.369 ms.
//
// Layout. One block of 256 threads owns a tile of kTP = 64 consecutive points (kernel 1's tile
// walk, a ragged last tile masked); the shared memory is kernel 1's plus the quantized
// activation qa [W/4][kLDQ] int32 (4 int8 along K a word, byte e = row 4 k4 + e) and the
// per-warp partial maxima. Each int8 product runs on the integer tensor cores
// (mma.sync.m16n8k32.s32.s8.s8.s32; tc_q8_mma) with tc_layer's ownership: warp ty takes all 64
// points and columns n0 = 8 NT ty .., NT = W/64 (the view layer's feature half W/128). Lane
// (g = lane/4, t = lane%4) loads its A words from qa, rows 16 mt + g and + 8 at words k4 + t and
// k4 + 4 + t (kLDQ = 72 = 8 mod 32: banks 8t + g, all distinct), its B words from the packed
// int8 weights [K/4][N] at (k4 + t) N + n0 + 8 nt + g and (k4 + 4 + t) N + ..., through L1/L2
// one k-step ahead, and ends holding points 16 mt + g and + 8 of columns n0 + 8 nt + 2t and
// + 1. The int32 accumulator is carried through the mma: integer sums are exact in any order.
// The epilogue dequantizes in that layout (q8_epilogue), keeps the activation in registers and
// quantizes it there for the next layer (quantize_frag): per-point maxima across the warp's
// quad by shuffles and across the warps through shared memory, then each lane packs its int8
// pairs with its neighbour's into qa words. Only the activations that something else reads
// (the last trunk layer for the sigma head, the feature layer for kernel 11's partial sums, the
// view layer for the rgb head) are stored to shared memory. The integer-float conversions of
// the dequantization and the quantization are exact additions (kMagic), and bfloat16 rounds
// two values a conversion: the conversion unit issues an eighth of the FP32 rate.
//
// What limits it now (PERF.md, scripts/torch_q8_split.py): issue, not the tensor cores: the
// per-element epilogue and quantization (on 8 warps an SM, one block of 64 points), then the
// int8 mma loops with their A and B loads; each tile also reads its net's weights through L2,
// ~0.66 MB a fine D=8 tile, ~55 GB a frame.

#include "fused_nerf.cuh"

namespace {

using namespace fnerf;

constexpr float kInv127 = (float)(1.0 / 127.0);
// 1.5 * 2^23, whose float has unit ulp: for an integer |i| < 2^22 the bits 0x4B400000 + i are
// the float kMagic + i, and for a float |x| < 2^22, kMagic + x rounded to nearest (ties to
// even) holds rint(x) in its low mantissa bits. So the int32 accumulators start at kMagicBits
// and a sum (|sum| <= 256 127^2 < 2^22) becomes a float exactly with one subtraction, and the
// quantization rounds with one addition: both without the conversion unit, bit for bit what
// __int2float_rn and __float2int_rn give.
constexpr float kMagic = 12582912.f;
constexpr int kMagicBits = 0x4B400000;

// The int8 weights: layer j (trunk_1..trunk_{D-1}, feature, views_0's feature rows) as
// [K/4][N] int32 words of 4 int8 along K (byte e = row 4 k + e), at qoff[j] words into wq; its
// column scales are row j of sc [pad8(D+1)][W] (float32; the view layer uses W/2 of its row).
struct NetQ8 {
  const int* wq;
  const float* sc;
  int qoff[kMaxLayers];
};

// Row stride (words) of the packed activation qa [W/4][kLDQ]: kLDQ = 8 (mod 32), so the A
// fragment loads of a warp, words (k4 + t) kLDQ + g + ..., fall in banks 8t + g, all distinct.
constexpr int kLDQ = 72;
constexpr int kWarps = kThreads / 32;

// Extra shared memory (floats) past the forward's: the packed activation [W/4][kLDQ] int32 and
// the per-warp partial maxima [kWarps][kTP].
__host__ __device__ inline size_t q8_smem_floats(int W) {
  return (size_t)(W / 4) * kLDQ + (size_t)kWarps * kTP;
}

// A tile's activation over N = 64 NT columns held in registers in the mma C-fragment layout of
// tc_layer's ownership: v[mt][nt][2 h + j] is point 16 mt + g + 8 h, column n0 + 8 nt + 2t + j,
// with n0 = 8 NT ty for warp ty and lane (g, t). So is the per-point scale ms[mt][h].
template <int NT>
using Frag = float[kMT][NT][4];

// v = h [N][kLD] (shared memory) in the fragment layout; banks 8t + g.
template <int NT>
__device__ __forceinline__ void load_frag(const float* __restrict__ h, Frag<NT>& v) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int n0 = (threadIdx.x >> 5) * 8 * NT;
#pragma unroll
  for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i)
        v[mt][nt][i] = h[(n0 + 8 * nt + 2 * t + (i & 1)) * kLD + 16 * mt + g + 8 * (i >> 1)];
}

// JAX _qdot's activation quantization of the tile v (values of T, every column of the layer's
// input: the warps together hold all W), per point p: m = max_c |v[c][p]|, then qa[k4][p]
// packs rint(v[4 k4 + e][p] * (127 / max(m, 1e-30))) in byte e, and ms = m * (1/127) for the
// thread's points. The max is exact in any order: the thread's values, then its quad by
// shuffles, then the warps' partial maxima `red` [kWarps][kTP] in shared memory, which each
// lane reads for two points, sharing r and ms with its quad by shuffles. Lane t holds
// columns 2t and 2t + 1 of a word's four: it packs their pair for both of its points and swaps
// one pair with lane t ^ 1, so that an even lane stores the word of point 16 mt + g and an odd
// one that of + 8. Starts and ends with a barrier (qa and `red` are free when it returns; the
// first also publishes what the threads stored before the call).
template <int NT>
__device__ __forceinline__ void quantize_frag(const Frag<NT>& v, int* __restrict__ qa,
                                              float* __restrict__ red, float (&ms)[kMT][2]) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3, w = threadIdx.x >> 5;
  const int n0 = w * 8 * NT;
#pragma unroll
  for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float mx = 0.f;
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
        mx = fmaxf(mx, fmaxf(fabsf(v[mt][nt][2 * h]), fabsf(v[mt][nt][2 * h + 1])));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      if (t == 0) red[w * kTP + 16 * mt + g + 8 * h] = mx;
    }
  __syncthreads();
  // Lane (g, t) finds m, r and ms of points 16 t + g and + 8 (mt = t); lane (g, mt) of the
  // quad then hands them to the others.
  static_assert(kMT == 4, "a quad's lanes t = 0..3 take the four m16 tiles");
  float r_own[2], ms_own[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int p = 16 * t + g + 8 * h;
    float m = red[p];
#pragma unroll
    for (int k = 1; k < kWarps; ++k) m = fmaxf(m, red[k * kTP + p]);
    r_own[h] = 127.f / fmaxf(m, 1e-30f);
    ms_own[h] = __fmul_rn(m, kInv127);
  }
  float r[kMT][2];
#pragma unroll
  for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      r[mt][h] = __shfl_sync(0xffffffffu, r_own[h], 4 * g + mt);
      ms[mt][h] = __shfl_sync(0xffffffffu, ms_own[h], 4 * g + mt);
    }
  const int odd = t & 1;
#pragma unroll
  for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      // pair[h]: rint(v r) of the lane's two columns for point h in bytes 0 and 1 (kMagic)
      unsigned pair[2];
#pragma unroll
      for (int h = 0; h < 2; ++h)
        pair[h] = __byte_perm(
            __float_as_uint(__fadd_rn(__fmul_rn(v[mt][nt][2 * h], r[mt][h]), kMagic)),
            __float_as_uint(__fadd_rn(__fmul_rn(v[mt][nt][2 * h + 1], r[mt][h]), kMagic)),
            0x0040);
      const unsigned other = __shfl_xor_sync(0xffffffffu, odd ? pair[0] : pair[1], 1);
      const unsigned word = odd ? __byte_perm(other, pair[1], 0x5410)
                                : __byte_perm(pair[0], other, 0x5410);
      qa[((n0 + 8 * nt) / 4 + (t >> 1)) * kLDQ + 16 * mt + g + 8 * odd] = (int)word;
    }
  __syncthreads();
}

// c += a b over one m16n8k32 step of int8 operands on the integer tensor cores. The int32
// accumulator is carried through the mma: integer sums are exact in any order, and |c| <=
// W 127^2 < 2^31.
__device__ __forceinline__ void mma_s8(int (&c)[4], const uint32_t (&a)[4], uint2 b) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b.x), "r"(b.y));
}

// acc = kMagicBits + qa Wq over N = 64 NT columns with tc_layer's ownership (source note):
// qa [K4][kLDQ] words of the quantized activation, wq [K4][N] words of the int8 weights, k-steps
// of 32 in order (unrolled), the B words read through L1/L2 one k-step ahead of the MMAs that
// use them.
template <int NT, int K4>
__device__ __forceinline__ void tc_q8_mma(int (&acc)[kMT][NT][4], const int* __restrict__ qa,
                                          const int* __restrict__ wq) {
  constexpr int N = 64 * NT;
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int n0 = (threadIdx.x >> 5) * 8 * NT;
#pragma unroll
  for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[mt][nt][i] = kMagicBits;
  const int* bp = wq + (size_t)t * N + n0 + g;
  const int* ap = qa + t * kLDQ + g;
  uint2 b[NT];
#pragma unroll
  for (int nt = 0; nt < NT; ++nt)
    b[nt] = make_uint2((unsigned)__ldg(bp + 8 * nt), (unsigned)__ldg(bp + 4 * N + 8 * nt));
#pragma unroll
  for (int k4 = 0; k4 < K4; k4 += 8) {
    const int kn = k4 + 8 < K4 ? k4 + 8 : k4;
    uint2 bn[NT];
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
      bn[nt] = make_uint2((unsigned)__ldg(bp + (size_t)kn * N + 8 * nt),
                          (unsigned)__ldg(bp + (size_t)(kn + 4) * N + 8 * nt));
#pragma unroll
    for (int mt = 0; mt < kMT; ++mt) {
      const int* a = ap + k4 * kLDQ + 16 * mt;
      const uint32_t af[4] = {(uint32_t)a[0], (uint32_t)a[8], (uint32_t)a[4 * kLDQ],
                              (uint32_t)a[4 * kLDQ + 8]};
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) mma_s8(acc[mt][nt], af, b[nt]);
    }
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) b[nt] = bn[nt];
  }
}

// acc * (ms * s): the sum in acc (kMagicBits + sum) made a float exactly, then scaled.
__device__ __forceinline__ float dequant(int acc, float ms, float s) {
  return __fmul_rn(__fsub_rn(__int_as_float(acc), kMagic), __fmul_rn(ms, s));
}

// rnd<T> of a pair of floats: bfloat16 as one bf16x2 conversion.
template <typename T>
__device__ __forceinline__ void rnd2(float& x0, float& x1) {
  if constexpr (std::is_same<T, __nv_bfloat16>::value) {
    const __nv_bfloat162 b = __floats2bfloat162_rn(x0, x1);
    x0 = __low2float(b);
    x1 = __high2float(b);
  }
}

// The epilogue of an int8 layer, in the fragment layout: y = acc * (ms * s[c]); a trunk or
// feature layer adds the bias and then `post` ([N][kLD], a live skip's parked encoding
// product), the view layer (`hv_ray`, [n_rays][N]) adds its ray's term and then the bias; ReLU
// if asked, rounded to T, into v and, where `out` is given, transposed into out [N][kLD]
// (banks 8t + g). `post` may be `out` itself: each element is read before it is written, by the
// same thread, so neither is __restrict__.
template <typename T, int NT>
__device__ __forceinline__ void q8_epilogue(const int (&acc)[kMT][NT][4],
                                            const float (&ms)[kMT][2],
                                            const float* __restrict__ sc,
                                            const float* __restrict__ bias, const float* post,
                                            float* out, bool relu, Frag<NT>& v,
                                            const float* __restrict__ hv_ray = nullptr,
                                            int S = 1, int p0 = 0, int n_valid = kTP) {
  constexpr int N = 64 * NT;
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int n0 = (threadIdx.x >> 5) * 8 * NT;
  const int r_lo = p0 / S;
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) {
    const int c = n0 + 8 * nt + 2 * t;  // and c + 1
    const float s0 = sc[c], s1 = sc[c + 1], b0 = bias[c], b1 = bias[c + 1];
#pragma unroll
    for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int p = 16 * mt + g + 8 * h;
        const float y0 = dequant(acc[mt][nt][2 * h], ms[mt][h], s0);
        const float y1 = dequant(acc[mt][nt][2 * h + 1], ms[mt][h], s1);
        float x0, x1;
        if (hv_ray) {
          const float* hr = hv_ray + ((p0 + min(p, n_valid - 1)) / S - r_lo) * N + c;
          x0 = __fadd_rn(__fadd_rn(y0, hr[0]), b0);
          x1 = __fadd_rn(__fadd_rn(y1, hr[1]), b1);
        } else {
          x0 = __fadd_rn(y0, b0);
          x1 = __fadd_rn(y1, b1);
          if (post) {
            x0 = __fadd_rn(x0, post[c * kLD + p]);
            x1 = __fadd_rn(x1, post[(c + 1) * kLD + p]);
          }
        }
        if (relu) {
          x0 = fmaxf(x0, 0.f);
          x1 = fmaxf(x1, 0.f);
        }
        rnd2<T>(x0, x1);
        v[mt][nt][2 * h] = x0;
        v[mt][nt][2 * h + 1] = x1;
        if (out) {
          out[c * kLD + p] = x0;
          out[(c + 1) * kLD + p] = x1;
        }
      }
  }
}

// A live skip's encoding product enc W_l[:e_p] (float32 sums), unrounded, into out [W][kLD]:
// in bfloat16 on the tensor cores (tc_mac over the first pad16(e_p) columns of the layer's
// `wp` rows, [W][pad16(e_p) + W]), in float32 on FMA (mac over its `w` rows).
template <typename T, int W>
__device__ __forceinline__ void skip_product(const Net& net, const Smem& s, int l,
                                             float* __restrict__ out) {
  const int e_p = 3 + 6 * net.n_p;
  if constexpr (std::is_same<T, __nv_bfloat16>::value) {
    constexpr int NT = W / 64;
    const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
    const int n0 = (threadIdx.x >> 5) * 8 * NT, ep16 = pad16(e_p);
    float acc[kMT][NT][4];
#pragma unroll
    for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[mt][nt][i] = 0.f;
    tc_mac<NT>(acc, s.enc, ep16,
               reinterpret_cast<const __nv_bfloat16*>(net.wp) + net.poff[l], ep16 + W, n0, lane);
#pragma unroll
    for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int i = 0; i < 4; ++i)
          out[(n0 + 8 * nt + 2 * t + (i & 1)) * kLD + 16 * mt + g + 8 * (i >> 1)] =
              acc[mt][nt][i];
  } else {
    constexpr int NJ = W / 32;
    const int ty = threadIdx.x >> 5, tx = threadIdx.x & 31;
    float acc[8][NJ];
    init_acc<NJ>(acc, nullptr, tx);
    mac<T, NJ>(acc, s.enc, e_p, reinterpret_cast<const T*>(net.w) + net.woff[l], W, ty, tx);
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      float4* dst = reinterpret_cast<float4*>(out + (tx + 32 * j) * kLD + ty * 8);
      dst[0] = make_float4(acc[0][j], acc[1][j], acc[2][j], acc[3][j]);
      dst[1] = make_float4(acc[4][j], acc[5][j], acc[6][j], acc[7][j]);
    }
  }
}

// One tile of the int8 forward (see the source note). `fpart` as forward_tile's.
template <typename T, int W>
__device__ void forward_tile_q8(const Net& net, const NetQ8& q, const Smem& s,
                                int* __restrict__ qa, float* __restrict__ red,
                                const float* __restrict__ pts, const float* __restrict__ vd,
                                int P, int S, int p0, float* __restrict__ out,
                                float* __restrict__ fpart) {
  constexpr int NT = W / 64, WV = W / 2;
  const int e_p = 3 + 6 * net.n_p, e_v = 3 + 6 * net.n_v;
  const int n_valid = min(kTP, P - p0);
  const int r_lo = p0 / S;
  const int n_rays = (p0 + n_valid - 1) / S - r_lo + 1;
  const float* b = net.b;
  const int D = net.depth;
  const auto live_skip = [&](int l) { return l < D && ((net.skip_mask >> (l - 1)) & 1); };

  encode_tile<T>(s, pts, vd, P, S, p0, n_valid, e_p, e_v);
  __syncthreads();

  // First layer in T, as kernel 1: in bfloat16 on the tensor cores, in float32 on FMA.
  if constexpr (std::is_same<T, __nv_bfloat16>::value) {
    tc_layer<W / 64>(b + net.boff[0], s.enc, pad16(e_p), nullptr, 0,
                     reinterpret_cast<const __nv_bfloat16*>(net.wp) + net.poff[0], s.buf0, true,
                     nullptr, n_valid);
  } else {
    constexpr int NJ = W / 32;
    const int ty = threadIdx.x >> 5, tx = threadIdx.x & 31;
    float acc[8][NJ];
    init_acc<NJ>(acc, b + net.boff[0], tx);
    mac<T, NJ>(acc, s.enc, e_p, reinterpret_cast<const T*>(net.w) + net.woff[0], W, ty, tx);
    store<T, NJ>(acc, s.buf0, true, ty, tx);
  }
  __syncthreads();

  // Trunk layers 1..D-1 in int8, ping-ponging between buf0 and buf1. Each layer's input is
  // quantized from registers (the first from buf0); only the last trunk layer's output is
  // stored. A live skip's encoding product is parked (unrounded) in the destination buffer
  // before the quantization of the layer's input, whose barriers publish it to the epilogue,
  // which adds it after the dequantized product and the bias.
  Frag<NT> v;
  float ms[kMT][2];
  load_frag<NT>(s.buf0, v);
  float* h = s.buf0;
  if (live_skip(1)) skip_product<T, W>(net, s, 1, s.buf1);
  quantize_frag<NT>(v, qa, red, ms);
  for (int l = 1; l < D; ++l) {
    float* dst = (h == s.buf0) ? s.buf1 : s.buf0;
    int acc[kMT][NT][4];
    tc_q8_mma<NT, W / 4>(acc, qa, q.wq + q.qoff[l - 1]);
    q8_epilogue<T, NT>(acc, ms, q.sc + (size_t)(l - 1) * W, b + net.boff[l],
                       live_skip(l) ? dst : nullptr, l == D - 1 ? dst : nullptr, true, v);
    h = dst;
    if (live_skip(l + 1)) skip_product<T, W>(net, s, l + 1, (h == s.buf0) ? s.buf1 : s.buf0);
    quantize_frag<NT>(v, qa, red, ms);
  }
  float* feat = (h == s.buf0) ? s.buf1 : s.buf0;
  float* hbuf = h;

  // Sigma head (warps 0-1) beside the feature layer (linear) in int8; the feature activation is
  // stored only for kernel 11's partial sums.
  if (out) sigma_head<T, W>(net, h, out, P, p0, n_valid);
  {
    int acc[kMT][NT][4];
    tc_q8_mma<NT, W / 4>(acc, qa, q.wq + q.qoff[D - 1]);
    q8_epilogue<T, NT>(acc, ms, q.sc + (size_t)(D - 1) * W, b + net.boff[D + 1], nullptr,
                       fpart ? feat : nullptr, false, v);
  }
  quantize_frag<NT>(v, qa, red, ms);

  if (fpart) sem_partials<W>(feat, fpart, S, p0, n_valid, r_lo, n_rays);

  // Per-ray half of the view layer (T), once per ray, into the free trunk buffer (the sigma
  // head's reads of it ended before quantize_frag's barriers).
  float* hv = hbuf;                 // [WV][kLD]
  float* hv_ray = hbuf + WV * kLD;  // [n_rays][WV]
  view_ray_half<T, W>(net, s, hv_ray, n_rays, e_v);
  // View layer: the feature half in int8, then the ray's term, then the bias.
  {
    int acc[kMT][W / 128][4];
    Frag<W / 128> vv;
    tc_q8_mma<W / 128, W / 4>(acc, qa, q.wq + q.qoff[D]);
    __syncthreads();  // hv_ray
    q8_epilogue<T, W / 128>(acc, ms, q.sc + (size_t)D * W, b + net.boff[D + 2], nullptr, hv,
                            true, vv, hv_ray, S, p0, n_valid);
  }
  __syncthreads();

  if (out) rgb_head<T, W>(net, hv, out, P, p0, n_valid);
}

// Kernel 10 (fpart null) and kernel 11's trunk (fpart: MR x W floats a tile).
template <typename T, int W>
__global__ void __launch_bounds__(kThreads, 1)
    fused_nerf_q8_kernel(const Net net, const NetQ8 q, const float* __restrict__ pts,
                         const float* __restrict__ vd, float* __restrict__ out,
                         float* __restrict__ fpart, int MR, int P, int S) {
  extern __shared__ __align__(16) float smem[];
  const int e_p = 3 + 6 * net.n_p, e_v = 3 + 6 * net.n_v;
  const Smem s = carve(smem, W, e_p, e_v);
  float* tail = smem + fwd_smem_floats(W, e_p, e_v);
  int* qa = reinterpret_cast<int*>(tail);
  float* red = tail + (W / 4) * kLDQ;  // [kWarps][kTP] partial maxima
  forward_tile_q8<T, W>(net, q, s, qa, red, pts, vd, P, S, blockIdx.x * kTP, out,
                        fpart ? fpart + (size_t)blockIdx.x * MR * W : nullptr);
}

template <typename T, int W>
int launch(const Net& net, const NetQ8& q, const float* pts, const float* vd, float* out,
           float* fpart, int MR, int P, int S, cudaStream_t stream) {
  const size_t smem = sizeof(float) * (fwd_smem_floats(W, 3 + 6 * net.n_p, 3 + 6 * net.n_v) +
                                       q8_smem_floats(W));
  auto k = fused_nerf_q8_kernel<T, W>;
  cudaError_t e = cudaFuncSetAttribute(k, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  k<<<(P + kTP - 1) / kTP, kThreads, smem, stream>>>(net, q, pts, vd, out, fpart, MR, P, S);
  return (int)cudaGetLastError();
}

}  // namespace

// Kernel 10 (fpart null) or kernel 11's trunk (fpart: ceil(P / 64) x MR x W floats with
// MR >= sem_tile_slots(S), for S with sem_aligned(S)). Returns a cudaError_t (0 on success).
// w, wp, b, woff, boff and poff are kernel 1's packed weights (fused_nerf_fwd.cu; wp and poff,
// the tensor-core rows, bfloat16 only); wq, sc and qoff (host array of depth + 1 word offsets)
// the int8 layers of NetQ8.
extern "C" int fused_nerf_q8_launch(const float* pts, const float* vd, const void* w,
                                    const void* wp, const float* b, const int* wq,
                                    const float* sc, float* out, float* fpart, int MR, int P,
                                    int S, int depth, int width, int n_p, int n_v,
                                    int skip_mask, int is_bf16, const int* woff,
                                    const int* boff, const int* poff, const int* qoff,
                                    void* stream) {
  if (depth < 1 || depth > 8 || S < 1 || P % S != 0 || (width != 128 && width != 256) ||
      (fpart != nullptr && (!sem_aligned(S) || MR < sem_tile_slots(S))) ||
      (is_bf16 && (wp == nullptr || poff == nullptr)))
    return (int)cudaErrorInvalidValue;
  if (P == 0) return 0;
  const Net net = make_net(w, nullptr, is_bf16 ? wp : nullptr, b, depth, n_p, n_v, skip_mask,
                           woff, boff, is_bf16 ? poff : nullptr);
  NetQ8 q;
  q.wq = wq; q.sc = sc;
  for (int i = 0; i < kMaxLayers; ++i) q.qoff[i] = i < depth + 1 ? qoff[i] : 0;
  cudaStream_t s = (cudaStream_t)stream;
  if (is_bf16) {
    return width == 256 ? launch<__nv_bfloat16, 256>(net, q, pts, vd, out, fpart, MR, P, S, s)
                        : launch<__nv_bfloat16, 128>(net, q, pts, vd, out, fpart, MR, P, S, s);
  }
  return width == 256 ? launch<float, 256>(net, q, pts, vd, out, fpart, MR, P, S, s)
                      : launch<float, 128>(net, q, pts, vd, out, fpart, MR, P, S, s);
}

extern "C" const char* fused_nerf_q8_error_string(int e) {
  return cudaGetErrorString((cudaError_t)e);
}
