// Fused NeRF MLP backward for Hopper (sm_90a): weight and bias gradients of the MLP of
// fused_nerf_fwd.cu for a cotangent g [4, P] of its raw output.
//
// Replaces the Pallas TPU kernels of depth_lidar_nerf_tpu/ops/fused_mlp_t.py:
//   kernel 2  fused_nerf_bwd_dense_kernel   <- _bwd_kernel (body _bwd_tile_body, entry
//             _bwd_dense_dparams): recompute the forward of each tile, then backpropagate;
//   kernel 3  fused_nerf_bwd_culled_kernel  <- _bwd_kernel_culled (entry _bwd_culled_dparams):
//             kernel 2 that skips every tile whose flag is 0 (its cotangent is all zero, so
//             its contribution is exactly zero);
//   kernel 5  fused_nerf_bwd_acts_kernel    <- _bwd_kernel_acts (entry _bwd_acts_dparams):
//             the backward that reads the activations kernel 4 saved instead of
//             recomputing them; in bfloat16 phase 1 of the split backward (below), then
//             fused_nerf_wgrad_kernel;
//   kernel 8  fused_nerf_sem_head_bwd_kernel, then fused_nerf_bwd_acts_kernel<.., true>
//             <- _bwd_kernel_acts_sem (entry _bwd_acts_sem_dparams): the backward of the
//             semantic variant (kernel 7 in fused_nerf_fwd.cu). The head's backward runs on
//             per-ray operands, as the TPU kernel's does: from the per-ray logit cotangent
//             gsem [N, C] and kernel 7's saved fsum and s0r, gsb = gsem rounded to T;
//             d(W_s1) = s0r^T gsb; d(b_s1) = S sum gsem; ds0r = gsb W_s1^T (no activation
//             between the head layers); d(W_s0) = fsum^T ds0r rounded; d(b_s0) = S sum
//             ds0r; dfeat_ray = (ds0r rounded) W_s0^T rounded to T [N, W]. Then kernel 5's
//             body, where dfeat_ray of each point's ray is added to dhv W_v[:W]^T in float32
//             before dfeat is rounded (the TPU kernel's `dfeat_sem`);
//   fused_nerf_grad_reduce_kernel: the sum of the blocks' partial gradients (no TPU
//             counterpart: the TPU grid accumulated in one VMEM buffer in order).
// Points and view directions get no gradient (the JAX kernels return zeros).
//
// Per tile, as _bwd_tile_body: gb = g rounded to T; d(rgb W) = hv^T gb; d(rgb b) and
// d(sigma b) sum the float32 g; dhv = mask(hv > 0, gb W_rgb^T) rounded to T; d(views W)
// rows of feat = feat^T dhv; the per-ray rows: dhv summed over each ray's points in the
// tile, rounded to T, times the ray's view encoding; dfeat = dhv W_v[:W]^T rounded;
// d(feature W) = h^T dfeat; d(sigma W) = h^T gb[3]; dh = dfeat W_feat^T + gb[3] W_sigma^T;
// then per trunk layer, last to first: dh = mask(h_l > 0, dh) rounded, d(W_l) = h_{l-1}^T dh
// (the encoding's rows for a skip layer: enc^T dh; enc for layer 0), d(b_l) = sum dh, and
// dh = dh W_l[trunk rows]^T. Bias gradients are float32 sums of the rounded gradients.
// Gradients are float32, in the packed [in, out] layout of the forward's weights.
//
// Bound on the H100: operations. A point costs 2x the forward's multiply-adds in the
// backward (the input products and the weight products), 3x with the recompute: ~0.93 M
// at D = 4 / W = 256, against 16 bytes of cotangent (kernel 5 also reads the ~2.8 KB of
// saved activations a point in bfloat16, still far above the card's 295 FLOP per byte).
// In float32 every product runs on the CUDA cores (FMA). In bfloat16 the input products of
// kernels 2, 3, 5 and 8 run on the tensor cores (backward_tile's kTc, mma.sync m16n8k16), and the
// forward that kernels 2 and 3 recompute is forward_tile, whose bfloat16 products run on the
// tensor cores too (fused_nerf.cuh tc_layer), so its activations equal kernel 4's saved ones.
//
// Design. One block of 256 threads takes a tile of kTP = 64 points; a grid of one block
// per SM walks over the tiles in a fixed stride (block b takes tiles b, b + G, ...), so
// the live tiles of a sorted, culled cotangent spread evenly. Every tile contributes to
// every weight gradient (~315 K floats at D = 4 / W = 256), so each block adds its tiles'
// sums into its own float32 partial in device memory (no atomics), and
// fused_nerf_grad_reduce sums the G partials in a fixed order: repeated runs give
// bit-identical gradients. The recompute kernels keep the tile's activations in a
// per-block scratch in device memory (they do not fit in shared memory at D = 8), written
// by the forward and read by the same backward code as kernel 5. The weight products are
// outer products over the tile's 64 points with an 8 x 8 register tile per thread.
//
// The split backward (kernels 5 and 8 in bfloat16). Adding a tile's weight gradients into a
// partial of 1.2-2.4 MB moves 16 FLOP a byte, far below the card's 295, so in bfloat16 kernel
// 5's body runs in two phases over chunks of points (the wrappers' BWD_CHUNK). Phase 1, the
// chain (fused_nerf_bwd_acts_kernel, fused_nerf_bwd_chain_launch), backpropagates each tile,
// adds only the small gradients (rgb head, sigma column, the view layer's per-ray rows, the
// biases) into the block's partial and writes the tile's bfloat16 cotangents to a buffer laid
// out as the saved activations. Phase 2 (fused_nerf_wgrad_kernel, fused_nerf_wgrad_launch)
// forms every large weight gradient a^T b from the saved activations and those cotangents as
// one split-K GEMM on the tensor cores, each block keeping its output tile in registers over
// thousands of points and adding it once into its own partial row.

#include "fused_nerf.cuh"

namespace {

using namespace fnerf;

// This tile's rows of layer l of the split backward's cotangents (cstride rows a layer, the
// tile's first at crow0): l <= D the [W] layers (dh_0 .. dh_{D-1}, dfeat), D + 1 dhv ([W / 2]),
// D + 2 the encoding ([pad16(e_p)]).
template <typename T>
__device__ __forceinline__ T* cot_rows(T* cot, int l, int D, int W, int ep16, size_t cstride,
                                       size_t crow0) {
  const size_t base = (size_t)min(l, D + 1) * cstride * W;
  return cot + base + (l == D + 2 ? cstride * (W / 2) + crow0 * ep16
                                  : crow0 * (l == D + 1 ? W / 2 : W));
}

// ---- the backward tile's input products by route ----
//
// An input product dX = dY W^T of the tile (64 points x W columns) runs on the tensor cores
// (kTc: tc_mac_in, warp ty takes all 64 points and columns ty W / 8 .. ty W / 8 + W / 8 - 1)
// or on FMA (mac's 8 points x W / 32 columns a thread). BwdAcc is the route's accumulator.
template <int W, bool kTc>
using BwdAcc = std::conditional_t<kTc, float[kMT][W / 64][4], float[8][W / 32]>;

// acc = dy W^T over the layer's K outputs, from zero: on the tensor cores from the [in, out]
// weights at w (K a row), on FMA from the [out, in] weights at wt (ldwt a row).
template <typename T, int W, bool kTc>
__device__ __forceinline__ void input_product(BwdAcc<W, kTc>& acc, const float* __restrict__ dy,
                                              int K, const T* __restrict__ w,
                                              const T* __restrict__ wt, int ldwt, int ty,
                                              int tx) {
  if constexpr (kTc) {
#pragma unroll
    for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
      for (int nt = 0; nt < W / 64; ++nt)
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[mt][nt][i] = 0.f;
    tc_mac_in<W / 64>(acc, dy, K, w, K, ty * (W / 8), tx);
  } else {
    init_acc<W / 32>(acc, nullptr, tx);
    mac<T, W / 32>(acc, dy, K, wt, ldwt, ty, tx);
  }
}

// acc += the ray's dfeat_ray row ([N, W] in T) for each of the tile's valid points, in float32
// before the rounding (kernel 8's feature cotangent); on the tensor cores in tc_mac_in's
// fragment layout (lane (gq, t) of warp ty: points 16 mt + gq + 8 h, columns ty W / 8 + 8 nt +
// 2t and + 1).
template <typename T, int W, bool kTc>
__device__ __forceinline__ void add_ray_rows(BwdAcc<W, kTc>& acc,
                                             const T* __restrict__ dfeat_ray, int p0, int S,
                                             int n_valid, int ty, int tx) {
  if constexpr (kTc) {
    const int gq = tx >> 2, c0 = ty * (W / 8) + 2 * (tx & 3);
#pragma unroll
    for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int p = 16 * mt + gq + 8 * h;
        if (p < n_valid) {
          const T* row = dfeat_ray + (size_t)((p0 + p) / S) * W + c0;
#pragma unroll
          for (int nt = 0; nt < W / 64; ++nt) {
            acc[mt][nt][2 * h] += to_f<T>(row[8 * nt]);
            acc[mt][nt][2 * h + 1] += to_f<T>(row[8 * nt + 1]);
          }
        }
      }
  } else {
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int p = ty * 8 + i;
      if (p < n_valid) {
        const T* row = dfeat_ray + (size_t)((p0 + p) / S) * W + tx;
#pragma unroll
        for (int j = 0; j < W / 32; ++j) acc[i][j] += to_f<T>(row[32 * j]);
      }
    }
  }
}

// acc += gs[p] wsig[c]: the sigma head's term of the last trunk layer's cotangent (gs the
// rounded sigma cotangent of the tile's points, wsig the sigma weights [W] in T).
template <typename T, int W, bool kTc>
__device__ __forceinline__ void add_sigma(BwdAcc<W, kTc>& acc, const float* __restrict__ gs,
                                          const T* __restrict__ wsig, int ty, int tx) {
  if constexpr (kTc) {
    const int gq = tx >> 2, c0 = ty * (W / 8) + 2 * (tx & 3);
#pragma unroll
    for (int nt = 0; nt < W / 64; ++nt) {
      const float ws0 = to_f<T>(wsig[c0 + 8 * nt]), ws1 = to_f<T>(wsig[c0 + 8 * nt + 1]);
#pragma unroll
      for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const float g = gs[16 * mt + gq + 8 * h];
          acc[mt][nt][2 * h] = fmaf(g, ws0, acc[mt][nt][2 * h]);
          acc[mt][nt][2 * h + 1] = fmaf(g, ws1, acc[mt][nt][2 * h + 1]);
        }
    }
  } else {
#pragma unroll
    for (int j = 0; j < W / 32; ++j) {
      const float ws = to_f<T>(wsig[tx + 32 * j]);
#pragma unroll
      for (int i = 0; i < 8; ++i) acc[i][j] = fmaf(gs[ty * 8 + i], ws, acc[i][j]);
    }
  }
}

// The accumulator rounded to T where gate > 0 (everywhere without a gate), else 0, into `out`
// ([W][kLD]); on the tensor cores with `g`, also the tile's valid rows to device memory as
// [point][W] (on FMA, float32, there is no `g`).
template <typename T, int W, bool kTc>
__device__ __forceinline__ void store_grad(BwdAcc<W, kTc>& acc, const float* __restrict__ gate,
                                           float* __restrict__ out, T* __restrict__ g,
                                           int n_valid, int ty, int tx) {
  if constexpr (kTc)
    tc_store_masked<W / 64, W>(acc, gate, out, g, n_valid, ty * (W / 8), tx);
  else
    store_masked<T, W / 32>(acc, gate, out, ty, tx);
}

// The backward of one tile (see the source note), reading the tile's activations from
// `acts` as forward_tile writes them, and adding the tile's gradients into the block's
// partial: weights at gw + woff[l], biases at gbias + boff[l]. Expects s.enc and s.encv
// to hold the tile's encodings. With `dfeat_ray` ([N, W] in T), each point's feature
// cotangent also gets its ray's row (kernel 8). The input products run on the tensor cores in
// bfloat16 (kTc: kernels 2, 3, 5 and 8), else on FMA (float32).
//
// With kSplit (bfloat16: the chain of the split backward, kernels 5 and 8) it forms no large
// weight gradient: it writes the tile's cotangents instead, as [point][C] rows of bfloat16 at
// row crow0 of each layer of `cot` (cstride rows a layer, cot_rows): dh_0 .. dh_{D-1} and
// dfeat ([W] each), dhv ([W / 2]), then the encoding ([pad16(e_p)], its padded columns zero),
// for fused_nerf_wgrad_kernel; the small gradients (the rgb head, the sigma column, the view
// layer's per-ray rows, every bias) still go into the block's partial.
//
// On the tensor cores the float32 sums run in another order than the twin's float32 products,
// so some bfloat16 cotangents round the other way; carried down the chain, that moves the trunk
// gradients by up to a few 1e-3 of their mean from the twin's, as far as the twin lies from a
// float64 chain. The products and the roundings are those of the twin, and the cotangents are
// held against float64 products of the same operands (fused_mlp_t.bwd_product_witness).
template <typename T, int W, bool kSplit>
__device__ void backward_tile(const Net& net, const Smem& s, const float* __restrict__ g, int P,
                              int S, int p0, const T* __restrict__ acts, size_t lstride,
                              size_t row0, float* __restrict__ gw, float* __restrict__ gbias,
                              const T* __restrict__ dfeat_ray = nullptr,
                              T* __restrict__ cot = nullptr, size_t cstride = 0,
                              size_t crow0 = 0) {
  constexpr bool kTc = std::is_same<T, __nv_bfloat16>::value;
  static_assert(!kSplit || kTc, "the split backward is bfloat16 only");
  constexpr int NJV = W / 64;
  constexpr int WV = W / 2;
  const int e_p = 3 + 6 * net.n_p, e_v = 3 + 6 * net.n_v;
  const int tid = threadIdx.x, ty = tid >> 5, tx = tid & 31;
  const int n_valid = min(kTP, P - p0);
  const int r_lo = p0 / S;
  const int n_rays = (p0 + n_valid - 1) / S - r_lo + 1;
  const int D = net.depth;
  const T* wt = reinterpret_cast<const T*>(net.wt);
  const T* w = reinterpret_cast<const T*>(net.wi);
  const T* arow = acts + row0 * W;
  float* A = s.buf0;   // activation operand
  float* Dg = s.buf1;  // gradient operand
  const int ep16 = pad16(e_p);
  // this tile's rows of cotangent layer l (kSplit), else null
  auto crow = [&](int l) -> T* {
    return kSplit ? cot_rows(cot, l, D, W, ep16, cstride, crow0) : nullptr;
  };

  // Cotangent, rounded; the rgb and sigma bias gradients sum the float32 cotangent.
  for (int idx = tid; idx < 4 * kTP; idx += kThreads) {
    const int c = idx / kTP, p = idx % kTP;
    s.gb[c * kLD + p] = p < n_valid ? rnd<T>(g[(size_t)c * P + p0 + p]) : 0.f;
  }
  if (tid < 4) {
    float sm = 0.f;
    for (int p = 0; p < n_valid; ++p) sm += g[(size_t)tid * P + p0 + p];
    if (tid < 3) gbias[net.boff[D + 3] + tid] += sm;
    else gbias[net.boff[D]] += sm;
  }
  load_rows<T>(A, acts + (D + 1) * lstride + row0 * WV, WV, n_valid);  // hv
  if constexpr (kSplit)
    write_rows(crow(D + 2), s.enc, ep16, n_valid);
  __syncthreads();

  // rgb head (K = 3, on FMA): d(W_rgb)[k][c] = sum_p hv[k][p] gb[c][p]; dhv = mask(hv, gb W_rgb^T).
  for (int idx = tid; idx < WV * 3; idx += kThreads) {
    const int k = idx / 3, c = idx % 3;
    float sm = 0.f;
    for (int p = 0; p < kTP; ++p) sm = fmaf(A[k * kLD + p], s.gb[c * kLD + p], sm);
    gw[net.woff[D + 3] + k * 3 + c] += sm;
  }
  {
    float accv[8][NJV];
    init_acc<NJV>(accv, nullptr, tx);
    mac<T, NJV>(accv, s.gb, 3, wt + net.woff[D + 3], WV, ty, tx);
    store_masked<T, NJV>(accv, A, Dg, ty, tx);  // dhv [WV][kLD]
  }
  __syncthreads();
  if constexpr (kSplit) write_rows(crow(D + 1), Dg, WV, n_valid);

  // View layer: the feat rows (not with kSplit) and the per-ray rows of d(W_v), d(b_v); then
  // dfeat = dhv W_v[:W]^T, plus the ray's dfeat_ray row in float32 before the rounding.
  if constexpr (!kSplit) load_rows<T>(A, arow + D * lstride, W, n_valid);  // feat
  for (int idx = tid; idx < n_rays * WV; idx += kThreads) {
    const int r = idx / WV, k = idx % WV;
    const int lo = max(0, (r_lo + r) * S - p0), hi = min(n_valid, (r_lo + r + 1) * S - p0);
    float sm = 0.f;
    for (int p = lo; p < hi; ++p) sm += Dg[k * kLD + p];
    s.seg[r * WV + k] = rnd<T>(sm);
  }
  __syncthreads();
  if constexpr (!kSplit) outer(gw + net.woff[D + 2], A, W, Dg, WV, ty, tx);
  bias_sum(gbias + net.boff[D + 2], Dg, WV);
  for (int idx = tid; idx < e_v * WV; idx += kThreads) {
    const int e = idx / WV, k = idx % WV;
    float sm = 0.f;
    for (int r = 0; r < n_rays; ++r) sm = fmaf(s.encv[r * e_v + e], s.seg[r * WV + k], sm);
    gw[net.woff[D + 2] + (W + e) * WV + k] += sm;
  }
  BwdAcc<W, kTc> acc;
  input_product<T, W, kTc>(acc, Dg, WV, w + net.woff[D + 2], wt + net.woff[D + 2], W + e_v, ty,
                           tx);
  if (dfeat_ray) add_ray_rows<T, W, kTc>(acc, dfeat_ray, p0, S, n_valid, ty, tx);  // kernel 8
  __syncthreads();
  store_grad<T, W, kTc>(acc, nullptr, Dg, crow(D), n_valid, ty, tx);  // dfeat [W][kLD]
  load_rows<T>(A, arow + (D - 1) * lstride, W, n_valid);              // h_{D-1}
  __syncthreads();

  // Feature and sigma heads: d(W_feat) (not with kSplit), d(b_feat), d(W_sigma); dh.
  if constexpr (!kSplit) outer(gw + net.woff[D + 1], A, W, Dg, W, ty, tx);
  bias_sum(gbias + net.boff[D + 1], Dg, W);
  for (int k = tid; k < W; k += kThreads) {
    float sm = 0.f;
    for (int p = 0; p < kTP; ++p) sm = fmaf(A[k * kLD + p], s.gb[3 * kLD + p], sm);
    gw[net.woff[D] + k] += sm;
  }
  input_product<T, W, kTc>(acc, Dg, W, w + net.woff[D + 1], wt + net.woff[D + 1], W, ty, tx);
  add_sigma<T, W, kTc>(acc, s.gb + 3 * kLD, wt + net.woff[D], ty, tx);
  __syncthreads();

  // Trunk, last layer to first; A holds h_l when layer l starts.
  for (int l = D - 1; l >= 0; --l) {
    store_grad<T, W, kTc>(acc, A, Dg, crow(l), n_valid, ty, tx);  // dh_l
    __syncthreads();
    if (l == 0) {
      if constexpr (!kSplit) outer(gw + net.woff[0], s.enc, e_p, Dg, W, ty, tx);
      bias_sum(gbias + net.boff[0], Dg, W);
      break;
    }
    const bool skip = (net.skip_mask >> (l - 1)) & 1;
    load_rows<T>(A, arow + (l - 1) * lstride, W, n_valid);  // h_{l-1}
    __syncthreads();
    if constexpr (!kSplit) {
      outer(gw + net.woff[l] + (skip ? e_p * W : 0), A, W, Dg, W, ty, tx);
      if (skip) outer(gw + net.woff[l], s.enc, e_p, Dg, W, ty, tx);
    }
    bias_sum(gbias + net.boff[l], Dg, W);
    input_product<T, W, kTc>(acc, Dg, W, w + net.woff[l] + (skip ? e_p * W : 0),
                             wt + net.woff[l] + (skip ? e_p : 0), W + (skip ? e_p : 0), ty, tx);
    __syncthreads();
  }
  __syncthreads();
}

// ---- phase 2 of the split backward: the weight gradients as one split-K GEMM ----

constexpr int kWgM = 128, kWgN = 128;  // output tile (rows of A^T, columns of B)
constexpr int kWgK = 32;               // points a stage
constexpr int kWgStages = 4;           // cp.async ring
constexpr int kWgLD = kWgM + 8;        // shared row stride (bf16): 272 bytes, so the 8 row
                                       // addresses of an ldmatrix hit distinct banks
constexpr int kMaxWgrad = 20;          // products a launch: at most 2 D + 1 at D <= 8

// One product dW[m][n] += sum_p a[p][m] b[p][n] for m < m_keep, n < n, into the float32
// partial at `out` with row stride ldo. a is [P][lda] (columns m < m_op read, the rest of the
// output tile zero), b is [P][ldb], both bfloat16.
struct WgradEntry {
  const __nv_bfloat16* a;
  const __nv_bfloat16* b;
  long long out;
  int lda, ldb, m_op, n, m_keep, ldo;
  int tile0, tiles_n;  // first output tile of this product in the grid; tiles across n
};

struct WgradTable {
  WgradEntry e[kMaxWgrad];
  int n_entries;
};

__device__ __forceinline__ void cp_async16(void* dst, const void* src, int bytes) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d), "l"(src), "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}
// Four transposed 8 x 8 bfloat16 matrices from shared memory; lane l gives the address of row
// l % 8 of matrix l / 8.
__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], const __nv_bfloat16* p) {
  const unsigned a = (unsigned)__cvta_generic_to_shared(p);
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(a)
               : "memory");
}

// Block (x, y) takes output tile x of the table (128 x 128: 8 warps as 2 x 4, each 64 x 32) and
// the y-th of gridDim.y equal ranges of the points (split-K). Stages of 32 points of a and b
// come into shared memory by cp.async (rows past P and columns past the operand's width fill
// with zeros), the fragments by ldmatrix.trans (the reduction runs over the leading dimension
// of both operands), the products by mma.sync m16n8k16, each k-step's 16 summed from zero and
// added to the float32 accumulators (fused_nerf.cuh mma_bf16). The tile is added once into
// row y of the partial, part + y * part_stride, whose entries no other block of the launch
// touches.
//
// Bound on the H100: bytes. A W = 256 product does 2 x 256 x 256 FLOP a point against 1 KB of
// operands read once, 128 FLOP a byte, below the card's 295. The kernel reads each operand
// once for each 128-wide tile of the other (twice at W = 256), the second time mostly from L2,
// since the tiles of one split run side by side. It is the simple form: mma.sync from
// ldmatrix on a ring of four 32-point stages filled by cp.async, no TMA or wgmma.
__global__ void __launch_bounds__(kThreads, 2)
    fused_nerf_wgrad_kernel(const WgradTable tab, int P, float* __restrict__ part,
                            size_t part_stride) {
  extern __shared__ __align__(16) unsigned char wg_smem[];
  __nv_bfloat16* As = reinterpret_cast<__nv_bfloat16*>(wg_smem);  // [stage][kWgK][kWgLD]
  __nv_bfloat16* Bs = As + kWgStages * kWgK * kWgLD;
  int ei = 0;
  while (ei + 1 < tab.n_entries && (int)blockIdx.x >= tab.e[ei + 1].tile0) ++ei;
  const WgradEntry& e = tab.e[ei];
  const int tile = blockIdx.x - e.tile0;
  const int m0 = (tile / e.tiles_n) * kWgM, n0 = (tile % e.tiles_n) * kWgN;
  const int n_kb = (P + kWgK - 1) / kWgK;
  const int kb0 = (int)((long long)blockIdx.y * n_kb / gridDim.y);
  const int kb1 = (int)((long long)(blockIdx.y + 1) * n_kb / gridDim.y);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = warp >> 2, wn = warp & 3;

  auto load = [&](int kb, int st) {
#pragma unroll
    for (int i = tid; i < 2 * kWgK * 16; i += kThreads) {
      const bool isb = i >= kWgK * 16;
      const int j = isb ? i - kWgK * 16 : i;
      const int r = j >> 4, c = (j & 15) * 8;
      const int p = kb * kWgK + r;
      const int col = (isb ? n0 : m0) + c;
      const bool ok = p < P && col < (isb ? e.n : e.m_op);
      const __nv_bfloat16* src = isb ? e.b : e.a;
      if (ok) src += (size_t)p * (isb ? e.ldb : e.lda) + col;
      cp_async16((isb ? Bs : As) + (st * kWgK + r) * kWgLD + c, src, ok ? 16 : 0);
    }
  };

  float acc[4][4][4];
#pragma unroll
  for (int mt = 0; mt < 4; ++mt)
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[mt][nt][i] = 0.f;

#pragma unroll
  for (int st = 0; st < kWgStages - 1; ++st) {
    if (kb0 + st < kb1) load(kb0 + st, st);
    cp_async_commit();
  }
  for (int kb = kb0; kb < kb1; ++kb) {
    cp_async_wait<kWgStages - 2>();
    __syncthreads();  // stage kb has landed; every warp is done with stage kb - 1
    const int nk = kb + kWgStages - 1;
    if (nk < kb1) load(nk, (nk - kb0) % kWgStages);
    cp_async_commit();
    const int st = (kb - kb0) % kWgStages;
    const __nv_bfloat16* as = As + st * kWgK * kWgLD;
    const __nv_bfloat16* bs = Bs + st * kWgK * kWgLD;
#pragma unroll
    for (int ks = 0; ks < kWgK; ks += 16) {
      uint32_t af[4][4];
      uint2 bf[4];
#pragma unroll
      for (int mt = 0; mt < 4; ++mt)
        ldsm_x4_t(af[mt], as + (ks + (lane & 7) + 8 * (lane >> 4)) * kWgLD + 64 * wm + 16 * mt +
                              8 * ((lane >> 3) & 1));
#pragma unroll
      for (int np = 0; np < 2; ++np) {
        uint32_t r[4];
        ldsm_x4_t(r, bs + (ks + (lane & 7) + 8 * ((lane >> 3) & 1)) * kWgLD + 32 * wn +
                         16 * np + 8 * (lane >> 4));
        bf[2 * np] = make_uint2(r[0], r[1]);
        bf[2 * np + 1] = make_uint2(r[2], r[3]);
      }
#pragma unroll
      for (int mt = 0; mt < 4; ++mt)
#pragma unroll
        for (int nt = 0; nt < 4; ++nt) mma_bf16(acc[mt][nt], af[mt], bf[nt]);
    }
  }
  cp_async_wait<0>();

  float* out = part + (size_t)blockIdx.y * part_stride + e.out;
  const int gq = lane >> 2, tq = lane & 3;
#pragma unroll
  for (int mt = 0; mt < 4; ++mt)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int m = m0 + 64 * wm + 16 * mt + gq + 8 * h;
      if (m >= e.m_keep) continue;
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        const int n = n0 + 32 * wn + 8 * nt + 2 * tq;
        if (n < e.n) out[(size_t)m * e.ldo + n] += acc[mt][nt][2 * h];
        if (n + 1 < e.n) out[(size_t)m * e.ldo + n + 1] += acc[mt][nt][2 * h + 1];
      }
    }
}

constexpr size_t kWgSmem = sizeof(__nv_bfloat16) * 2 * kWgStages * kWgK * kWgLD;

// Kernels 2 and 3: the recompute backward, dense (flags == nullptr) or culled.
template <typename T, int W, bool kCulled>
__global__ void __launch_bounds__(kThreads, 1)
    fused_nerf_bwd_recompute_kernel(const Net net, const float* __restrict__ pts,
                                    const float* __restrict__ vd, const float* __restrict__ g,
                                    const int* __restrict__ flags, T* __restrict__ scratch,
                                    float* __restrict__ part, size_t part_stride, int n_w,
                                    int P, int S) {
  extern __shared__ __align__(16) float smem[];
  const Smem s = carve(smem, W, 3 + 6 * net.n_p, 3 + 6 * net.n_v);
  const int n_tiles = (P + kTP - 1) / kTP;
  const size_t lstride = (size_t)kTP * W;
  T* mine = scratch + blockIdx.x * ((net.depth + 1) * lstride + kTP * (W / 2));
  float* gw = part + blockIdx.x * part_stride;
  for (int t = blockIdx.x; t < n_tiles; t += gridDim.x) {
    if (kCulled && flags[t] == 0) continue;
    forward_tile<T, W>(net, s, pts, vd, P, S, t * kTP, nullptr, mine, lstride, 0);
    __syncthreads();
    backward_tile<T, W, false>(net, s, g, P, S, t * kTP, mine, lstride, 0, gw, gw + n_w);
  }
}

// Kernel 5 (kSem false): the backward from the activations kernel 4 saved; with kSem, the
// trunk of kernel 8, which also takes the semantic head's per-ray feature cotangent. It takes
// the tiles of points [c0, c0 + n_pts) (c0 a multiple of kTP). In bfloat16 it is phase 1 of the
// split backward (backward_tile with kSplit, its input products on the tensor cores): it writes
// the cotangents of those points to `cot` (n_pts rows a layer) for fused_nerf_wgrad_kernel; in
// float32 it forms every gradient (c0 = 0, n_pts = P, no cot).
template <typename T, int W, bool kSem>
__global__ void __launch_bounds__(kThreads, 1)
    fused_nerf_bwd_acts_kernel(const Net net, const float* __restrict__ pts,
                               const float* __restrict__ vd, const float* __restrict__ g,
                               const T* __restrict__ acts, const T* __restrict__ dfeat_ray,
                               float* __restrict__ part, size_t part_stride, int n_w, int P,
                               int S, T* __restrict__ cot, int c0, int n_pts) {
  constexpr bool kSplit = std::is_same<T, __nv_bfloat16>::value;
  extern __shared__ __align__(16) float smem[];
  const int e_p = 3 + 6 * net.n_p, e_v = 3 + 6 * net.n_v;
  const Smem s = carve(smem, W, e_p, e_v);
  const int n_tiles = (n_pts + kTP - 1) / kTP;
  float* gw = part + blockIdx.x * part_stride;
  for (int t = blockIdx.x; t < n_tiles; t += gridDim.x) {
    const int p0 = c0 + t * kTP;
    encode_tile<T>(s, pts, vd, P, S, p0, min(kTP, P - p0), e_p, e_v);
    __syncthreads();
    backward_tile<T, W, kSplit>(net, s, g, P, S, p0, acts, (size_t)P * W, (size_t)p0, gw,
                                gw + n_w, kSem ? dfeat_ray : nullptr, cot, (size_t)n_pts,
                                (size_t)t * kTP);
  }
}

constexpr int kHeadRays = 16;  // rays per step of the semantic head's backward

__host__ __device__ inline size_t head_bwd_smem_floats(int W, int C) {
  return (size_t)kHeadRays * (W + 3 * (W / 2) + 2 * C);
}

// The semantic head's backward of kernel 8 (see the source note). Block b takes the groups of
// kHeadRays rays b, b + G, ... and adds their head gradients into its own float32 partial
// (part + b * part_stride: d(W_s0) [W][W/2], d(b_s0) [W/2], d(W_s1) [W/2][C], d(b_s1) [C],
// the [in, out] layout), each entry always by the same thread, so a fixed-order reduction
// gives the same sums on every run. sem_acts is kernel 7's [N, W + W/2] (fsum, s0r);
// ws0t [W/2, W] and ws1t [C, W/2] are the head weights as [out, in] in T.
template <typename T, int W>
__global__ void __launch_bounds__(kThreads)
    fused_nerf_sem_head_bwd_kernel(const float* __restrict__ gsem, const T* __restrict__ sem_acts,
                                   const T* __restrict__ ws0t, const T* __restrict__ ws1t,
                                   T* __restrict__ dfeat_ray, float* __restrict__ part,
                                   size_t part_stride, int N, int S, int C) {
  constexpr int WH = W / 2, RB = kHeadRays;
  extern __shared__ __align__(16) float smem[];
  float* fs = smem;          // [RB][W] fsum
  float* s0 = fs + RB * W;   // [RB][WH] s0r
  float* ds = s0 + RB * WH;  // [RB][WH] ds0r, float32
  float* dsb = ds + RB * WH; // [RB][WH] ds0r rounded to T
  float* gs = dsb + RB * WH; // [RB][C] gsem, float32
  float* gsb = gs + RB * C;  // [RB][C] gsem rounded to T
  const int tid = threadIdx.x;
  const float Sf = (float)S;
  float* g_ws0 = part + blockIdx.x * part_stride;
  float* g_bs0 = g_ws0 + W * WH;
  float* g_ws1 = g_bs0 + WH;
  float* g_bs1 = g_ws1 + WH * C;
  const int n_groups = (N + RB - 1) / RB;
  for (int grp = blockIdx.x; grp < n_groups; grp += gridDim.x) {
    const int r0 = grp * RB;
    for (int idx = tid; idx < RB * C; idx += kThreads) {
      const int R = r0 + idx / C;
      const float v = R < N ? gsem[(size_t)R * C + idx % C] : 0.f;
      gs[idx] = v;
      gsb[idx] = rnd<T>(v);
    }
    for (int idx = tid; idx < RB * W; idx += kThreads) {
      const int R = r0 + idx / W;
      fs[idx] = R < N ? to_f<T>(sem_acts[(size_t)R * (W + WH) + idx % W]) : 0.f;
    }
    for (int idx = tid; idx < RB * WH; idx += kThreads) {
      const int R = r0 + idx / WH;
      s0[idx] = R < N ? to_f<T>(sem_acts[(size_t)R * (W + WH) + W + idx % WH]) : 0.f;
    }
    __syncthreads();
    for (int idx = tid; idx < RB * WH; idx += kThreads) {
      const int r = idx / WH, k = idx % WH;
      float acc = 0.f;
      for (int c = 0; c < C; ++c)
        acc = fmaf(gsb[r * C + c], to_f<T>(ws1t[(size_t)c * WH + k]), acc);
      ds[idx] = acc;
      dsb[idx] = rnd<T>(acc);
    }
    __syncthreads();
    for (int idx = tid; idx < RB * W; idx += kThreads) {
      const int r = idx / W, i = idx % W, R = r0 + r;
      if (R >= N) continue;
      float acc = 0.f;
      for (int k = 0; k < WH; ++k)
        acc = fmaf(dsb[r * WH + k], to_f<T>(ws0t[(size_t)k * W + i]), acc);
      dfeat_ray[(size_t)R * W + i] = from_f<T>(acc);
    }
    for (int e = tid; e < W * WH; e += kThreads) {
      const int i = e / WH, k = e % WH;
      float sm = 0.f;
      for (int r = 0; r < RB; ++r) sm = fmaf(fs[r * W + i], dsb[r * WH + k], sm);
      g_ws0[e] += sm;
    }
    for (int k = tid; k < WH; k += kThreads) {
      float sm = 0.f;
      for (int r = 0; r < RB; ++r) sm += ds[r * WH + k];
      g_bs0[k] += Sf * sm;
    }
    for (int e = tid; e < WH * C; e += kThreads) {
      const int k = e / C, c = e % C;
      float sm = 0.f;
      for (int r = 0; r < RB; ++r) sm = fmaf(s0[r * WH + k], gsb[r * C + c], sm);
      g_ws1[e] += sm;
    }
    for (int c = tid; c < C; c += kThreads) {
      float sm = 0.f;
      for (int r = 0; r < RB; ++r) sm += gs[r * C + c];
      g_bs1[c] += Sf * sm;
    }
    __syncthreads();
  }
}

// out[i] = sum over b < G of part[b * part_stride + i], in the order of b.
__global__ void fused_nerf_grad_reduce_kernel(const float* __restrict__ part,
                                              size_t part_stride, int G, int n,
                                              float* __restrict__ out) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  float sm = 0.f;
  for (int b = 0; b < G; ++b) sm += part[(size_t)b * part_stride + i];
  out[i] = sm;
}

template <typename K>
cudaError_t prepare(K kernel, size_t smem) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

// mode 0: dense recompute (kernel 2), 1: culled recompute (kernel 3), 2: saved acts (kernel 5,
// or kernel 8's trunk with dfeat_ray; in bfloat16 phase 1 of the split backward over the points
// [c0, c0 + n_pts), writing `cot`).
template <typename T, int W>
int launch(int mode, const Net& net, const float* pts, const float* vd, const float* g,
           const int* flags, const void* acts, const void* dfeat_ray, void* scratch,
           float* part, size_t part_stride, int G, int n_w, int P, int S, cudaStream_t stream,
           void* cot = nullptr, int c0 = 0, int n_pts = 0) {
  const size_t smem = sizeof(float) * bwd_smem_floats(W, 3 + 6 * net.n_p, 3 + 6 * net.n_v);
  cudaError_t e;
  const T* a = reinterpret_cast<const T*>(acts);
  const T* dr = reinterpret_cast<const T*>(dfeat_ray);
  if (mode == 2 && dfeat_ray != nullptr) {
    auto k = fused_nerf_bwd_acts_kernel<T, W, true>;
    if ((e = prepare(k, smem)) != cudaSuccess) return (int)e;
    k<<<G, kThreads, smem, stream>>>(net, pts, vd, g, a, dr, part, part_stride, n_w, P, S,
                                     reinterpret_cast<T*>(cot), c0, n_pts);
  } else if (mode == 2) {
    auto k = fused_nerf_bwd_acts_kernel<T, W, false>;
    if ((e = prepare(k, smem)) != cudaSuccess) return (int)e;
    k<<<G, kThreads, smem, stream>>>(net, pts, vd, g, a, nullptr, part, part_stride, n_w, P, S,
                                     reinterpret_cast<T*>(cot), c0, n_pts);
  } else if (mode == 1) {
    auto k = fused_nerf_bwd_recompute_kernel<T, W, true>;
    if ((e = prepare(k, smem)) != cudaSuccess) return (int)e;
    k<<<G, kThreads, smem, stream>>>(net, pts, vd, g, flags, reinterpret_cast<T*>(scratch),
                                     part, part_stride, n_w, P, S);
  } else {
    auto k = fused_nerf_bwd_recompute_kernel<T, W, false>;
    if ((e = prepare(k, smem)) != cudaSuccess) return (int)e;
    k<<<G, kThreads, smem, stream>>>(net, pts, vd, g, nullptr, reinterpret_cast<T*>(scratch),
                                     part, part_stride, n_w, P, S);
  }
  return (int)cudaGetLastError();
}

}  // namespace

// Kernels 2, 3, 5 and kernel 8's trunk. Returns a cudaError_t (0 on success).
//   mode     0 dense recompute, 1 culled recompute (flags [ceil(P / 64)] int32: 0 skips the
//            tile of points [64 t, 64 t + 64)), 2 saved activations (acts as kernel 4 wrote
//            them; float32 only: in bfloat16 it is fused_nerf_bwd_chain_launch);
//   dfeat_ray (mode 2 only, may be null) the semantic head's feature cotangent [P / S, W]
//            in T, from fused_nerf_sem_head_bwd_launch: kernel 8's trunk;
//   w, wt    the packed weights [in, out] and [out, in] in T; b the packed biases;
//   wp, poff the tensor-core rows of the recompute's forward (fused_nerf.cuh; modes 0 and 1
//            in bfloat16; may be null otherwise) and their offsets;
//   wi       the backward's tensor-core rows (tc_mac_in; pack_params' weights_ip, at woff;
//            modes 0 and 1 in bfloat16; may be null otherwise);
//   scratch  G x ((D + 1) 64 W + 64 W / 2) elements of T (modes 0 and 1);
//   part     G rows of part_stride floats, zeroed: row b is block b's partial gradient,
//            weights first (n_w floats, packed [in, out] offsets) then biases.
// G is the grid (blocks); the caller sums the rows with fused_nerf_grad_reduce_launch.
extern "C" int fused_nerf_bwd_launch(int mode, const float* pts, const float* vd,
                                     const float* g, const int* flags, const void* acts,
                                     const void* dfeat_ray, const void* w, const void* wt,
                                     const void* wp, const void* wi, const float* b,
                                     void* scratch,
                                     float* part, long long part_stride, int G, int n_w, int P,
                                     int S, int depth, int width, int n_p, int n_v,
                                     int skip_mask, int is_bf16, const int* woff,
                                     const int* boff, const int* poff, void* stream) {
  if (depth < 1 || depth > 8 || S < 1 || P % S != 0 || (width != 128 && width != 256) ||
      mode < 0 || mode > 2 || G < 1 || (mode == 1 && flags == nullptr) ||
      (mode == 2 && acts == nullptr) || (mode != 2 && scratch == nullptr) ||
      (mode != 2 && dfeat_ray != nullptr) || part_stride % 4 ||
      (is_bf16 && mode != 2 && (wp == nullptr || poff == nullptr || wi == nullptr)) ||
      (is_bf16 && mode == 2))
    return (int)cudaErrorInvalidValue;
  if (P == 0) return 0;
  Net net = make_net(w, wt, wp, b, depth, n_p, n_v, skip_mask, woff, boff, poff);
  net.wi = wi;
  cudaStream_t s = (cudaStream_t)stream;
  const size_t ps = (size_t)part_stride;
  if (is_bf16) {
    return width == 256 ? launch<__nv_bfloat16, 256>(mode, net, pts, vd, g, flags, acts,
                                                     dfeat_ray, scratch, part, ps, G, n_w, P,
                                                     S, s)
                        : launch<__nv_bfloat16, 128>(mode, net, pts, vd, g, flags, acts,
                                                     dfeat_ray, scratch, part, ps, G, n_w, P,
                                                     S, s);
  }
  return width == 256 ? launch<float, 256>(mode, net, pts, vd, g, flags, acts, dfeat_ray,
                                           scratch, part, ps, G, n_w, P, S, s, nullptr, 0, P)
                      : launch<float, 128>(mode, net, pts, vd, g, flags, acts, dfeat_ray,
                                           scratch, part, ps, G, n_w, P, S, s, nullptr, 0, P);
}

// Phase 1 of the split backward of kernels 5 and 8 (bfloat16; kernel 5's arguments as for
// fused_nerf_bwd_launch mode 2) over the points [c0, c0 + n_pts): c0 a multiple of 64, P the
// points of acts, g, pts. Adds the small gradients into part's G rows and writes the
// cotangents of those points to `cot` (bfloat16, n_pts rows a layer): dh_0 .. dh_{D-1} and
// dfeat [n_pts][W] each, dhv [n_pts][W / 2], the encoding [n_pts][pad16(e_p)]. Their weight
// gradients are fused_nerf_wgrad_launch's. wi as for fused_nerf_bwd_launch (the input
// products read it).
extern "C" int fused_nerf_bwd_chain_launch(const float* pts, const float* vd, const float* g,
                                           const void* acts, const void* dfeat_ray,
                                           const void* w, const void* wt, const void* wi,
                                           const float* b, void* cot, float* part,
                                           long long part_stride,
                                           int G, int n_w, int P, int S, int c0, int n_pts,
                                           int depth, int width, int n_p, int n_v,
                                           int skip_mask, const int* woff, const int* boff,
                                           void* stream) {
  if (depth < 1 || depth > 8 || S < 1 || P % S != 0 || (width != 128 && width != 256) ||
      G < 1 || acts == nullptr || cot == nullptr || wi == nullptr || part_stride % 4 ||
      c0 < 0 || c0 % kTP != 0 || n_pts < 0 || c0 + n_pts > P)
    return (int)cudaErrorInvalidValue;
  if (n_pts == 0) return 0;
  Net net = make_net(w, wt, nullptr, b, depth, n_p, n_v, skip_mask, woff, boff, nullptr);
  net.wi = wi;
  cudaStream_t s = (cudaStream_t)stream;
  const size_t ps = (size_t)part_stride;
  return width == 256 ? launch<__nv_bfloat16, 256>(2, net, pts, vd, g, nullptr, acts, dfeat_ray,
                                                   nullptr, part, ps, G, n_w, P, S, s, cot, c0,
                                                   n_pts)
                      : launch<__nv_bfloat16, 128>(2, net, pts, vd, g, nullptr, acts, dfeat_ray,
                                                   nullptr, part, ps, G, n_w, P, S, s, cot, c0,
                                                   n_pts);
}

// Phase 2 of the split backward: for each of n_entries products (at most 20), from 9 int64
// each (a, b, lda, ldb, m_op, n, m_keep, out, ldo): part[y][out + m ldo + n'] += sum over the
// P points p of a[p][m] b[p][n'] for m < m_keep, n' < n, where a is bfloat16 [P][lda] (its
// columns m < m_op read), b bfloat16 [P][ldb], y the split of the points that took the
// product (n_split of them, each into its own row of part: n_split <= the rows of part).
// lda, ldb, m_op and n are multiples of 8, a and b 16-byte aligned.
extern "C" int fused_nerf_wgrad_launch(const long long* entries, int n_entries, int P,
                                       float* part, long long part_stride, int n_split,
                                       void* stream) {
  if (n_entries < 1 || n_entries > kMaxWgrad || P < 0 || n_split < 1)
    return (int)cudaErrorInvalidValue;
  WgradTable tab;
  tab.n_entries = n_entries;
  int tiles = 0;
  for (int i = 0; i < n_entries; ++i) {
    const long long* q = entries + 9 * i;
    WgradEntry& e = tab.e[i];
    e.a = reinterpret_cast<const __nv_bfloat16*>(q[0]);
    e.b = reinterpret_cast<const __nv_bfloat16*>(q[1]);
    e.lda = (int)q[2]; e.ldb = (int)q[3]; e.m_op = (int)q[4]; e.n = (int)q[5];
    e.m_keep = (int)q[6]; e.out = q[7]; e.ldo = (int)q[8];
    if (e.lda % 8 || e.ldb % 8 || e.m_op % 8 || e.n % 8 || e.m_op > e.lda || e.n > e.ldb ||
        e.m_keep > e.m_op || e.m_keep < 1 || e.n < 1 || e.n > e.ldo || e.out < 0 ||
        e.out + (long long)(e.m_keep - 1) * e.ldo + e.n > part_stride ||
        (q[0] | q[1]) % 16)
      return (int)cudaErrorInvalidValue;
    e.tiles_n = (e.n + kWgN - 1) / kWgN;
    e.tile0 = tiles;
    tiles += ((e.m_keep + kWgM - 1) / kWgM) * e.tiles_n;
  }
  for (int i = n_entries; i < kMaxWgrad; ++i) tab.e[i] = tab.e[0];
  if (P == 0) return 0;
  cudaError_t err = prepare(fused_nerf_wgrad_kernel, kWgSmem);
  if (err != cudaSuccess) return (int)err;
  fused_nerf_wgrad_kernel<<<dim3(tiles, n_split), kThreads, kWgSmem, (cudaStream_t)stream>>>(
      tab, P, part, (size_t)part_stride);
  return (int)cudaGetLastError();
}

// out[i] = sum over b < G of part[b * part_stride + i] for i < n, in the order of b.
extern "C" int fused_nerf_grad_reduce_launch(const float* part, long long part_stride, int G,
                                             int n, float* out, void* stream) {
  if (G < 1 || n < 0) return (int)cudaErrorInvalidValue;
  if (n == 0) return 0;
  fused_nerf_grad_reduce_kernel<<<(n + 255) / 256, 256, 0, (cudaStream_t)stream>>>(
      part, (size_t)part_stride, G, n, out);
  return (int)cudaGetLastError();
}

// The semantic head's backward of kernel 8: head gradients into G rows of `part` (zeroed;
// row b at part + b * part_stride, the [in, out] layout of the fused_nerf_sem_head_bwd_kernel
// note; sum them with fused_nerf_grad_reduce_launch) and dfeat_ray [N, W] in T, for the
// per-ray logit cotangent gsem [N, C] float32 and kernel 7's sem_acts.
extern "C" int fused_nerf_sem_head_bwd_launch(const float* gsem, const void* sem_acts,
                                              const void* ws0t, const void* ws1t,
                                              void* dfeat_ray, float* part,
                                              long long part_stride, int G, int N, int S,
                                              int width, int C, int is_bf16, void* stream) {
  if (N < 0 || S < 1 || C < 1 || C > 256 || G < 1 || (width != 128 && width != 256) ||
      part_stride < (long long)width * (width / 2) + width / 2 + (width / 2) * C + C)
    return (int)cudaErrorInvalidValue;
  if (N == 0) return 0;
  const size_t smem = sizeof(float) * head_bwd_smem_floats(width, C);
  cudaStream_t s = (cudaStream_t)stream;
  cudaError_t e;
#define FNERF_HEAD_BWD(T, W)                                                                 \
  {                                                                                          \
    auto k = fused_nerf_sem_head_bwd_kernel<T, W>;                                           \
    if ((e = prepare(k, smem)) != cudaSuccess) return (int)e;                                \
    k<<<G, kThreads, smem, s>>>(gsem, reinterpret_cast<const T*>(sem_acts),                  \
                                reinterpret_cast<const T*>(ws0t),                            \
                                reinterpret_cast<const T*>(ws1t),                            \
                                reinterpret_cast<T*>(dfeat_ray), part, (size_t)part_stride, N, \
                                S, C);                                                       \
  }
  if (is_bf16 && width == 256) FNERF_HEAD_BWD(__nv_bfloat16, 256)
  else if (is_bf16) FNERF_HEAD_BWD(__nv_bfloat16, 128)
  else if (width == 256) FNERF_HEAD_BWD(float, 256)
  else FNERF_HEAD_BWD(float, 128)
#undef FNERF_HEAD_BWD
  return (int)cudaGetLastError();
}

extern "C" const char* fused_nerf_bwd_error_string(int e) {
  return cudaGetErrorString((cudaError_t)e);
}
