// The v3 packed-lane fused NeRF MLP for Hopper (sm_90a): kernel 12 (forward) and kernel 13
// (recompute backward), for the DS-NeRF sigma loss and the probing API's raw queries.
//
// Kernel 12 replaces the Pallas TPU kernel depth_lidar_nerf_tpu/ops/fused_mlp.py:_fwd_kernel
// (body _forward_tile, entry _fwd_impl); kernel 13 replaces :_bwd_kernel (entry _vjp_bwd).
// Their input is one packed encoding per point, x [P, 128] in T (float or bfloat16): the
// float32 positional encoding of the point in lanes 0..e_p-1, the encoding of its ray's view
// direction in lanes e_p..e_p+e_v-1, zeros after. The weights are JAX's packed list
// (_pack_params), each [in, out] row-major in T, biases float32:
//   h_0   = relu(x W1 + b1)                       W1 [128, W], zero rows past e_p
//   h_i   = relu(h_{i-1} TW_i + tb_i)             i < D <= 4, no skip
//   fs    = h WFS + bfs                           WFS [W, W + 8]: the feature kernel in
//                                                 columns 0..W-1, the sigma kernel in W + 3
//   feat  = fs[:, :W] rounded to T;  sig8 = fs[:, W:W + 8] in float32 (sigma in column 3)
//   hv    = relu([feat | x] WV + bv)              WV [W + 128, W / 2]: the feature rows, then
//                                                 zero rows for the position lanes, the view
//                                                 rows at W + e_p.., zeros
//   out   = (hv WR + br) + sig8                   WR [W / 2, 8], rgb in columns 0-2
// written point-major as out [P, 8] float32 (rgb 0-2, sigma 3, zeros 4-7), as the TPU kernel
// writes its [T, 8] block. Unlike kernel 1 (fused_nerf_fwd.cu), the view layer is one
// product per point over [feat | x], rounded once. The zero rows of W1 and WV add exact
// zeros, so the kernels skip runs of them.
//
// Kernel 13, in JAX's order and with its casts (_bwd_kernel): gb = g rounded to T; d(WR) =
// hv^T gb; d(br) = sum g; dhv = mask(hv > 0, gb WR^T) rounded; d(WV) = [feat | x]^T dhv;
// d(bv) = sum dhv; dfeat = dhv WV[:W]^T rounded; d(WFS) = h^T [dfeat | gb]; d(bfs) =
// [sum dfeat | sum g]; dh = dfeat WFS[:, :W]^T + gb WFS[:, W:]^T; then per trunk layer, last
// to first, dh = mask(h_l > 0, dh) rounded, d(TW_l) = h_{l-1}^T dh, d(tb_l) = sum dh, dh =
// dh TW_l^T; d(W1) = x^T dh. Gradients are float32 in the packed layout; only the entries
// that the unpacking keeps (fused_mlp.py:_unpack_grads) are formed (in bfloat16 also the
// rows of d(WV) of the position lanes that share a 16-lane run with the view lanes, which
// the unpacking drops), the rest stay zero.
//
// Bound on the H100: operations. A point costs ~0.32 M multiply-adds forward at D = 4 /
// W = 256 (the view layer reads its 27 view lanes per point) and ~3x that in the recompute
// backward, against 256 bytes of packed bfloat16 input a point.
//
// Float32 (both kernels on the CUDA cores, FMA): one block of 256 threads takes a tile of
// kTP = 64 points with the register tiling of fused_nerf.cuh (8 points x W/32 columns a
// thread); the packed tile is loaded once, transposed, and only its e_p + e_v live lanes.
// The backward runs one block per SM over the tiles in a fixed stride, keeps the recomputed
// activations of its tile in a per-block scratch (as kernel 2), and adds each tile's
// gradients into the block's own float32 partial; fused_nerf_grad_reduce (fused_nerf_bwd.cu)
// sums the partials in a fixed order, so repeated runs give bit-identical gradients. The TPU
// kernel's grid accumulated into one VMEM buffer in sequence; blocks of a GPU grid run in no
// order, hence the partials.
//
// Bfloat16 (the products on the tensor cores, mma.sync m16n8k16 through fused_nerf.cuh's
// tc_layer, tc_mac and tc_mac_in: each k-step's 16 products summed from zero and added to
// float32 accumulators). Kernel 12 (packed_forward_tc) stages the packed lanes 0 ..
// pad16(e_p + e_v) - 1 of its 64-point tile; the first layer reads the runs of lanes below
// pad16(e_p) (W1's rows past e_p are zero: exact zeros), the trunk as kernel 1's tile, the
// feature and sigma columns as one product over N = W + 8 (the W feature columns on every
// warp, the n8 tile of columns W..W+7 on warp 0), the view layer over [feat | the 16-lane runs
// of x that hold view lanes] (WV's rows of the other lanes in those runs are zero), the rgb
// head as one n8 tile on warp 0, summed (hv WR + br) + sig8 in float32. The B operands come
// from the permuted rows of KernelWeights.weights_p (ops/fused_mlp.py). Kernel 13 is the
// split of kernel 5 (fused_nerf_bwd.cu) over chunks of points: phase 1, the chain
// (fused_nerf_packed_chain_kernel, one block per SM striding the chunk's tiles), recomputes
// kernel 12's tile, writes its bfloat16 activations and cotangents as point-major rows and
// adds only the small gradients (the rgb head, the sigma column, the biases) into the block's
// partial; its input products dfeat, dh and each trunk layer's run on tc_mac_in (dhv's three
// columns and the sigma term on FMA). Phase 2, fused_nerf_wgrad_kernel (fused_nerf_bwd.cu),
// forms every large weight gradient a^T b from those rows and from x itself as one split-K
// GEMM; fused_nerf_grad_reduce sums the partials. No tile adds a large gradient into device
// memory: at D = 4 / W = 256 a block's partial is ~1.4 MB, and 132 of them do not fit in L2.

#include "fused_nerf.cuh"

namespace {

using namespace fnerf;

constexpr int kPack = 128;  // packed lanes a point
constexpr int kOut = 8;     // output columns a point
constexpr int kMaxDepth = 4;

// Offsets (elements) of the packed weights, their transposes, the biases, the gradient
// partial's blocks and (bfloat16) the tensor-core rows; see fused_nerf_packed_fwd_launch for
// the host-side order.
struct PNet {
  const void* w;
  const void* wp;  // the tensor-core rows (bfloat16 only; ops/fused_mlp.py:KernelWeights)
  const float* b;
  int depth, e_p, e_v;
  int w1, tw[kMaxDepth], wfs, wv, wr;     // [in, out] in T
  int twt[kMaxDepth], wfst, wvt, wrt;     // [out, in] in T (backward)
  int b1, tb[kMaxDepth], bfs, bv, br;     // float32
  int g_w1, g_tw[kMaxDepth], g_wfs, g_wv, g_wr;
  int g_b1, g_tb[kMaxDepth], g_bfs, g_bv, g_br;
  // in wp: the forward's B rows [out][K] (tc_mac) of W1 (K = pad16(e_p)), TW_i, WFS (W + 8
  // rows), WV (K = W + the view runs' lanes) and WR (8 rows); the backward's input-product
  // rows [in][out] (tc_mac_in) of TW_i, WFS[:, :W] and WV[:W]
  int p_w1, p_tw[kMaxDepth], p_wfs, p_wv, p_wr;
  int i_tw[kMaxDepth], i_wfs, i_wv;
};

PNet make_pnet(const void* w, const void* wp, const float* b, const int* o, int depth, int e_p,
               int e_v) {
  PNet n;
  n.w = w; n.wp = wp; n.b = b; n.depth = depth; n.e_p = e_p; n.e_v = e_v;
  n.w1 = o[0];
  for (int i = 0; i < kMaxDepth - 1; ++i) n.tw[i] = o[1 + i];
  n.wfs = o[4]; n.wv = o[5]; n.wr = o[6];
  for (int i = 0; i < kMaxDepth - 1; ++i) n.twt[i] = o[7 + i];
  n.wfst = o[10]; n.wvt = o[11]; n.wrt = o[12];
  n.b1 = o[13];
  for (int i = 0; i < kMaxDepth - 1; ++i) n.tb[i] = o[14 + i];
  n.bfs = o[17]; n.bv = o[18]; n.br = o[19];
  n.g_w1 = o[20];
  for (int i = 0; i < kMaxDepth - 1; ++i) n.g_tw[i] = o[21 + i];
  n.g_wfs = o[24]; n.g_wv = o[25]; n.g_wr = o[26];
  n.g_b1 = o[27];
  for (int i = 0; i < kMaxDepth - 1; ++i) n.g_tb[i] = o[28 + i];
  n.g_bfs = o[31]; n.g_bv = o[32]; n.g_br = o[33];
  n.p_w1 = o[34];
  for (int i = 0; i < kMaxDepth - 1; ++i) n.p_tw[i] = o[35 + i];
  n.p_wfs = o[38]; n.p_wv = o[39]; n.p_wr = o[40];
  for (int i = 0; i < kMaxDepth - 1; ++i) n.i_tw[i] = o[41 + i];
  n.i_wfs = o[44]; n.i_wv = o[45];
  return n;
}

// Shared memory of one float32 tile, in floats: two [W][kLD] activation buffers, the live
// lanes of the packed tile [e_p + e_v][kLD] and, for the backward, the rounded cotangent
// [4][kLD].
__host__ __device__ inline size_t packed_smem_floats(int W, int e_p, int e_v) {
  return (size_t)(2 * W + e_p + e_v + 4) * kLD;
}

// The bfloat16 tile's: two [W][kLD] activation buffers, the packed lanes 0 .. pad16(e_p + e_v)
// - 1 [..][kLD] and, for the chain, the rounded cotangent [4][kLD].
__host__ __device__ inline size_t packed_tc_smem_floats(int W, int e_p, int e_v) {
  return (size_t)(2 * W + pad16(e_p + e_v) + 4) * kLD;
}

// The 16-lane runs of the packed input that the bfloat16 view layer reads: from the run that
// holds lane e_p (the first view lane) up to pad16(e_p + e_v). WV's rows of the position lanes
// in the first run are zero, so the product is exact whichever runs hold only zero rows.
__host__ __device__ inline int view_run0(int e_p) { return e_p / 16 * 16; }

// One tile of kernel 12's forward on FMA (float32): out (may be null) [P, 8]; with `acts`,
// each trunk activation, the feature activation and the view activation of the tile's valid
// points in T, layer l (l <= D) at acts + l * lstride as [kTP][W], the view activation at
// acts + (D + 1) * lstride as [kTP][W / 2]. Leaves the tile's x lanes in xs.
template <typename T, int W>
__device__ void packed_forward_tile(const PNet& n, float* __restrict__ buf0,
                                    float* __restrict__ buf1, float* __restrict__ xs,
                                    const T* __restrict__ x, int P, int p0,
                                    float* __restrict__ out, T* __restrict__ acts,
                                    size_t lstride) {
  constexpr int NJ = W / 32, NJV = W / 64, WV = W / 2;
  const int tid = threadIdx.x, ty = tid >> 5, tx = tid & 31;
  const int n_valid = min(kTP, P - p0);
  const int C = n.e_p + n.e_v, D = n.depth;
  const T* w = reinterpret_cast<const T*>(n.w);
  const float* b = n.b;

  for (int idx = tid; idx < kTP * C; idx += kThreads) {
    const int p = idx / C, c = idx % C;
    xs[c * kLD + p] = p < n_valid ? to_f<T>(x[(size_t)(p0 + p) * kPack + c]) : 0.f;
  }
  __syncthreads();

  float acc[8][NJ];
  const float* h = xs;
  for (int l = 0; l < D; ++l) {
    float* dst = (l & 1) ? buf1 : buf0;
    init_acc<NJ>(acc, b + (l == 0 ? n.b1 : n.tb[l - 1]), tx);
    if (l == 0) mac<T, NJ>(acc, xs, n.e_p, w + n.w1, W, ty, tx);
    else mac<T, NJ>(acc, h, W, w + n.tw[l - 1], W, ty, tx);
    store<T, NJ>(acc, dst, true, ty, tx, acts ? acts + l * lstride : nullptr, W, n_valid);
    __syncthreads();
    h = dst;
  }
  float* feat = (h == buf0) ? buf1 : buf0;
  float* hv = (h == buf0) ? buf0 : buf1;

  // Sigma: column W + 3 of the feature+sigma product, float32, one thread a point.
  if (out && tid < n_valid) {
    const T* ws = w + n.wfs + W + 3;
    float sg = b[n.bfs + W + 3];
    for (int k = 0; k < W; ++k)
      sg = fmaf(h[k * kLD + tid], to_f<T>(ws[(size_t)k * (W + kOut)]), sg);
    float* row = out + (size_t)(p0 + tid) * kOut;
    row[3] = sg;
    row[4] = row[5] = row[6] = row[7] = 0.f;
  }
  init_acc<NJ>(acc, b + n.bfs, tx);
  mac<T, NJ>(acc, h, W, w + n.wfs, W + kOut, ty, tx);
  store<T, NJ>(acc, feat, false, ty, tx, acts ? acts + D * lstride : nullptr, W, n_valid);
  __syncthreads();

  // View layer over [feat | x]: the feature rows, then the view lanes' rows (the position
  // lanes' rows are zero).
  {
    float accv[8][NJV];
    init_acc<NJV>(accv, b + n.bv, tx);
    mac<T, NJV>(accv, feat, W, w + n.wv, WV, ty, tx);
    mac<T, NJV>(accv, xs + n.e_p * kLD, n.e_v, w + n.wv + (size_t)(W + n.e_p) * WV, WV, ty, tx);
    store<T, NJV>(accv, hv, true, ty, tx, acts ? acts + (D + 1) * lstride : nullptr, WV,
                  n_valid);
  }
  __syncthreads();

  if (out) {
    const T* wr = w + n.wr;
    for (int idx = tid; idx < 3 * kTP; idx += kThreads) {
      const int c = idx / kTP, p = idx % kTP;
      if (p >= n_valid) continue;
      float sm = b[n.br + c];
      for (int k = 0; k < WV; ++k) sm = fmaf(hv[k * kLD + p], to_f<T>(wr[k * kOut + c]), sm);
      out[(size_t)(p0 + p) * kOut + c] = sm;
    }
  }
}

// One tile of kernel 12 in bfloat16 on the tensor cores (see the source note): out (may be
// null) [P, 8]; with `acts`, the activations of the tile's valid points as [point][C] rows in
// bfloat16, layer l (l <= D: h_0 .. h_{D-1}, feat) at acts + l * lstride + (row0 + r) W; with
// `hvo`, hv at hvo + (row0 + r) W / 2. Leaves the packed lanes in xs, feat in one activation
// buffer and hv in the other, which it returns.
template <int W>
__device__ float* packed_forward_tc(const PNet& n, float* __restrict__ buf0,
                                    float* __restrict__ buf1, float* __restrict__ xs,
                                    const __nv_bfloat16* __restrict__ x, int P, int p0,
                                    float* __restrict__ out, __nv_bfloat16* __restrict__ acts,
                                    __nv_bfloat16* __restrict__ hvo, size_t lstride,
                                    size_t row0) {
  constexpr int WV = W / 2;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int n_valid = min(kTP, P - p0);
  const int D = n.depth;
  const int ep16 = pad16(n.e_p), v0 = view_run0(n.e_p), v1 = pad16(n.e_p + n.e_v);
  const __nv_bfloat16* wp = reinterpret_cast<const __nv_bfloat16*>(n.wp);
  const float* b = n.b;
  __nv_bfloat16* arow = acts ? acts + row0 * W : nullptr;

  for (int idx = tid; idx < kTP * v1; idx += kThreads) {
    const int p = idx / v1, c = idx % v1;
    xs[c * kLD + p] = p < n_valid ? __bfloat162float(x[(size_t)(p0 + p) * kPack + c]) : 0.f;
  }
  __syncthreads();

  const float* h = xs;
  for (int l = 0; l < D; ++l) {
    float* dst = (l & 1) ? buf1 : buf0;
    tc_layer<W / 64>(b + (l == 0 ? n.b1 : n.tb[l - 1]), h, l == 0 ? ep16 : W, nullptr, 0,
                     wp + (l == 0 ? n.p_w1 : n.p_tw[l - 1]), dst, true,
                     arow ? arow + l * lstride : nullptr, n_valid);
    __syncthreads();
    h = dst;
  }
  float* feat = (h == buf0) ? buf1 : buf0;
  float* hv = (h == buf0) ? buf0 : buf1;

  // Feature and sigma columns: columns 0..W-1 rounded into feat; warp 0 also forms the n8
  // tile of columns W..W+7 (sig8, float32, kept in its registers for the rgb head).
  tc_layer<W / 64>(b + n.bfs, h, W, nullptr, 0, wp + n.p_wfs, feat, false,
                   arow ? arow + D * lstride : nullptr, n_valid);
  float s8[kMT][1][4];
  const int gq = lane >> 2, t = lane & 3;
  if (out && warp == 0) {
#pragma unroll
    for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
      for (int i = 0; i < 4; ++i) s8[mt][0][i] = 0.f;
    tc_mac<1>(s8, h, W, wp + n.p_wfs, W, W, lane);
    const float bs0 = b[n.bfs + W + 2 * t], bs1 = b[n.bfs + W + 2 * t + 1];
#pragma unroll
    for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
      for (int h2 = 0; h2 < 2; ++h2) {
        s8[mt][0][2 * h2] += bs0;
        s8[mt][0][2 * h2 + 1] += bs1;
      }
  }
  __syncthreads();

  // View layer over [feat | the view runs of x], into the last trunk activation's buffer.
  tc_layer<W / 128>(b + n.bv, feat, W, xs + v0 * kLD, v1 - v0, wp + n.p_wv, hv, true,
                    hvo ? hvo + row0 * WV : nullptr, n_valid);
  __syncthreads();

  // rgb head: one n8 tile on warp 0, (hv WR + br) + sig8 in float32, all 8 columns.
  if (out && warp == 0) {
    float r[kMT][1][4];
#pragma unroll
    for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
      for (int i = 0; i < 4; ++i) r[mt][0][i] = 0.f;
    tc_mac<1>(r, hv, WV, wp + n.p_wr, WV, 0, lane);
    const float br0 = b[n.br + 2 * t], br1 = b[n.br + 2 * t + 1];
#pragma unroll
    for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
      for (int h2 = 0; h2 < 2; ++h2) {
        const int p = 16 * mt + gq + 8 * h2;
        if (p < n_valid)
          *reinterpret_cast<float2*>(out + (size_t)(p0 + p) * kOut + 2 * t) =
              make_float2((r[mt][0][2 * h2] + br0) + s8[mt][0][2 * h2],
                          (r[mt][0][2 * h2 + 1] + br1) + s8[mt][0][2 * h2 + 1]);
      }
  }
  return hv;
}

template <typename T, int W>
__global__ void __launch_bounds__(kThreads, 1)
    fused_nerf_packed_fwd_kernel(const PNet n, const T* __restrict__ x, float* __restrict__ out,
                                 int P) {
  extern __shared__ __align__(16) float smem[];
  float* buf0 = smem;
  float* buf1 = buf0 + W * kLD;
  float* xs = buf1 + W * kLD;
  if constexpr (std::is_same<T, __nv_bfloat16>::value)
    packed_forward_tc<W>(n, buf0, buf1, xs, x, P, blockIdx.x * kTP, out, nullptr, nullptr, 0,
                         0);
  else
    packed_forward_tile<T, W>(n, buf0, buf1, xs, x, P, blockIdx.x * kTP, out, nullptr, 0);
}

// The float32 backward of one tile (see the source note), from the activations that
// packed_forward_tile wrote to `acts` and the x lanes it left in xs; adds into the block's
// partial gw.
template <typename T, int W>
__device__ void packed_backward_tile(const PNet& n, float* __restrict__ A, float* __restrict__ Dg,
                                     const float* __restrict__ xs, float* __restrict__ gb,
                                     const float* __restrict__ g, int P, int p0,
                                     const T* __restrict__ acts, size_t lstride,
                                     float* __restrict__ gw) {
  constexpr int NJ = W / 32, NJV = W / 64, WV = W / 2;
  const int tid = threadIdx.x, ty = tid >> 5, tx = tid & 31;
  const int n_valid = min(kTP, P - p0);
  const int D = n.depth, e_p = n.e_p, e_v = n.e_v;
  const T* w = reinterpret_cast<const T*>(n.w);

  // Cotangent columns 0-3 rounded (columns 4-7 meet zero weights); the rgb and sigma bias
  // gradients sum the float32 cotangent.
  for (int idx = tid; idx < 4 * kTP; idx += kThreads) {
    const int c = idx / kTP, p = idx % kTP;
    gb[c * kLD + p] = p < n_valid ? rnd<T>(g[(size_t)(p0 + p) * kOut + c]) : 0.f;
  }
  if (tid < 4) {
    float sm = 0.f;
    for (int p = 0; p < n_valid; ++p) sm += g[(size_t)(p0 + p) * kOut + tid];
    gw[tid < 3 ? n.g_br + tid : n.g_bfs + W + 3] += sm;
  }
  load_rows<T>(A, acts + (D + 1) * lstride, WV, n_valid);  // hv
  __syncthreads();

  // rgb head: d(WR)[k][c] = sum_p hv[k][p] gb[c][p]; dhv = mask(hv, gb WR^T).
  for (int idx = tid; idx < WV * 3; idx += kThreads) {
    const int k = idx / 3, c = idx % 3;
    float sm = 0.f;
    for (int p = 0; p < kTP; ++p) sm = fmaf(A[k * kLD + p], gb[c * kLD + p], sm);
    gw[n.g_wr + k * kOut + c] += sm;
  }
  {
    float accv[8][NJV];
    init_acc<NJV>(accv, nullptr, tx);
    mac<T, NJV>(accv, gb, 3, w + n.wrt, WV, ty, tx);
    store_masked<T, NJV>(accv, A, Dg, ty, tx);  // dhv [WV][kLD]
  }
  __syncthreads();

  // View layer: d(WV) rows of feat and of the view lanes, d(bv), then dfeat.
  load_rows<T>(A, acts + D * lstride, W, n_valid);  // feat
  __syncthreads();
  outer(gw + n.g_wv, A, W, Dg, WV, ty, tx);
  outer(gw + n.g_wv + (size_t)(W + e_p) * WV, xs + e_p * kLD, e_v, Dg, WV, ty, tx);
  bias_sum(gw + n.g_bv, Dg, WV);
  float acc[8][NJ];
  init_acc<NJ>(acc, nullptr, tx);
  mac<T, NJ>(acc, Dg, WV, w + n.wvt, W + kPack, ty, tx);
  __syncthreads();
  store_masked<T, NJ>(acc, nullptr, Dg, ty, tx);          // dfeat [W][kLD]
  load_rows<T>(A, acts + (D - 1) * lstride, W, n_valid);  // h_{D-1}
  __syncthreads();

  // Feature and sigma columns: d(WFS), d(bfs); dh.
  outer(gw + n.g_wfs, A, W, Dg, W, ty, tx, W + kOut);
  bias_sum(gw + n.g_bfs, Dg, W);
  for (int k = tid; k < W; k += kThreads) {
    float sm = 0.f;
    for (int p = 0; p < kTP; ++p) sm = fmaf(A[k * kLD + p], gb[3 * kLD + p], sm);
    gw[n.g_wfs + k * (W + kOut) + W + 3] += sm;
  }
  init_acc<NJ>(acc, nullptr, tx);
  mac<T, NJ>(acc, Dg, W, w + n.wfst, W, ty, tx);
  {
    const T* wsig = w + n.wfst + (size_t)(W + 3) * W;
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const float ws = to_f<T>(wsig[tx + 32 * j]);
#pragma unroll
      for (int i = 0; i < 8; ++i) acc[i][j] = fmaf(gb[3 * kLD + ty * 8 + i], ws, acc[i][j]);
    }
  }
  __syncthreads();

  // Trunk, last layer to first; A holds h_l when layer l starts.
  for (int l = D - 1; l >= 0; --l) {
    store_masked<T, NJ>(acc, A, Dg, ty, tx);  // dh_l
    __syncthreads();
    if (l == 0) {
      outer(gw + n.g_w1, xs, e_p, Dg, W, ty, tx);
      bias_sum(gw + n.g_b1, Dg, W);
      break;
    }
    load_rows<T>(A, acts + (l - 1) * lstride, W, n_valid);  // h_{l-1}
    __syncthreads();
    outer(gw + n.g_tw[l - 1], A, W, Dg, W, ty, tx);
    bias_sum(gw + n.g_tb[l - 1], Dg, W);
    init_acc<NJ>(acc, nullptr, tx);
    mac<T, NJ>(acc, Dg, W, w + n.twt[l - 1], W, ty, tx);
    __syncthreads();
  }
  __syncthreads();
}

template <typename T, int W>
__global__ void __launch_bounds__(kThreads, 1)
    fused_nerf_packed_bwd_kernel(const PNet n, const T* __restrict__ x,
                                 const float* __restrict__ g, T* __restrict__ scratch,
                                 float* __restrict__ part, size_t part_stride, int P) {
  extern __shared__ __align__(16) float smem[];
  float* buf0 = smem;
  float* buf1 = buf0 + W * kLD;
  float* xs = buf1 + W * kLD;
  float* gb = xs + (n.e_p + n.e_v) * kLD;
  const int n_tiles = (P + kTP - 1) / kTP;
  const size_t lstride = (size_t)kTP * W;
  T* mine = scratch + blockIdx.x * ((n.depth + 1) * lstride + kTP * (W / 2));
  float* gw = part + blockIdx.x * part_stride;
  for (int t = blockIdx.x; t < n_tiles; t += gridDim.x) {
    packed_forward_tile<T, W>(n, buf0, buf1, xs, x, P, t * kTP, nullptr, mine, lstride);
    __syncthreads();
    packed_backward_tile<T, W>(n, buf0, buf1, xs, gb, g, P, t * kTP, mine, lstride, gw);
  }
}

// Phase 1 of kernel 13 in bfloat16 for one tile (see the source note), after
// packed_forward_tc: A holds hv and Dg feat on entry (both [..][kLD]); the tile's activations
// are at acts (rows row0.., layer stride ls). Writes the rounded cotangents dh_0 .. dh_{D-1},
// dfeat ([point][W] each, layers 0..D) and dhv ([point][W / 2], layer D + 1) to cot in the
// same layout, and adds the small gradients into the block's partial gw.
template <int W>
__device__ void packed_chain_tile(const PNet& n, float* __restrict__ A, float* __restrict__ Dg,
                                  float* __restrict__ gb, const float* __restrict__ g, int P,
                                  int p0, const __nv_bfloat16* __restrict__ acts,
                                  __nv_bfloat16* __restrict__ cot, size_t ls, size_t row0,
                                  float* __restrict__ gw) {
  using bf16 = __nv_bfloat16;
  constexpr int NT = W / 64, NJV = W / 64, WV = W / 2;
  const int tid = threadIdx.x, ty = tid >> 5, tx = tid & 31;
  const int n_valid = min(kTP, P - p0);
  const int D = n.depth, n0 = ty * (W / 8);
  const bf16* w = reinterpret_cast<const bf16*>(n.w);
  const bf16* wi = reinterpret_cast<const bf16*>(n.wp);
  const bf16* arow = acts + row0 * W;
  bf16* crow = cot + row0 * W;

  // Cotangent columns 0-3 rounded (columns 4-7 meet zero weights); the rgb and sigma bias
  // gradients sum the float32 cotangent.
  for (int idx = tid; idx < 4 * kTP; idx += kThreads) {
    const int c = idx / kTP, p = idx % kTP;
    gb[c * kLD + p] = p < n_valid ? rnd<bf16>(g[(size_t)(p0 + p) * kOut + c]) : 0.f;
  }
  if (tid < 4) {
    float sm = 0.f;
    for (int p = 0; p < n_valid; ++p) sm += g[(size_t)(p0 + p) * kOut + tid];
    gw[tid < 3 ? n.g_br + tid : n.g_bfs + W + 3] += sm;
  }
  __syncthreads();

  // rgb head (K = 3, on FMA): d(WR) = hv^T gb; dhv = mask(hv, gb WR^T) into Dg.
  for (int idx = tid; idx < WV * 3; idx += kThreads) {
    const int k = idx / 3, c = idx % 3;
    float sm = 0.f;
    for (int p = 0; p < kTP; ++p) sm = fmaf(A[k * kLD + p], gb[c * kLD + p], sm);
    gw[n.g_wr + k * kOut + c] += sm;
  }
  {
    float accv[8][NJV];
    init_acc<NJV>(accv, nullptr, tx);
    mac<bf16, NJV>(accv, gb, 3, w + n.wrt, WV, ty, tx);
    store_masked<bf16, NJV>(accv, A, Dg, ty, tx);
  }
  __syncthreads();
  write_rows(cot + (D + 1) * ls + row0 * WV, Dg, WV, n_valid);
  bias_sum(gw + n.g_bv, Dg, WV);

  // dfeat = dhv WV[:W]^T on the tensor cores, rounded.
  float acc[kMT][NT][4];
#pragma unroll
  for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[mt][nt][i] = 0.f;
  tc_mac_in<NT>(acc, Dg, WV, wi + n.i_wv, WV, n0, tx);
  __syncthreads();
  tc_store_masked<NT, W>(acc, nullptr, Dg, crow + D * ls, n_valid, n0, tx);
  load_rows<bf16>(A, arow + (D - 1) * ls, W, n_valid);  // h_{D-1}
  __syncthreads();

  // d(bfs)[:W], the sigma column of d(WFS); dh = dfeat WFS[:, :W]^T (tensor cores) + gb[3]
  // WFS[:, W + 3]^T (FMA, exact products added in float32).
  bias_sum(gw + n.g_bfs, Dg, W);
  for (int k = tid; k < W; k += kThreads) {
    float sm = 0.f;
    for (int p = 0; p < kTP; ++p) sm = fmaf(A[k * kLD + p], gb[3 * kLD + p], sm);
    gw[n.g_wfs + k * (W + kOut) + W + 3] += sm;
  }
#pragma unroll
  for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[mt][nt][i] = 0.f;
  tc_mac_in<NT>(acc, Dg, W, wi + n.i_wfs, W, n0, tx);
  {
    const bf16* wsig = w + n.wfst + (size_t)(W + 3) * W;
    const int gq = tx >> 2, c0 = n0 + 2 * (tx & 3);
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      const float ws0 = to_f<bf16>(wsig[c0 + 8 * nt]), ws1 = to_f<bf16>(wsig[c0 + 8 * nt + 1]);
#pragma unroll
      for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const float gs = gb[3 * kLD + 16 * mt + gq + 8 * h];
          acc[mt][nt][2 * h] = fmaf(gs, ws0, acc[mt][nt][2 * h]);
          acc[mt][nt][2 * h + 1] = fmaf(gs, ws1, acc[mt][nt][2 * h + 1]);
        }
    }
  }
  __syncthreads();

  // Trunk, last layer to first; A holds h_l when layer l starts.
  for (int l = D - 1; l >= 0; --l) {
    tc_store_masked<NT, W>(acc, A, Dg, crow + l * ls, n_valid, n0, tx);  // dh_l
    __syncthreads();
    bias_sum(gw + (l == 0 ? n.g_b1 : n.g_tb[l - 1]), Dg, W);
    if (l == 0) break;
    load_rows<bf16>(A, arow + (l - 1) * ls, W, n_valid);  // h_{l-1}
    __syncthreads();
#pragma unroll
    for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[mt][nt][i] = 0.f;
    tc_mac_in<NT>(acc, Dg, W, wi + n.i_tw[l - 1], W, n0, tx);
    __syncthreads();
  }
  __syncthreads();
}

// Phase 1 of kernel 13 in bfloat16 over the points [c0, c0 + count) (c0 a multiple of kTP):
// block b takes the chunk's tiles b, b + G, ...; the activations (D + 1 layers) and the
// cotangents (D + 1 layers, then dhv; fused_mlp_t.split_acts' layout) of the chunk go to acts
// and cot (count rows a layer), hv to hvo if it is not null, the small gradients into row b
// of part.
template <int W>
__global__ void __launch_bounds__(kThreads, 1)
    fused_nerf_packed_chain_kernel(const PNet n, const __nv_bfloat16* __restrict__ x,
                                   const float* __restrict__ g, __nv_bfloat16* __restrict__ acts,
                                   __nv_bfloat16* __restrict__ cot, __nv_bfloat16* __restrict__ hvo,
                                   float* __restrict__ part, size_t part_stride, int c0,
                                   int count) {
  extern __shared__ __align__(16) float smem[];
  float* buf0 = smem;
  float* buf1 = buf0 + W * kLD;
  float* xs = buf1 + W * kLD;
  float* gb = xs + pad16(n.e_p + n.e_v) * kLD;
  const int n_tiles = (count + kTP - 1) / kTP;
  const size_t ls = (size_t)count * W;
  float* gw = part + blockIdx.x * part_stride;
  for (int t = blockIdx.x; t < n_tiles; t += gridDim.x) {
    const int p0 = c0 + t * kTP;
    float* hv = packed_forward_tc<W>(n, buf0, buf1, xs, x, c0 + count, p0, nullptr, acts, hvo,
                                     ls, (size_t)t * kTP);
    packed_chain_tile<W>(n, hv, hv == buf0 ? buf1 : buf0, gb, g, c0 + count, p0, acts, cot, ls,
                         (size_t)t * kTP, gw);
  }
}

template <typename K>
cudaError_t prepare(K kernel, size_t smem) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

template <typename T, int W>
int launch_fwd(const PNet& n, const void* x, float* out, int P, cudaStream_t stream) {
  const size_t smem = sizeof(float) * (std::is_same<T, __nv_bfloat16>::value
                                           ? packed_tc_smem_floats(W, n.e_p, n.e_v)
                                           : packed_smem_floats(W, n.e_p, n.e_v));
  auto k = fused_nerf_packed_fwd_kernel<T, W>;
  cudaError_t e;
  if ((e = prepare(k, smem)) != cudaSuccess) return (int)e;
  k<<<(P + kTP - 1) / kTP, kThreads, smem, stream>>>(n, reinterpret_cast<const T*>(x), out, P);
  return (int)cudaGetLastError();
}

template <int W>
int launch_bwd(const PNet& n, const void* x, const float* g, void* scratch, float* part,
               size_t part_stride, int G, int P, cudaStream_t stream) {
  const size_t smem = sizeof(float) * packed_smem_floats(W, n.e_p, n.e_v);
  auto k = fused_nerf_packed_bwd_kernel<float, W>;
  cudaError_t e;
  if ((e = prepare(k, smem)) != cudaSuccess) return (int)e;
  k<<<G, kThreads, smem, stream>>>(n, reinterpret_cast<const float*>(x), g,
                                   reinterpret_cast<float*>(scratch), part, part_stride, P);
  return (int)cudaGetLastError();
}

template <int W>
int launch_chain(const PNet& n, const void* x, const float* g, void* acts, void* cot, void* hvo,
                 float* part, size_t part_stride, int G, int c0, int count,
                 cudaStream_t stream) {
  using bf16 = __nv_bfloat16;
  const size_t smem = sizeof(float) * packed_tc_smem_floats(W, n.e_p, n.e_v);
  auto k = fused_nerf_packed_chain_kernel<W>;
  cudaError_t e;
  if ((e = prepare(k, smem)) != cudaSuccess) return (int)e;
  k<<<G, kThreads, smem, stream>>>(n, reinterpret_cast<const bf16*>(x), g,
                                   reinterpret_cast<bf16*>(acts), reinterpret_cast<bf16*>(cot),
                                   reinterpret_cast<bf16*>(hvo), part, part_stride, c0, count);
  return (int)cudaGetLastError();
}

bool bad_shape(int P, int depth, int width, int e_p, int e_v) {
  return depth < 1 || depth > kMaxDepth || P < 0 || (width != 128 && width != 256) ||
         e_p < 3 || e_v < 3 || e_p + e_v > kPack;
}

}  // namespace

// Kernel 12. Returns a cudaError_t (0 on success).
//   x    the packed encoding [P, 128] in T (bfloat16 if is_bf16, else float);
//   w    one buffer of T: W1, TW_1..TW_{D-1}, WFS, WV, WR ([in, out], the TPU kernel's packed
//        layout) and their transposes ([out, in]);
//   wp   bfloat16 only (may be null in float32): the tensor-core rows of
//        ops/fused_mlp.py:KernelWeights.weights_p;
//   b    one float32 buffer of the biases b1, tb_1.., bfs, bv, br;
//   off  46 host ints: element offsets in w of W1, TW_1..TW_3, WFS, WV, WR (7), of the
//        transposes TW_1^T..TW_3^T, WFS^T, WV^T, WR^T (6); in b of b1, tb_1..tb_3, bfs, bv,
//        br (7); in a gradient row of d(W1), d(TW_1..3), d(WFS), d(WV), d(WR), d(b1),
//        d(tb_1..3), d(bfs), d(bv), d(br) (14); in wp of the forward rows of W1, TW_1..3,
//        WFS, WV, WR (7) and of the input-product rows of TW_1..3, WFS, WV (5); entries of
//        layers past the depth unused;
//   out  [P, 8] float32.
extern "C" int fused_nerf_packed_fwd_launch(const void* x, const void* w, const void* wp,
                                            const float* b, const int* off, float* out, int P,
                                            int depth, int width, int e_p, int e_v,
                                            int is_bf16, void* stream) {
  if (bad_shape(P, depth, width, e_p, e_v) || out == nullptr || (is_bf16 && wp == nullptr))
    return (int)cudaErrorInvalidValue;
  if (P == 0) return 0;
  const PNet n = make_pnet(w, wp, b, off, depth, e_p, e_v);
  cudaStream_t s = (cudaStream_t)stream;
  if (is_bf16)
    return width == 256 ? launch_fwd<__nv_bfloat16, 256>(n, x, out, P, s)
                        : launch_fwd<__nv_bfloat16, 128>(n, x, out, P, s);
  return width == 256 ? launch_fwd<float, 256>(n, x, out, P, s)
                      : launch_fwd<float, 128>(n, x, out, P, s);
}

// Kernel 13 in float32: gradients of the packed weights for the cotangent g [P, 8] float32 of
// kernel 12's output, into G rows of `part` (zeroed, row b at part + b * part_stride, the
// offsets of `off`; sum them with fused_nerf_grad_reduce_launch). x [P, 128] float; scratch
// holds G x ((D + 1) 64 W + 64 W / 2) floats. In bfloat16 kernel 13 is
// fused_nerf_packed_chain_launch, then fused_nerf_wgrad_launch, a chunk at a time.
extern "C" int fused_nerf_packed_bwd_launch(const void* x, const float* g, const void* w,
                                            const float* b, const int* off, void* scratch,
                                            float* part, long long part_stride, int G, int P,
                                            int depth, int width, int e_p, int e_v,
                                            void* stream) {
  if (bad_shape(P, depth, width, e_p, e_v) || g == nullptr || part == nullptr || G < 1 ||
      part_stride % 4 || scratch == nullptr)
    return (int)cudaErrorInvalidValue;
  if (P == 0) return 0;
  const PNet n = make_pnet(w, nullptr, b, off, depth, e_p, e_v);
  cudaStream_t s = (cudaStream_t)stream;
  const size_t ps = (size_t)part_stride;
  return width == 256 ? launch_bwd<256>(n, x, g, scratch, part, ps, G, P, s)
                      : launch_bwd<128>(n, x, g, scratch, part, ps, G, P, s);
}

// Phase 1 of kernel 13 in bfloat16 over the points [c0, c0 + count) of x [P, 128] and g
// [P, 8] (c0 a multiple of 64): adds the small gradients (rgb head, the sigma column, every
// bias) into G rows of `part` (as fused_nerf_packed_bwd_launch) and writes, count rows a layer
// in bfloat16, the activations h_0 .. h_{D-1}, feat ([count][W] each) to acts, the cotangents
// dh_0 .. dh_{D-1}, dfeat ([count][W] each) and dhv ([count][W / 2]) to cot and, if hvo is
// not null, hv ([count][W / 2]; read by no phase, for checks) to hvo; the weight gradients
// of the products are fused_nerf_wgrad_launch's. w, wp, b, off as for kernel 12.
extern "C" int fused_nerf_packed_chain_launch(const void* x, const float* g, const void* w,
                                              const void* wp, const float* b, const int* off,
                                              void* acts, void* cot, void* hvo, float* part,
                                              long long part_stride, int G, int c0, int count,
                                              int P, int depth, int width, int e_p, int e_v,
                                              void* stream) {
  if (bad_shape(P, depth, width, e_p, e_v) || g == nullptr || part == nullptr ||
      wp == nullptr || acts == nullptr || cot == nullptr || G < 1 || part_stride % 4 ||
      c0 < 0 || c0 % kTP != 0 || count < 0 || c0 + count > P)
    return (int)cudaErrorInvalidValue;
  if (count == 0) return 0;
  const PNet n = make_pnet(w, wp, b, off, depth, e_p, e_v);
  cudaStream_t s = (cudaStream_t)stream;
  const size_t ps = (size_t)part_stride;
  return width == 256 ? launch_chain<256>(n, x, g, acts, cot, hvo, part, ps, G, c0, count, s)
                      : launch_chain<128>(n, x, g, acts, cot, hvo, part, ps, G, c0, count, s);
}

extern "C" const char* fused_nerf_packed_error_string(int e) {
  return cudaGetErrorString((cudaError_t)e);
}
