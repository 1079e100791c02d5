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
//   feat  = fs[:, :W] rounded to T;  sigma = fs[:, W + 3] in float32
//   hv    = relu([feat | x] WV + bv)              WV [W + 128, W / 2]: the feature rows, then
//                                                 zero rows for the position lanes, the view
//                                                 rows at W + e_p.., zeros
//   out   = hv WR + br + fs[:, W:W + 8]           WR [W / 2, 8], rgb in columns 0-2
// written point-major as out [P, 8] float32 (rgb 0-2, sigma 3, zeros 4-7), as the TPU kernel
// writes its [T, 8] block. Unlike kernel 1 (fused_nerf_fwd.cu), the view layer is one
// product per point over [feat | x], rounded once; the zero rows of W1 and WV add exact
// zeros, so the kernels skip them.
//
// Kernel 13, per tile, in JAX's order and with its casts (_bwd_kernel): gb = g rounded to T;
// d(WR) = hv^T gb; d(br) = sum g; dhv = mask(hv > 0, gb WR^T) rounded; d(WV) = [feat | x]^T
// dhv; d(bv) = sum dhv; dfeat = dhv WV[:W]^T rounded; d(WFS) = h^T [dfeat | gb]; d(bfs) =
// [sum dfeat | sum g]; dh = dfeat WFS[:, :W]^T + gb WFS[:, W:]^T; then per trunk layer, last
// to first, dh = mask(h_l > 0, dh) rounded, d(TW_l) = h_{l-1}^T dh, d(tb_l) = sum dh, dh =
// dh TW_l^T; d(W1) = x^T dh. Gradients are float32 in the packed layout; only the entries
// that the unpacking keeps (fused_mlp.py:_unpack_grads) are formed, the rest stay zero.
//
// Bound on the H100: operations. A point costs ~0.32 M multiply-adds forward at D = 4 /
// W = 256 (the view layer reads its 27 view lanes per point) and ~3x that in the recompute
// backward, against 256 bytes of packed bfloat16 input a point. This first version runs the
// products on the CUDA cores (FMA), not the tensor cores, so it reaches neither bound.
// What it does about the bound: every activation of the forward stays in shared memory; one
// block of 256 threads takes a tile of kTP = 64 points with the register tiling of
// fused_nerf.cuh (8 points x W/32 columns a thread); the packed tile is loaded once,
// transposed, and only its e_p + e_v live lanes. The backward runs one block per SM over the
// tiles in a fixed stride, keeps the recomputed activations of its tile in a per-block
// scratch (as kernel 2), and adds each tile's gradients into the block's own float32
// partial; fused_nerf_grad_reduce (fused_nerf_bwd.cu) sums the partials in a fixed order,
// so repeated runs give bit-identical gradients. The TPU kernel's grid accumulated into one
// VMEM buffer in sequence; blocks of a GPU grid run in no order, hence the partials.

#include "fused_nerf.cuh"

namespace {

using namespace fnerf;

constexpr int kPack = 128;  // packed lanes a point
constexpr int kOut = 8;     // output columns a point
constexpr int kMaxDepth = 4;

// Offsets (elements) of the packed weights, their transposes, the biases and the gradient
// partial's blocks; see fused_nerf_packed_fwd_launch for the host-side order.
struct PNet {
  const void* w;
  const float* b;
  int depth, e_p, e_v;
  int w1, tw[kMaxDepth], wfs, wv, wr;     // [in, out] in T
  int twt[kMaxDepth], wfst, wvt, wrt;     // [out, in] in T (backward)
  int b1, tb[kMaxDepth], bfs, bv, br;     // float32
  int g_w1, g_tw[kMaxDepth], g_wfs, g_wv, g_wr;
  int g_b1, g_tb[kMaxDepth], g_bfs, g_bv, g_br;
};

PNet make_pnet(const void* w, const float* b, const int* o, int depth, int e_p, int e_v) {
  PNet n;
  n.w = w; n.b = b; n.depth = depth; n.e_p = e_p; n.e_v = e_v;
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
  return n;
}

// Shared memory of one tile, in floats: two [W][kLD] activation buffers, the live lanes of
// the packed tile [e_p + e_v][kLD] and, for the backward, the rounded cotangent [4][kLD].
__host__ __device__ inline size_t packed_smem_floats(int W, int e_p, int e_v) {
  return (size_t)(2 * W + e_p + e_v + 4) * kLD;
}

// One tile of kernel 12's forward: out (may be null) [P, 8]; with `acts`, each trunk
// activation, the feature activation and the view activation of the tile's valid points in T,
// layer l (l <= D) at acts + l * lstride as [kTP][W], the view activation at
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

template <typename T, int W>
__global__ void __launch_bounds__(kThreads, 1)
    fused_nerf_packed_fwd_kernel(const PNet n, const T* __restrict__ x, float* __restrict__ out,
                                 int P) {
  extern __shared__ __align__(16) float smem[];
  float* buf0 = smem;
  float* buf1 = buf0 + W * kLD;
  float* xs = buf1 + W * kLD;
  packed_forward_tile<T, W>(n, buf0, buf1, xs, x, P, blockIdx.x * kTP, out, nullptr, 0);
}

// The backward of one tile (see the source note), from the activations that
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

template <typename K>
cudaError_t prepare(K kernel, size_t smem) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

template <typename T, int W>
int launch(bool bwd, const PNet& n, const void* x, const float* g, void* scratch, float* out,
           float* part, size_t part_stride, int G, int P, cudaStream_t stream) {
  const size_t smem = sizeof(float) * packed_smem_floats(W, n.e_p, n.e_v);
  const T* xt = reinterpret_cast<const T*>(x);
  cudaError_t e;
  if (bwd) {
    auto k = fused_nerf_packed_bwd_kernel<T, W>;
    if ((e = prepare(k, smem)) != cudaSuccess) return (int)e;
    k<<<G, kThreads, smem, stream>>>(n, xt, g, reinterpret_cast<T*>(scratch), part,
                                     part_stride, P);
  } else {
    auto k = fused_nerf_packed_fwd_kernel<T, W>;
    if ((e = prepare(k, smem)) != cudaSuccess) return (int)e;
    k<<<(P + kTP - 1) / kTP, kThreads, smem, stream>>>(n, xt, out, P);
  }
  return (int)cudaGetLastError();
}

int dispatch(bool bwd, const void* x, const float* g, const void* w, const float* b,
             const int* off, void* scratch, float* out, float* part, long long part_stride,
             int G, int P, int depth, int width, int e_p, int e_v, int is_bf16, void* stream) {
  if (depth < 1 || depth > kMaxDepth || P < 0 || (width != 128 && width != 256) || e_p < 3 ||
      e_v < 3 || e_p + e_v > kPack || (bwd && (G < 1 || part_stride % 4 || scratch == nullptr)))
    return (int)cudaErrorInvalidValue;
  if (P == 0) return 0;
  const PNet n = make_pnet(w, b, off, depth, e_p, e_v);
  cudaStream_t s = (cudaStream_t)stream;
  const size_t ps = (size_t)part_stride;
  if (is_bf16) {
    return width == 256
               ? launch<__nv_bfloat16, 256>(bwd, n, x, g, scratch, out, part, ps, G, P, s)
               : launch<__nv_bfloat16, 128>(bwd, n, x, g, scratch, out, part, ps, G, P, s);
  }
  return width == 256 ? launch<float, 256>(bwd, n, x, g, scratch, out, part, ps, G, P, s)
                      : launch<float, 128>(bwd, n, x, g, scratch, out, part, ps, G, P, s);
}

}  // namespace

// Kernel 12. Returns a cudaError_t (0 on success).
//   x    the packed encoding [P, 128] in T (bfloat16 if is_bf16, else float);
//   w    one buffer of T: W1, TW_1..TW_{D-1}, WFS, WV, WR ([in, out], the TPU kernel's packed
//        layout) and their transposes ([out, in]);
//   b    one float32 buffer of the biases b1, tb_1.., bfs, bv, br;
//   off  34 host ints: element offsets in w of W1, TW_1..TW_3, WFS, WV, WR (7), of the
//        transposes TW_1^T..TW_3^T, WFS^T, WV^T, WR^T (6); in b of b1, tb_1..tb_3, bfs, bv,
//        br (7); in a gradient row of d(W1), d(TW_1..3), d(WFS), d(WV), d(WR), d(b1),
//        d(tb_1..3), d(bfs), d(bv), d(br) (14); entries of layers past the depth unused;
//   out  [P, 8] float32.
extern "C" int fused_nerf_packed_fwd_launch(const void* x, const void* w, const float* b,
                                            const int* off, float* out, int P, int depth,
                                            int width, int e_p, int e_v, int is_bf16,
                                            void* stream) {
  if (out == nullptr) return (int)cudaErrorInvalidValue;
  return dispatch(false, x, nullptr, w, b, off, nullptr, out, nullptr, 0, 1, P, depth, width,
                  e_p, e_v, is_bf16, stream);
}

// Kernel 13: float32 gradients of the packed weights for the cotangent g [P, 8] float32 of
// kernel 12's output, into G rows of `part` (zeroed, row b at part + b * part_stride, the
// offsets of `off`; sum them with fused_nerf_grad_reduce_launch). scratch holds
// G x ((D + 1) 64 W + 64 W / 2) elements of T.
extern "C" int fused_nerf_packed_bwd_launch(const void* x, const float* g, const void* w,
                                            const float* b, const int* off, void* scratch,
                                            float* part, long long part_stride, int G, int P,
                                            int depth, int width, int e_p, int e_v,
                                            int is_bf16, void* stream) {
  if (g == nullptr || part == nullptr) return (int)cudaErrorInvalidValue;
  return dispatch(true, x, g, w, b, off, scratch, nullptr, part, part_stride, G, P, depth,
                  width, e_p, e_v, is_bf16, stream);
}

extern "C" const char* fused_nerf_packed_error_string(int e) {
  return cudaGetErrorString((cudaError_t)e);
}
