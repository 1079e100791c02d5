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
//             recomputing them;
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
// The backward's products run on the CUDA cores (FMA), not the tensor cores; the forward
// that kernels 2 and 3 recompute is forward_tile, whose bfloat16 products run on the tensor
// cores (fused_nerf.cuh tc_layer), so its activations equal kernel 4's saved ones.
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
// outer products over the tile's 64 points with an 8 x 8 register tile per thread; the
// input products are the forward's register-tiled product on the [out, in] weight copy.

#include "fused_nerf.cuh"

namespace {

using namespace fnerf;

// The backward of one tile (see the source note), reading the tile's activations from
// `acts` as forward_tile writes them, and adding the tile's gradients into the block's
// partial: weights at gw + woff[l], biases at gbias + boff[l]. Expects s.enc and s.encv
// to hold the tile's encodings. With `dfeat_ray` ([N, W] in T), each point's feature
// cotangent also gets its ray's row (kernel 8).
template <typename T, int W>
__device__ void backward_tile(const Net& net, const Smem& s, const float* __restrict__ g,
                              int P, int S, int p0, const T* __restrict__ acts, size_t lstride,
                              size_t row0, float* __restrict__ gw, float* __restrict__ gbias,
                              const T* __restrict__ dfeat_ray = nullptr) {
  constexpr int NJ = W / 32;
  constexpr int NJV = W / 64;
  constexpr int WV = W / 2;
  const int e_p = 3 + 6 * net.n_p, e_v = 3 + 6 * net.n_v;
  const int tid = threadIdx.x, ty = tid >> 5, tx = tid & 31;
  const int n_valid = min(kTP, P - p0);
  const int r_lo = p0 / S;
  const int n_rays = (p0 + n_valid - 1) / S - r_lo + 1;
  const int D = net.depth;
  const T* wt = reinterpret_cast<const T*>(net.wt);
  const T* arow = acts + row0 * W;
  float* A = s.buf0;   // activation operand
  float* Dg = s.buf1;  // gradient operand

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
  __syncthreads();

  // rgb head: d(W_rgb)[k][c] = sum_p hv[k][p] gb[c][p]; dhv = mask(hv, gb W_rgb^T).
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

  // View layer: the feat rows and the per-ray rows of d(W_v), d(b_v), then dfeat.
  load_rows<T>(A, arow + D * lstride, W, n_valid);  // feat
  for (int idx = tid; idx < n_rays * WV; idx += kThreads) {
    const int r = idx / WV, k = idx % WV;
    const int lo = max(0, (r_lo + r) * S - p0), hi = min(n_valid, (r_lo + r + 1) * S - p0);
    float sm = 0.f;
    for (int p = lo; p < hi; ++p) sm += Dg[k * kLD + p];
    s.seg[r * WV + k] = rnd<T>(sm);
  }
  __syncthreads();
  outer(gw + net.woff[D + 2], A, W, Dg, WV, ty, tx);
  bias_sum(gbias + net.boff[D + 2], Dg, WV);
  for (int idx = tid; idx < e_v * WV; idx += kThreads) {
    const int e = idx / WV, k = idx % WV;
    float sm = 0.f;
    for (int r = 0; r < n_rays; ++r) sm = fmaf(s.encv[r * e_v + e], s.seg[r * WV + k], sm);
    gw[net.woff[D + 2] + (W + e) * WV + k] += sm;
  }
  float acc[8][NJ];
  init_acc<NJ>(acc, nullptr, tx);
  mac<T, NJ>(acc, Dg, WV, wt + net.woff[D + 2], W + e_v, ty, tx);
  if (dfeat_ray) {
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int p = ty * 8 + i;
      if (p < n_valid) {
        const T* row = dfeat_ray + (size_t)((p0 + p) / S) * W + tx;
#pragma unroll
        for (int j = 0; j < NJ; ++j) acc[i][j] += to_f<T>(row[32 * j]);
      }
    }
  }
  __syncthreads();
  store_masked<T, NJ>(acc, nullptr, Dg, ty, tx);             // dfeat [W][kLD]
  load_rows<T>(A, arow + (D - 1) * lstride, W, n_valid);     // h_{D-1}
  __syncthreads();

  // Feature and sigma heads: d(W_feat), d(b_feat), d(W_sigma); dh.
  outer(gw + net.woff[D + 1], A, W, Dg, W, ty, tx);
  bias_sum(gbias + net.boff[D + 1], Dg, W);
  for (int k = tid; k < W; k += kThreads) {
    float sm = 0.f;
    for (int p = 0; p < kTP; ++p) sm = fmaf(A[k * kLD + p], s.gb[3 * kLD + p], sm);
    gw[net.woff[D] + k] += sm;
  }
  init_acc<NJ>(acc, nullptr, tx);
  mac<T, NJ>(acc, Dg, W, wt + net.woff[D + 1], W, ty, tx);
  {
    const T* wsig = wt + net.woff[D];
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const float ws = to_f<T>(wsig[tx + 32 * j]);
#pragma unroll
      for (int i = 0; i < 8; ++i) acc[i][j] = fmaf(s.gb[3 * kLD + ty * 8 + i], ws, acc[i][j]);
    }
  }
  __syncthreads();

  // Trunk, last layer to first; A holds h_l when layer l starts.
  for (int l = D - 1; l >= 0; --l) {
    store_masked<T, NJ>(acc, A, Dg, ty, tx);  // dh_l
    __syncthreads();
    if (l == 0) {
      outer(gw + net.woff[0], s.enc, e_p, Dg, W, ty, tx);
      bias_sum(gbias + net.boff[0], Dg, W);
      break;
    }
    const bool skip = (net.skip_mask >> (l - 1)) & 1;
    const int in_l = W + (skip ? e_p : 0);
    load_rows<T>(A, arow + (l - 1) * lstride, W, n_valid);  // h_{l-1}
    __syncthreads();
    outer(gw + net.woff[l] + (skip ? e_p * W : 0), A, W, Dg, W, ty, tx);
    if (skip) outer(gw + net.woff[l], s.enc, e_p, Dg, W, ty, tx);
    bias_sum(gbias + net.boff[l], Dg, W);
    init_acc<NJ>(acc, nullptr, tx);
    mac<T, NJ>(acc, Dg, W, wt + net.woff[l] + (skip ? e_p : 0), in_l, ty, tx);
    __syncthreads();
  }
  __syncthreads();
}

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
    backward_tile<T, W>(net, s, g, P, S, t * kTP, mine, lstride, 0, gw, gw + n_w);
  }
}

// Kernel 5 (kSem false): the backward from the activations kernel 4 saved; with kSem, the
// trunk of kernel 8, which also takes the semantic head's per-ray feature cotangent.
template <typename T, int W, bool kSem>
__global__ void __launch_bounds__(kThreads, 1)
    fused_nerf_bwd_acts_kernel(const Net net, const float* __restrict__ pts,
                               const float* __restrict__ vd, const float* __restrict__ g,
                               const T* __restrict__ acts, const T* __restrict__ dfeat_ray,
                               float* __restrict__ part, size_t part_stride, int n_w, int P,
                               int S) {
  extern __shared__ __align__(16) float smem[];
  const int e_p = 3 + 6 * net.n_p, e_v = 3 + 6 * net.n_v;
  const Smem s = carve(smem, W, e_p, e_v);
  const int n_tiles = (P + kTP - 1) / kTP;
  float* gw = part + blockIdx.x * part_stride;
  for (int t = blockIdx.x; t < n_tiles; t += gridDim.x) {
    const int p0 = t * kTP;
    encode_tile<T>(s, pts, vd, P, S, p0, min(kTP, P - p0), e_p, e_v);
    __syncthreads();
    backward_tile<T, W>(net, s, g, P, S, p0, acts, (size_t)P * W, (size_t)p0, gw, gw + n_w,
                        kSem ? dfeat_ray : nullptr);
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
// or kernel 8's trunk with dfeat_ray).
template <typename T, int W>
int launch(int mode, const Net& net, const float* pts, const float* vd, const float* g,
           const int* flags, const void* acts, const void* dfeat_ray, void* scratch,
           float* part, size_t part_stride, int G, int n_w, int P, int S, cudaStream_t stream) {
  const size_t smem = sizeof(float) * bwd_smem_floats(W, 3 + 6 * net.n_p, 3 + 6 * net.n_v);
  cudaError_t e;
  const T* a = reinterpret_cast<const T*>(acts);
  const T* dr = reinterpret_cast<const T*>(dfeat_ray);
  if (mode == 2 && dfeat_ray != nullptr) {
    auto k = fused_nerf_bwd_acts_kernel<T, W, true>;
    if ((e = prepare(k, smem)) != cudaSuccess) return (int)e;
    k<<<G, kThreads, smem, stream>>>(net, pts, vd, g, a, dr, part, part_stride, n_w, P, S);
  } else if (mode == 2) {
    auto k = fused_nerf_bwd_acts_kernel<T, W, false>;
    if ((e = prepare(k, smem)) != cudaSuccess) return (int)e;
    k<<<G, kThreads, smem, stream>>>(net, pts, vd, g, a, nullptr, part, part_stride, n_w, P, S);
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
//            them);
//   dfeat_ray (mode 2 only, may be null) the semantic head's feature cotangent [P / S, W]
//            in T, from fused_nerf_sem_head_bwd_launch: kernel 8's trunk;
//   w, wt    the packed weights [in, out] and [out, in] in T; b the packed biases;
//   wp, poff the tensor-core rows of the recompute's forward (fused_nerf.cuh; modes 0 and 1
//            in bfloat16; may be null otherwise) and their offsets;
//   scratch  G x ((D + 1) 64 W + 64 W / 2) elements of T (modes 0 and 1);
//   part     G rows of part_stride floats, zeroed: row b is block b's partial gradient,
//            weights first (n_w floats, packed [in, out] offsets) then biases.
// G is the grid (blocks); the caller sums the rows with fused_nerf_grad_reduce_launch.
extern "C" int fused_nerf_bwd_launch(int mode, const float* pts, const float* vd,
                                     const float* g, const int* flags, const void* acts,
                                     const void* dfeat_ray, const void* w, const void* wt,
                                     const void* wp, const float* b, void* scratch,
                                     float* part, long long part_stride, int G, int n_w, int P,
                                     int S, int depth, int width, int n_p, int n_v,
                                     int skip_mask, int is_bf16, const int* woff,
                                     const int* boff, const int* poff, void* stream) {
  if (depth < 1 || depth > 8 || S < 1 || P % S != 0 || (width != 128 && width != 256) ||
      mode < 0 || mode > 2 || G < 1 || (mode == 1 && flags == nullptr) ||
      (mode == 2 && acts == nullptr) || (mode != 2 && scratch == nullptr) ||
      (mode != 2 && dfeat_ray != nullptr) || part_stride % 4 ||
      (is_bf16 && mode != 2 && (wp == nullptr || poff == nullptr)))
    return (int)cudaErrorInvalidValue;
  if (P == 0) return 0;
  const Net net = make_net(w, wt, wp, b, depth, n_p, n_v, skip_mask, woff, boff, poff);
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
                                           scratch, part, ps, G, n_w, P, S, s)
                      : launch<float, 128>(mode, net, pts, vd, g, flags, acts, dfeat_ray,
                                           scratch, part, ps, G, n_w, P, S, s);
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
