// Fused NeRF MLP forward for Hopper (sm_90a): kernel 1 (serving), kernel 4 (training,
// saves activations), their semantic variants, kernels 6 and 7, with the semantic head, and
// kernel 9 (the early-terminating forward).
//
// Kernel 1 replaces the Pallas TPU kernel depth_lidar_nerf_tpu/ops/fused_mlp_t.py:_fwd_kernel
// (body _forward_tile, entry _fwd_impl). For points [3, P] (float32) with point p on ray
// p / S, and per-ray unit view directions [3, N], it computes
//   enc   = [x, sin(2^0 x), cos(2^0 x), ..., cos(2^(n_p-1) x)]        (e_p = 3 + 6 n_p rows,
//                                                                     the Flax row order)
//   h_0   = relu(enc W_0 + b_0)
//   h_i   = relu(h_{i-1} W_i + b_i)            or, after a live skip at i-1,
//         = relu(enc W_i[:e_p] + h_{i-1} W_i[e_p:] + b_i)             (concat [x, h])
//   sigma = h W_sigma + b_sigma;  feat = h W_feat + b_feat
//   hv    = relu(feat W_v[:W] + (enc_v W_v[W:])_per_ray + b_v)        (per-ray term once per ray)
//   raw   = [hv W_rgb + b_rgb, sigma]   written channel-major [4, P] (rgb 0-2, sigma 3)
// The operand type T is float or bfloat16; every product accumulates in float32,
// and each stored activation is rounded to T, as the JAX kernel does.
//
// Kernel 4 replaces fused_mlp_t.py:_fwd_kernel_acts (entry _fwd_impl_acts): the same
// forward, which also writes the D trunk activations and the feature activation as
// [P, W] and the view activation as [P, W / 2], in T, for the backward of
// fused_nerf_bwd.cu that reads them instead of recomputing (kernel 5).
//
// Bound on the H100: operations for kernel 1. At the serving shapes (W = 256, D = 4 coarse,
// D = 8 with a skip fine) a point costs ~0.3-0.6 M multiply-adds against 28 bytes of input
// and output, thousands of FLOP per byte. Kernel 4 also writes (D + 1) W + W / 2 values a
// point (2,816 bytes in bfloat16 at D = 4, W = 256), which at 989 TFLOP/s against
// 3.35 TB/s makes it bound by bytes. In bfloat16 the trunk, skip, feature and view-layer
// products run on the tensor cores (mma.sync m16n8k16, each k-step's sum added to float32
// accumulators; fused_nerf.cuh tc_layer): each warp owns all 64 points of the tile and 32
// (trunk) or 16 (view) output columns, converts its A fragments from the float32
// activations in shared memory (exact: they are bfloat16 values) and reads its B
// fragments from the padded tensor-core weight rows through L1/L2, one k-step ahead. In float32 the products stay on the CUDA cores
// (FMA, an 8-point x W/32-column register tile a thread): TF32 would not keep float32
// parity. The 1-column sigma head, the 3-column rgb head and the per-ray half of the view
// layer stay on FMA in both. What else the design does about the bound: every intermediate
// activation stays in shared memory (device memory sees only the points, the view
// directions, the weights through L2, the raw output and, for kernel 4, one write of each
// saved activation), and the view layer's per-ray half is computed once per ray rather
// than once per point. What bounds the bfloat16 tile: each 64-point tile reads the whole
// net's weights through L2 (~0.63 MB at D = 4, ~1.19 MB at D = 8 with a skip), so the
// tile size, not the tensor cores, sets its floor (PERF.md).
//
// Kernels 6 and 7 replace fused_mlp_t.py:_fwd_kernel_sem_only and _fwd_kernel_acts_sem
// (head _sem_head_tile, entries _fwd_impl_sem_only and _fwd_impl_acts_sem): kernels 1 and 4
// plus the reference's semantic head (two Dense layers off the pre-view feature, no
// activation between) summed over each ray's samples without weights. The head is affine
// and the sum unweighted, so they commute: per ray,
//   fsum   = sum_s feat_s                     (float32 sum, rounded to T)
//   s0r    = fsum W_s0 + S b_s0               (rounded to T)
//   logits = s0r W_s1 + S b_s1                (float32, [N, C])
// and the head runs on [N, W] ray sums, never on per-point features. The TPU kernel sums a
// ray inside one 8,192-point VMEM tile; here a ray spans several 64-point tiles, so each
// tile block writes a float32 partial sum per ray it touches (forward_tile's `fpart`), and
// fused_nerf_sem_head_kernel adds a ray's partials in tile order, rounds, and runs both head
// layers: deterministic, with no atomics. Kernel 7's head also saves fsum and s0r ([N,
// W + W/2] in T) for the backward (kernel 8, fused_nerf_bwd.cu); they equal what the
// backward would recompute. The head costs ~W^2 / 2 multiply-adds a ray, under 1/S of a
// point's MLP.
//
// Kernel 9 replaces fused_mlp_t.py:_fwd_kernel_cf (entry _fwd_impl_cf): kernel 1's forward
// with early ray termination, for the fine pass of a training step under DLNERF_CULL_FWD=1.
// Its input is regrouped (fused_mlp_t.py:cf_layout): rays sorted by a termination estimate,
// padded to groups of kCfRays = 128, each group cut into blocks of 128 rays x kCfSB = 16
// samples, a group's blocks in sample order; point q of block k is sample q % 16 of the
// block's ray q / 16, so kernel 1's tile body runs on it unchanged with S = 16 and one view
// direction per (ray, block). One block of threads takes one group and walks its blocks in
// order, carrying each ray's transmittance T (1 at the first block) in shared memory. A
// block whose 128 rays all have T < eps (half the compositor's cull_eps) is skipped and
// written as (0, 0, 0, -1e10): the compositor gives its samples exactly zero weight either
// way. Otherwise its 32 tiles of 64 points run kernel 1's body, whose result for a point
// does not depend on the tile it lies in (kernel 1 gives the same bits on the same point),
// and each ray's T is multiplied by exp(sum over its 16 samples of log(exp(-max(sigma +
// noise, 0) delta) + 1e-10)), the compositor's factors (deltas and noise come with the
// points as aux [2, P]). Bound: as kernel 1, on the live blocks only. The fine pass's
// 16,384 rays make 128 groups, one wave on the H100's 132 SMs; a group's blocks run in
// sequence, since a block's skip depends on the blocks before it.
//
// Layout. One block of 256 threads owns a tile of kTP = 64 consecutive points; a ragged
// last tile is masked, not padded. See fused_nerf.cuh for the shared-memory layout and the
// packed weights.

#include "fused_nerf.cuh"

namespace {

using namespace fnerf;

template <typename T, int W>
__global__ void __launch_bounds__(kThreads, 1)
    fused_nerf_fwd_kernel(const Net net, const float* __restrict__ pts,
                          const float* __restrict__ vd, float* __restrict__ out, int P, int S) {
  extern __shared__ __align__(16) float smem[];
  const Smem s = carve(smem, W, 3 + 6 * net.n_p, 3 + 6 * net.n_v);
  forward_tile<T, W>(net, s, pts, vd, P, S, blockIdx.x * kTP, out, nullptr, 0, 0);
}

template <typename T, int W>
__global__ void __launch_bounds__(kThreads, 1)
    fused_nerf_fwd_acts_kernel(const Net net, const float* __restrict__ pts,
                               const float* __restrict__ vd, float* __restrict__ out,
                               T* __restrict__ acts, int P, int S) {
  extern __shared__ __align__(16) float smem[];
  const Smem s = carve(smem, W, 3 + 6 * net.n_p, 3 + 6 * net.n_v);
  const int p0 = blockIdx.x * kTP;
  forward_tile<T, W>(net, s, pts, vd, P, S, p0, out, acts, (size_t)P * W, (size_t)p0);
}

// Kernels 6 (kActs false) and 7 (kActs true): kernels 1 and 4 plus each tile's semantic
// partial sums, sem_tile_slots(S) x W floats per tile at fpart + tile * MR * W.
template <typename T, int W, bool kActs>
__global__ void __launch_bounds__(kThreads, 1)
    fused_nerf_fwd_sem_kernel(const Net net, const float* __restrict__ pts,
                              const float* __restrict__ vd, float* __restrict__ out,
                              T* __restrict__ acts, float* __restrict__ fpart, int MR, int P,
                              int S) {
  extern __shared__ __align__(16) float smem[];
  const Smem s = carve(smem, W, 3 + 6 * net.n_p, 3 + 6 * net.n_v);
  const int p0 = blockIdx.x * kTP;
  forward_tile<T, W>(net, s, pts, vd, P, S, p0, out, kActs ? acts : nullptr, (size_t)P * W,
                     (size_t)p0, fpart + (size_t)blockIdx.x * MR * W);
}

constexpr int kCfRays = 128;                    // rays per group (kernel 9)
constexpr int kCfSB = 16;                       // samples per block
constexpr int kCfPoints = kCfRays * kCfSB;      // points per block

// Kernel 9 (see the source note): block g takes group g, points [g nSB kCfPoints,
// (g + 1) nSB kCfPoints) of the regrouped pts [3, P], vd [3, P / 16] and aux [2, P]
// (deltas, noise); out [4, P].
template <typename T, int W>
__global__ void __launch_bounds__(kThreads, 1)
    fused_nerf_fwd_cf_kernel(const Net net, const float* __restrict__ pts,
                             const float* __restrict__ vd, const float* __restrict__ aux,
                             float* out, int P, int nSB, float eps) {
  extern __shared__ __align__(16) float smem[];
  __shared__ float t_ray[kCfRays];
  const Smem s = carve(smem, W, 3 + 6 * net.n_p, 3 + 6 * net.n_v);
  const int tid = threadIdx.x;
  if (tid < kCfRays) t_ray[tid] = 1.f;
  for (int sb = 0; sb < nSB; ++sb) {
    const int q0 = (blockIdx.x * nSB + sb) * kCfPoints;
    // Orders this block's T update (and every write of the block before) before the test.
    const bool live = __syncthreads_or(tid < kCfRays && t_ray[tid] >= eps);
    if (live) {
      for (int t = 0; t < kCfPoints / kTP; ++t) {
        forward_tile<T, W>(net, s, pts, vd, P, kCfSB, q0 + t * kTP, out, nullptr, 0, 0);
        __syncthreads();
      }
      if (tid < kCfRays) {
        float sm = 0.f;
        for (int i = 0; i < kCfSB; ++i) {
          const size_t q = (size_t)q0 + tid * kCfSB + i;
          const float sg = fmaxf(out[(size_t)3 * P + q] + aux[(size_t)P + q], 0.f) * aux[q];
          sm += logf(expf(-sg) + 1e-10f);
        }
        t_ray[tid] *= expf(sm);
      }
    } else {
      for (int i = tid; i < kCfPoints; i += kThreads) {
        const size_t q = (size_t)q0 + i;
        out[q] = 0.f;
        out[(size_t)P + q] = 0.f;
        out[(size_t)2 * P + q] = 0.f;
        out[(size_t)3 * P + q] = -1e10f;
      }
    }
  }
}

constexpr int kHeadRays = 8;  // rays per block of the semantic head

// The semantic head of kernels 6 and 7 (see the source note), kHeadRays rays per block:
// ray R's partials are the slots R - tile_first_ray(t, S) of the tiles t that hold its
// points, added in tile order. Weights as [in, out] in T (W_s0 [W, W/2], W_s1 [W/2, C]),
// biases float32. With `sem_acts`, row R gets fsum then s0r (W + W/2 values of T).
template <typename T, int W>
__global__ void __launch_bounds__(kThreads)
    fused_nerf_sem_head_kernel(const float* __restrict__ fpart, int MR,
                               const T* __restrict__ ws0, const float* __restrict__ bs0,
                               const T* __restrict__ ws1, const float* __restrict__ bs1,
                               float* __restrict__ sem, T* __restrict__ sem_acts, int N, int S,
                               int C) {
  constexpr int WH = W / 2;
  __shared__ float fs[kHeadRays][W];
  __shared__ float s0[kHeadRays][WH];
  const int tid = threadIdx.x, r0 = blockIdx.x * kHeadRays;
  const float Sf = (float)S;
  for (int idx = tid; idx < kHeadRays * W; idx += kThreads) {
    const int r = idx / W, c = idx % W, R = r0 + r;
    float v = 0.f;
    if (R < N) {
      const int t0 = (int)(((long long)R * S) / kTP);
      const int t1 = (int)(((long long)R * S + S - 1) / kTP);
      float sm = 0.f;
      for (int t = t0; t <= t1; ++t)
        sm += fpart[((size_t)t * MR + (R - tile_first_ray(t, S))) * W + c];
      v = rnd<T>(sm);
      if (sem_acts) sem_acts[(size_t)R * (W + WH) + c] = from_f<T>(v);
    }
    fs[r][c] = v;
  }
  __syncthreads();
  for (int idx = tid; idx < kHeadRays * WH; idx += kThreads) {
    const int r = idx / WH, j = idx % WH, R = r0 + r;
    float acc = 0.f;
    for (int k = 0; k < W; ++k) acc = fmaf(fs[r][k], to_f<T>(ws0[(size_t)k * WH + j]), acc);
    const float v = rnd<T>(acc + Sf * bs0[j]);
    s0[r][j] = v;
    if (sem_acts && R < N) sem_acts[(size_t)R * (W + WH) + W + j] = from_f<T>(v);
  }
  __syncthreads();
  for (int idx = tid; idx < kHeadRays * C; idx += kThreads) {
    const int r = idx / C, c = idx % C, R = r0 + r;
    if (R >= N) continue;
    float acc = 0.f;
    for (int k = 0; k < WH; ++k) acc = fmaf(s0[r][k], to_f<T>(ws1[(size_t)k * C + c]), acc);
    sem[(size_t)R * C + c] = acc + Sf * bs1[c];
  }
}

template <typename K>
cudaError_t prepare(K kernel, size_t smem) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

// Kernel 1 (acts and fpart null), 4 (acts), 6 (fpart) or 7 (both).
template <typename T, int W>
int launch(const Net& net, const float* pts, const float* vd, float* out, void* acts,
           float* fpart, int MR, int P, int S, cudaStream_t stream) {
  const size_t smem = sizeof(float) * fwd_smem_floats(W, 3 + 6 * net.n_p, 3 + 6 * net.n_v);
  const int blocks = (P + kTP - 1) / kTP;
  T* a = reinterpret_cast<T*>(acts);
  cudaError_t e;
  if (fpart != nullptr && acts != nullptr) {
    auto k = fused_nerf_fwd_sem_kernel<T, W, true>;
    if ((e = prepare(k, smem)) != cudaSuccess) return (int)e;
    k<<<blocks, kThreads, smem, stream>>>(net, pts, vd, out, a, fpart, MR, P, S);
  } else if (fpart != nullptr) {
    auto k = fused_nerf_fwd_sem_kernel<T, W, false>;
    if ((e = prepare(k, smem)) != cudaSuccess) return (int)e;
    k<<<blocks, kThreads, smem, stream>>>(net, pts, vd, out, a, fpart, MR, P, S);
  } else if (acts != nullptr) {
    auto k = fused_nerf_fwd_acts_kernel<T, W>;
    if ((e = prepare(k, smem)) != cudaSuccess) return (int)e;
    k<<<blocks, kThreads, smem, stream>>>(net, pts, vd, out, a, P, S);
  } else {
    auto k = fused_nerf_fwd_kernel<T, W>;
    if ((e = prepare(k, smem)) != cudaSuccess) return (int)e;
    k<<<blocks, kThreads, smem, stream>>>(net, pts, vd, out, P, S);
  }
  return (int)cudaGetLastError();
}

int dispatch(const float* pts, const float* vd, const void* w, const void* wp, const float* b,
             float* out, void* acts, float* fpart, int MR, int P, int S, int depth, int width,
             int n_p, int n_v, int skip_mask, int is_bf16, const int* woff, const int* boff,
             const int* poff, void* stream) {
  if (depth < 1 || depth > 8 || S < 1 || P % S != 0 || (width != 128 && width != 256) ||
      (fpart != nullptr && (!sem_aligned(S) || MR < sem_tile_slots(S))) ||
      (is_bf16 && (wp == nullptr || poff == nullptr)))
    return (int)cudaErrorInvalidValue;
  if (P == 0) return 0;
  const Net net = make_net(w, nullptr, wp, b, depth, n_p, n_v, skip_mask, woff, boff, poff);
  cudaStream_t s = (cudaStream_t)stream;
  if (is_bf16) {
    return width == 256
               ? launch<__nv_bfloat16, 256>(net, pts, vd, out, acts, fpart, MR, P, S, s)
               : launch<__nv_bfloat16, 128>(net, pts, vd, out, acts, fpart, MR, P, S, s);
  }
  return width == 256 ? launch<float, 256>(net, pts, vd, out, acts, fpart, MR, P, S, s)
                      : launch<float, 128>(net, pts, vd, out, acts, fpart, MR, P, S, s);
}

template <typename T, int W>
int launch_cf(const Net& net, const float* pts, const float* vd, const float* aux, float* out,
              int P, int nSB, float eps, cudaStream_t stream) {
  const size_t smem = sizeof(float) * fwd_smem_floats(W, 3 + 6 * net.n_p, 3 + 6 * net.n_v);
  auto k = fused_nerf_fwd_cf_kernel<T, W>;
  cudaError_t e;
  if ((e = prepare(k, smem)) != cudaSuccess) return (int)e;
  k<<<P / (nSB * kCfPoints), kThreads, smem, stream>>>(net, pts, vd, aux, out, P, nSB, eps);
  return (int)cudaGetLastError();
}

template <typename T, int W>
int launch_head(const float* fpart, int MR, const void* ws0, const float* bs0, const void* ws1,
                const float* bs1, float* sem, void* sem_acts, int N, int S, int C,
                cudaStream_t stream) {
  const int blocks = (N + kHeadRays - 1) / kHeadRays;
  fused_nerf_sem_head_kernel<T, W><<<blocks, kThreads, 0, stream>>>(
      fpart, MR, reinterpret_cast<const T*>(ws0), bs0, reinterpret_cast<const T*>(ws1), bs1,
      sem, reinterpret_cast<T*>(sem_acts), N, S, C);
  return (int)cudaGetLastError();
}

}  // namespace

// Kernel 1. Returns a cudaError_t (0 on success). woff/boff/poff are host arrays of
// depth + 4 offsets (elements) into w, b and wp: trunk_0..trunk_{D-1}, sigma, feature,
// views_0, rgb (poff's sigma and rgb entries unused). wp and poff: the tensor-core rows of
// fused_nerf.cuh, required in bfloat16, may be null in float32.
extern "C" int fused_nerf_fwd_launch(const float* pts, const float* vd, const void* w,
                                     const void* wp, const float* b, float* out, int P, int S,
                                     int depth, int width, int n_p, int n_v, int skip_mask,
                                     int is_bf16, const int* woff, const int* boff,
                                     const int* poff, void* stream) {
  return dispatch(pts, vd, w, wp, b, out, nullptr, nullptr, 0, P, S, depth, width, n_p, n_v,
                  skip_mask, is_bf16, woff, boff, poff, stream);
}

// Kernel 4: kernel 1 plus the saved activations `acts`, (D + 1) [P, W] arrays followed by
// one [P, W / 2] array, contiguous, in the weights' type.
extern "C" int fused_nerf_fwd_acts_launch(const float* pts, const float* vd, const void* w,
                                          const void* wp, const float* b, float* out,
                                          void* acts, int P, int S, int depth, int width,
                                          int n_p, int n_v, int skip_mask, int is_bf16,
                                          const int* woff, const int* boff, const int* poff,
                                          void* stream) {
  if (acts == nullptr) return (int)cudaErrorInvalidValue;
  return dispatch(pts, vd, w, wp, b, out, acts, nullptr, 0, P, S, depth, width, n_p, n_v,
                  skip_mask, is_bf16, woff, boff, poff, stream);
}

// Kernels 6 (acts null) and 7: kernels 1 and 4 that also write each tile's semantic partial
// sums to `fpart`, ceil(P / 64) x MR x W floats with MR >= sem_tile_slots(S), for S with
// sem_aligned(S) (fused_nerf.cuh); fused_nerf_sem_head_launch turns them into logits.
extern "C" int fused_nerf_fwd_sem_launch(const float* pts, const float* vd, const void* w,
                                         const void* wp, const float* b, float* out,
                                         void* acts, float* fpart, int MR, int P, int S,
                                         int depth, int width, int n_p, int n_v, int skip_mask,
                                         int is_bf16, const int* woff, const int* boff,
                                         const int* poff, void* stream) {
  if (fpart == nullptr) return (int)cudaErrorInvalidValue;
  return dispatch(pts, vd, w, wp, b, out, acts, fpart, MR, P, S, depth, width, n_p, n_v,
                  skip_mask, is_bf16, woff, boff, poff, stream);
}

// The semantic head of kernels 6 and 7: logits `sem` [N, C] float32 from the tile partials
// of fused_nerf_fwd_sem_launch; ws0 [W, W/2] and ws1 [W/2, C] in T, bs0 and bs1 float32;
// with `sem_acts` (may be null) also fsum and s0r as [N, W + W/2] in T.
extern "C" int fused_nerf_sem_head_launch(const float* fpart, const void* ws0, const float* bs0,
                                          const void* ws1, const float* bs1, float* sem,
                                          void* sem_acts, int MR, int N, int S, int width,
                                          int C, int is_bf16, void* stream) {
  if (N < 0 || !sem_aligned(S) || C < 1 || MR < sem_tile_slots(S) ||
      (width != 128 && width != 256))
    return (int)cudaErrorInvalidValue;
  if (N == 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  if (is_bf16) {
    return width == 256 ? launch_head<__nv_bfloat16, 256>(fpart, MR, ws0, bs0, ws1, bs1, sem,
                                                          sem_acts, N, S, C, s)
                        : launch_head<__nv_bfloat16, 128>(fpart, MR, ws0, bs0, ws1, bs1, sem,
                                                          sem_acts, N, S, C, s);
  }
  return width == 256
             ? launch_head<float, 256>(fpart, MR, ws0, bs0, ws1, bs1, sem, sem_acts, N, S, C, s)
             : launch_head<float, 128>(fpart, MR, ws0, bs0, ws1, bs1, sem, sem_acts, N, S, C, s);
}

// Kernel 9: the early-terminating forward on the regrouped layout of the source note. pts
// [3, P] and aux [2, P] (deltas, noise) float32 with P = groups x nSB x 2,048, vd [3, P / 16]
// (one view direction per ray and block), out [4, P]; eps is the skip threshold (half the
// compositor's cull_eps). Weights as fused_nerf_fwd_launch; no skip concat.
extern "C" int fused_nerf_fwd_cf_launch(const float* pts, const float* vd, const float* aux,
                                        const void* w, const void* wp, const float* b,
                                        float* out, int P, int nSB, float eps, int depth,
                                        int width, int n_p, int n_v, int is_bf16,
                                        const int* woff, const int* boff, const int* poff,
                                        void* stream) {
  if (depth < 1 || depth > 8 || nSB < 1 || P < 0 || P % (nSB * kCfPoints) != 0 ||
      (width != 128 && width != 256) || (is_bf16 && (wp == nullptr || poff == nullptr)))
    return (int)cudaErrorInvalidValue;
  if (P == 0) return 0;
  const Net net = make_net(w, nullptr, wp, b, depth, n_p, n_v, 0, woff, boff, poff);
  cudaStream_t s = (cudaStream_t)stream;
  if (is_bf16) {
    return width == 256 ? launch_cf<__nv_bfloat16, 256>(net, pts, vd, aux, out, P, nSB, eps, s)
                        : launch_cf<__nv_bfloat16, 128>(net, pts, vd, aux, out, P, nSB, eps, s);
  }
  return width == 256 ? launch_cf<float, 256>(net, pts, vd, aux, out, P, nSB, eps, s)
                      : launch_cf<float, 128>(net, pts, vd, aux, out, P, nSB, eps, s);
}

extern "C" const char* fused_nerf_fwd_error_string(int e) {
  return cudaGetErrorString((cudaError_t)e);
}
