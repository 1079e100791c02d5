// Fused NeRF MLP forward for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel depth_lidar_nerf_tpu/ops/fused_mlp_t.py:_fwd_kernel
// (body _forward_tile, entry _fwd_impl). For points [3, P] (float32) with point p
// on ray p / S, and per-ray unit view directions [3, N], it computes
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
// Bound on the H100: operations. At the serving shapes (W = 256, D = 4 coarse,
// D = 8 with a skip fine) a point costs ~0.3-0.6 M multiply-adds against 28 bytes
// of input and output, thousands of FLOP per byte. This first version runs the
// products on the CUDA cores (FMA), not the tensor cores, so it cannot reach the
// tensor-core bound; wgmma/TMA are later work. What it does about the bound:
// every intermediate activation stays in shared memory (device memory sees only
// the points, the view directions, the weights through L2, and the raw output),
// each thread keeps an 8-point x (W/32)-column register tile so that each weight
// it loads feeds 8 FMAs, and the view layer's per-ray half is computed once per
// ray rather than once per point.
//
// Layout. One block of 256 threads owns a tile of kTP = 64 consecutive points; a
// ragged last tile is masked, not padded. Activations live transposed in shared
// memory, [channel][kLD] with kLD = kTP + 4, so that a thread reads its 8 points
// as two float4 broadcasts and a warp's float4 stores hit distinct banks.
// Weights are packed by the wrapper as [in, out] row-major (the Flax kernel
// layout) in one buffer of T, biases in one float32 buffer, at the offsets given.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kTP = 64;           // points per block
constexpr int kThreads = 256;     // 8 warps; warp ty owns points [8 ty, 8 ty + 8)
constexpr int kLD = kTP + 4;      // shared row stride (floats)
constexpr int kMaxLayers = 12;    // depth <= 8 trunk layers + sigma, feature, views, rgb

struct Params {
  const float* pts;   // [3, P]
  const float* vd;    // [3, N]
  const void* w;      // packed weights (T)
  const float* b;     // packed biases
  float* out;         // [4, P]
  int P, S, depth, n_p, n_v, skip_mask;
  int woff[kMaxLayers];
  int boff[kMaxLayers];
};

template <typename T> __device__ __forceinline__ float to_f(T x);
template <> __device__ __forceinline__ float to_f<float>(float x) { return x; }
template <> __device__ __forceinline__ float to_f<__nv_bfloat16>(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T> __device__ __forceinline__ float rnd(float x);
template <> __device__ __forceinline__ float rnd<float>(float x) { return x; }
template <> __device__ __forceinline__ float rnd<__nv_bfloat16>(float x) {
  return __bfloat162float(__float2bfloat16(x));
}

// Row `row` of the positional encoding of x (Flax order: x, then per octave
// sin of the 3 dims, cos of the 3 dims). sinf/cosf, never __sinf: phases reach
// 2^(n-1) |x| and need full range reduction.
__device__ __forceinline__ float enc_row(const float x[3], int row) {
  if (row < 3) return x[row];
  const int r = row - 3, f = r / 6, m = r % 6;
  const float ph = ldexpf(x[m % 3], f);  // exact: a power-of-two scale
  return m < 3 ? sinf(ph) : cosf(ph);
}

template <int NJ>
__device__ __forceinline__ void init_acc(float (&acc)[8][NJ], const float* __restrict__ bias,
                                         int tx) {
#pragma unroll
  for (int j = 0; j < NJ; ++j) {
    const float bj = bias[tx + 32 * j];
#pragma unroll
    for (int i = 0; i < 8; ++i) acc[i][j] = bj;
  }
}

// acc[i][j] += sum_k in[k][8 ty + i] * w[k][tx + 32 j] for k < K.
template <typename T, int NJ>
__device__ __forceinline__ void mac(float (&acc)[8][NJ], const float* __restrict__ in, int K,
                                    const T* __restrict__ w, int N, int ty, int tx) {
  const float* a_ptr = in + ty * 8;
  const T* w_ptr = w + tx;
#pragma unroll 2
  for (int k = 0; k < K; ++k) {
    const float4 a0 = *reinterpret_cast<const float4*>(a_ptr + k * kLD);
    const float4 a1 = *reinterpret_cast<const float4*>(a_ptr + k * kLD + 4);
    const float a[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
    float wv[NJ];
#pragma unroll
    for (int j = 0; j < NJ; ++j) wv[j] = to_f<T>(w_ptr[(size_t)k * N + 32 * j]);
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < NJ; ++j) acc[i][j] = fmaf(a[i], wv[j], acc[i][j]);
  }
}

template <typename T, int NJ>
__device__ __forceinline__ void store(float (&acc)[8][NJ], float* __restrict__ out, bool relu,
                                      int ty, int tx) {
#pragma unroll
  for (int j = 0; j < NJ; ++j) {
    float v[8];
#pragma unroll
    for (int i = 0; i < 8; ++i) v[i] = rnd<T>(relu ? fmaxf(acc[i][j], 0.f) : acc[i][j]);
    float4* dst = reinterpret_cast<float4*>(out + (tx + 32 * j) * kLD + ty * 8);
    dst[0] = make_float4(v[0], v[1], v[2], v[3]);
    dst[1] = make_float4(v[4], v[5], v[6], v[7]);
  }
}

template <typename T, int W>
__global__ void __launch_bounds__(kThreads, 1) fused_nerf_fwd_kernel(const Params prm) {
  constexpr int NJ = W / 32;   // trunk / feature columns per thread
  constexpr int NJV = W / 64;  // view-layer columns per thread
  constexpr int WV = W / 2;
  extern __shared__ __align__(16) float smem[];
  const int e_p = 3 + 6 * prm.n_p, e_v = 3 + 6 * prm.n_v;
  float* buf0 = smem;
  float* buf1 = buf0 + W * kLD;
  float* enc = buf1 + W * kLD;       // [e_p][kLD]
  float* encv = enc + e_p * kLD;     // [rays in tile][e_v]

  const int tid = threadIdx.x, ty = tid >> 5, tx = tid & 31;
  const int P = prm.P, S = prm.S, N = P / S;
  const int p0 = blockIdx.x * kTP;
  const int n_valid = min(kTP, P - p0);
  const int r_lo = p0 / S;
  const int n_rays = (p0 + n_valid - 1) / S - r_lo + 1;
  const T* w = reinterpret_cast<const T*>(prm.w);
  const float* b = prm.b;

  // Encodings: per point (masked points encode x = 0) and per ray.
  for (int idx = tid; idx < e_p * kTP; idx += kThreads) {
    const int row = idx / kTP, p = idx % kTP;
    float x[3] = {0.f, 0.f, 0.f};
    if (p < n_valid) {
#pragma unroll
      for (int d = 0; d < 3; ++d) x[d] = prm.pts[(size_t)d * P + p0 + p];
    }
    enc[row * kLD + p] = rnd<T>(enc_row(x, row));
  }
  for (int idx = tid; idx < n_rays * e_v; idx += kThreads) {
    const int r = idx / e_v, row = idx % e_v;
    float x[3];
#pragma unroll
    for (int d = 0; d < 3; ++d) x[d] = prm.vd[(size_t)d * N + r_lo + r];
    encv[r * e_v + row] = rnd<T>(enc_row(x, row));
  }
  __syncthreads();

  // Trunk, ping-ponging between buf0 and buf1.
  float acc[8][NJ];
  const float* h = enc;
  for (int l = 0; l < prm.depth; ++l) {
    float* dst = (l & 1) ? buf1 : buf0;
    const T* wl = w + prm.woff[l];
    init_acc<NJ>(acc, b + prm.boff[l], tx);
    if (l == 0) {
      mac<T, NJ>(acc, enc, e_p, wl, W, ty, tx);
    } else if ((prm.skip_mask >> (l - 1)) & 1) {
      mac<T, NJ>(acc, enc, e_p, wl, W, ty, tx);
      mac<T, NJ>(acc, h, W, wl + (size_t)e_p * W, W, ty, tx);
    } else {
      mac<T, NJ>(acc, h, W, wl, W, ty, tx);
    }
    store<T, NJ>(acc, dst, true, ty, tx);
    __syncthreads();
    h = dst;
  }
  float* feat = (h == buf0) ? buf1 : buf0;
  float* hbuf = (h == buf0) ? buf0 : buf1;
  const int D = prm.depth;

  // Sigma head (row 3 of the output) from the last trunk activation.
  if (tid < n_valid) {
    const T* ws = w + prm.woff[D];
    float s = b[prm.boff[D]];
    for (int k = 0; k < W; ++k) s = fmaf(h[k * kLD + tid], to_f<T>(ws[k]), s);
    prm.out[(size_t)3 * P + p0 + tid] = s;
  }
  // Feature layer (linear).
  init_acc<NJ>(acc, b + prm.boff[D + 1], tx);
  mac<T, NJ>(acc, h, W, w + prm.woff[D + 1], W, ty, tx);
  store<T, NJ>(acc, feat, false, ty, tx);
  __syncthreads();

  // Per-ray half of the view layer, once per ray, into the free trunk buffer.
  float* hv = hbuf;                 // [WV][kLD]
  float* hv_ray = hbuf + WV * kLD;  // [n_rays][WV]
  const T* wv = w + prm.woff[D + 2];
  for (int idx = tid; idx < n_rays * WV; idx += kThreads) {
    const int r = idx / WV, c = idx % WV;
    float s = 0.f;
    for (int k = 0; k < e_v; ++k)
      s = fmaf(encv[r * e_v + k], to_f<T>(wv[(size_t)(W + k) * WV + c]), s);
    hv_ray[r * WV + c] = rnd<T>(s);
  }
  __syncthreads();

  // View layer: feat rows of views_0 per point plus the ray's term.
  {
    float accv[8][NJV];
    init_acc<NJV>(accv, b + prm.boff[D + 2], tx);
    mac<T, NJV>(accv, feat, W, wv, WV, ty, tx);
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int p = min(ty * 8 + i, n_valid - 1);
      const int r = (p0 + p) / S - r_lo;
#pragma unroll
      for (int j = 0; j < NJV; ++j) accv[i][j] += hv_ray[r * WV + tx + 32 * j];
    }
    store<T, NJV>(accv, hv, true, ty, tx);  // hv and hv_ray are disjoint
  }
  __syncthreads();

  // RGB head (rows 0-2 of the output).
  const T* wr = w + prm.woff[D + 3];
  for (int idx = tid; idx < 3 * kTP; idx += kThreads) {
    const int c = idx / kTP, p = idx % kTP;
    if (p >= n_valid) continue;
    float s = b[prm.boff[D + 3] + c];
    for (int k = 0; k < WV; ++k) s = fmaf(hv[k * kLD + p], to_f<T>(wr[k * 3 + c]), s);
    prm.out[(size_t)c * P + p0 + p] = s;
  }
}

template <typename T, int W>
int launch(const Params& prm, cudaStream_t stream) {
  const int e_p = 3 + 6 * prm.n_p, e_v = 3 + 6 * prm.n_v;
  const size_t smem = sizeof(float) * ((size_t)2 * W * kLD + (size_t)e_p * kLD + (size_t)kTP * e_v);
  cudaError_t e = cudaFuncSetAttribute(fused_nerf_fwd_kernel<T, W>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  const int blocks = (prm.P + kTP - 1) / kTP;
  fused_nerf_fwd_kernel<T, W><<<blocks, kThreads, smem, stream>>>(prm);
  return (int)cudaGetLastError();
}

}  // namespace

// Returns a cudaError_t (0 on success). woff/boff are host arrays of depth + 4
// offsets (elements) into w and b: trunk_0..trunk_{D-1}, sigma, feature, views_0, rgb.
extern "C" int fused_nerf_fwd_launch(const float* pts, const float* vd, const void* w,
                                     const float* b, float* out, int P, int S, int depth,
                                     int width, int n_p, int n_v, int skip_mask, int is_bf16,
                                     const int* woff, const int* boff, void* stream) {
  if (depth < 1 || depth > 8 || S < 1 || P % S != 0 || (width != 128 && width != 256))
    return (int)cudaErrorInvalidValue;
  if (P == 0) return 0;
  Params prm;
  prm.pts = pts; prm.vd = vd; prm.w = w; prm.b = b; prm.out = out;
  prm.P = P; prm.S = S; prm.depth = depth; prm.n_p = n_p; prm.n_v = n_v;
  prm.skip_mask = skip_mask;
  for (int i = 0; i < kMaxLayers; ++i) {
    prm.woff[i] = i < depth + 4 ? woff[i] : 0;
    prm.boff[i] = i < depth + 4 ? boff[i] : 0;
  }
  cudaStream_t s = (cudaStream_t)stream;
  if (is_bf16) {
    return width == 256 ? launch<__nv_bfloat16, 256>(prm, s) : launch<__nv_bfloat16, 128>(prm, s);
  }
  return width == 256 ? launch<float, 256>(prm, s) : launch<float, 128>(prm, s);
}

extern "C" const char* fused_nerf_fwd_error_string(int e) {
  return cudaGetErrorString((cudaError_t)e);
}
