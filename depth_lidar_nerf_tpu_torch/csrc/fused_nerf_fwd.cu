// Fused NeRF MLP forward for Hopper (sm_90a): kernel 1 (serving) and kernel 4 (training,
// saves activations).
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
// 3.35 TB/s makes it bound by bytes. This first version runs the products on the CUDA
// cores (FMA), not the tensor cores, so it reaches neither bound; wgmma/TMA are later
// work. What it does about the bound: every intermediate activation stays in shared memory
// (device memory sees only the points, the view directions, the weights through L2, the
// raw output and, for kernel 4, one coalesced write of each saved activation), each thread
// keeps an 8-point x (W/32)-column register tile so that each weight it loads feeds 8
// FMAs, and the view layer's per-ray half is computed once per ray rather than once per
// point.
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

template <typename T, int W>
int launch(const Net& net, const float* pts, const float* vd, float* out, void* acts, int P,
           int S, cudaStream_t stream) {
  const size_t smem = sizeof(float) * fwd_smem_floats(W, 3 + 6 * net.n_p, 3 + 6 * net.n_v);
  const int blocks = (P + kTP - 1) / kTP;
  cudaError_t e;
  if (acts == nullptr) {
    e = cudaFuncSetAttribute(fused_nerf_fwd_kernel<T, W>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
    fused_nerf_fwd_kernel<T, W><<<blocks, kThreads, smem, stream>>>(net, pts, vd, out, P, S);
  } else {
    e = cudaFuncSetAttribute(fused_nerf_fwd_acts_kernel<T, W>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
    fused_nerf_fwd_acts_kernel<T, W><<<blocks, kThreads, smem, stream>>>(
        net, pts, vd, out, reinterpret_cast<T*>(acts), P, S);
  }
  return (int)cudaGetLastError();
}

int dispatch(const float* pts, const float* vd, const void* w, const float* b, float* out,
             void* acts, int P, int S, int depth, int width, int n_p, int n_v, int skip_mask,
             int is_bf16, const int* woff, const int* boff, void* stream) {
  if (depth < 1 || depth > 8 || S < 1 || P % S != 0 || (width != 128 && width != 256))
    return (int)cudaErrorInvalidValue;
  if (P == 0) return 0;
  Net net;
  net.w = w; net.wt = nullptr; net.b = b;
  net.depth = depth; net.n_p = n_p; net.n_v = n_v; net.skip_mask = skip_mask;
  for (int i = 0; i < kMaxLayers; ++i) {
    net.woff[i] = i < depth + 4 ? woff[i] : 0;
    net.boff[i] = i < depth + 4 ? boff[i] : 0;
  }
  cudaStream_t s = (cudaStream_t)stream;
  if (is_bf16) {
    return width == 256 ? launch<__nv_bfloat16, 256>(net, pts, vd, out, acts, P, S, s)
                        : launch<__nv_bfloat16, 128>(net, pts, vd, out, acts, P, S, s);
  }
  return width == 256 ? launch<float, 256>(net, pts, vd, out, acts, P, S, s)
                      : launch<float, 128>(net, pts, vd, out, acts, P, S, s);
}

}  // namespace

// Kernel 1. Returns a cudaError_t (0 on success). woff/boff are host arrays of depth + 4
// offsets (elements) into w and b: trunk_0..trunk_{D-1}, sigma, feature, views_0, rgb.
extern "C" int fused_nerf_fwd_launch(const float* pts, const float* vd, const void* w,
                                     const float* b, float* out, int P, int S, int depth,
                                     int width, int n_p, int n_v, int skip_mask, int is_bf16,
                                     const int* woff, const int* boff, void* stream) {
  return dispatch(pts, vd, w, b, out, nullptr, P, S, depth, width, n_p, n_v, skip_mask,
                  is_bf16, woff, boff, stream);
}

// Kernel 4: kernel 1 plus the saved activations `acts`, (D + 1) [P, W] arrays followed by
// one [P, W / 2] array, contiguous, in the weights' type.
extern "C" int fused_nerf_fwd_acts_launch(const float* pts, const float* vd, const void* w,
                                          const float* b, float* out, void* acts, int P, int S,
                                          int depth, int width, int n_p, int n_v,
                                          int skip_mask, int is_bf16, const int* woff,
                                          const int* boff, void* stream) {
  if (acts == nullptr) return (int)cudaErrorInvalidValue;
  return dispatch(pts, vd, w, b, out, acts, P, S, depth, width, n_p, n_v, skip_mask, is_bf16,
                  woff, boff, stream);
}

extern "C" const char* fused_nerf_fwd_error_string(int e) {
  return cudaGetErrorString((cudaError_t)e);
}
