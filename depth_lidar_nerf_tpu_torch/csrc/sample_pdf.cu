// Inverse-CDF importance sampling for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel depth_lidar_nerf_tpu/ops/sampling_pallas.py:_kernel
// (entry sample_pdf_pallas). Computes, per ray r, with bins [N, B], weights
// [N, B-1] and draws u [N, V] (all float32, row-major):
//   pdf = (w + 1e-5) / sum(w + 1e-5); cdf = [0, cumsum(pdf)]            (B entries)
//   i = #{j : cdf[j] <= u}  (searchsorted side="right")
//   below = max(0, i - 1), above = min(B - 1, i)
//   denom = cdf[above] - cdf[below], set to 1 where < 1e-5
//   out = bins[below] + (u - cdf[below]) / denom * (bins[above] - bins[below])
// as ops/sampling.py:87-125 of the JAX package does.
//
// Bound on the H100: bytes. Each ray reads (2B - 1 + V) floats and writes V,
// about 2 FLOP per byte, far below the ~20 FLOP/byte where float32 compute
// would bind. The design reads every input once and writes every output once:
// one warp per ray loads its weights and bins with coalesced strided loads,
// builds the CDF in shared memory (never in device memory), and then each lane inverts V / 32 draws by binary search over the
// shared CDF (the reference's own thread-per-query torchsearchsorted design).
// The prefix sum itself is sequential in one lane (62 adds at B = 63), which
// costs nothing measurable against the loads and keeps the float32 order fixed.

#include <cuda_runtime.h>

namespace {

constexpr int kWarps = 8;  // rays per block

__global__ void sample_pdf_kernel(const float* __restrict__ bins,
                                  const float* __restrict__ weights,
                                  const float* __restrict__ u,
                                  float* __restrict__ out, int N, int B, int V) {
  extern __shared__ float smem[];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int ray = blockIdx.x * kWarps + warp;
  if (ray >= N) return;  // whole warp leaves together; no block barrier below
  float* cdf = smem + warp * 2 * B;
  float* bn = cdf + B;
  const int nw = B - 1;
  const float* w = weights + (size_t)ray * nw;

  // Coalesced loads into shared memory; then lane 0 forms the total and
  // the prefix sum in sequential float32 order, the order the plain version
  // uses, so both give bit-identical CDFs (a different summation order moves
  // cdf[B-1] across 1.0 and flips the u = 1 draw between two bins).
  for (int j = lane; j < nw; j += 32) cdf[j + 1] = w[j] + 1e-5f;
  const float* b = bins + (size_t)ray * B;
  for (int j = lane; j < B; j += 32) bn[j] = b[j];
  __syncwarp();
  if (lane == 0) {
    float total = 0.f;
    for (int j = 1; j <= nw; ++j) total = __fadd_rn(total, cdf[j]);
    float c = 0.f;
    cdf[0] = 0.f;
    for (int j = 1; j <= nw; ++j) {
      c = __fadd_rn(c, __fdiv_rn(cdf[j], total));
      cdf[j] = c;
    }
  }
  __syncwarp();

  const float* ur = u + (size_t)ray * V;
  float* o_r = out + (size_t)ray * V;
  for (int q = lane; q < V; q += 32) {
    const float x = ur[q];
    int lo = 0, hi = B;  // upper_bound: first j with cdf[j] > x
    while (lo < hi) {
      const int mid = (lo + hi) >> 1;
      if (cdf[mid] <= x) lo = mid + 1; else hi = mid;
    }
    const int below = lo - 1 < 0 ? 0 : lo - 1;
    const int above = lo < B - 1 ? lo : B - 1;
    const float c0 = cdf[below], c1 = cdf[above];
    const float b0 = bn[below], b1 = bn[above];
    float denom = c1 - c0;
    if (denom < 1e-5f) denom = 1.f;
    const float t = __fdiv_rn(__fsub_rn(x, c0), denom);
    o_r[q] = __fadd_rn(b0, __fmul_rn(t, __fsub_rn(b1, b0)));  // no FMA: as the plain version
  }
}

}  // namespace

extern "C" int sample_pdf_launch(const float* bins, const float* weights,
                                 const float* u, float* out, int N, int B,
                                 int V, void* stream) {
  if (N <= 0 || V <= 0) return 0;
  const int blocks = (N + kWarps - 1) / kWarps;
  const size_t smem = sizeof(float) * 2 * B * kWarps;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        sample_pdf_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  sample_pdf_kernel<<<blocks, 32 * kWarps, smem, (cudaStream_t)stream>>>(
      bins, weights, u, out, N, B, V);
  return (int)cudaGetLastError();
}

extern "C" const char* sample_pdf_error_string(int e) {
  return cudaGetErrorString((cudaError_t)e);
}
