// Inverse-CDF importance sampling for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel depth_lidar_nerf_tpu/ops/sampling_pallas.py:_kernel
// (entry sample_pdf_pallas). Computes, per ray r, with bins [N, B], weights
// [N, B-1] and draws u [N, V] (all float32; each row unit-stride, rows at any
// stride, 0 included, so a slice or an expand is read where it lies):
//   pdf = (w + 1e-5) / sum(w + 1e-5); cdf = [0, cumsum(pdf)]            (B entries)
//   i = #{j : cdf[j] <= u}  (searchsorted side="right")
//   below = max(0, i - 1), above = min(B - 1, i)
//   denom = cdf[above] - cdf[below], set to 1 where < 1e-5
//   out = bins[below] + (u - cdf[below]) / denom * (bins[above] - bins[below])
// as ops/sampling.py:87-125 of the JAX package does.
//
// Bound on the H100: bytes. Each ray reads (2B - 1 + V) floats and writes V
// (253 floats at B = 63, V = 64), about 2 FLOP per byte, far below the ~20
// FLOP/byte where float32 compute would bind. Every input is read once and
// every output written once; the CDF lives in shared memory only. What holds
// the kernel back from that bound is latency, not bytes: each tile of rays
// passes through two sequential add chains, a division phase and the
// searches, each behind a block barrier (PERF.md, kernel 14).
//
// Design: a tile is kRays rays; a block of four warps walks tiles blockIdx.x,
// + gridDim.x, ..., sized to kBlocksPerSm blocks an SM (fewer rays a tile
// where the grid would leave SMs idle, as at a frame's ragged 320-ray tile).
//  1. Staging, double-buffered: while a tile is worked, the next tile's
//     weights and bins rows arrive by cp.async into the other stage. Warp w
//     copies rows w, w + 4, ...; its lanes walk a row's columns, so each
//     copy instruction of a warp reads 32 neighbouring floats. Rows are read
//     at their own stride (the renderer's weights slice, an expanded u), so
//     no input is copied first; the weights start at column 1 of a row of S
//     and the bins rows hold 63 floats, so these copies are 4 bytes each.
//     Rows lie in shared memory at the odd pitch Bp + 1, so the lanes that
//     walk their rows at one column hit distinct banks.
//  2. Totals: lane r of warp 0 adds ray r's B - 1 terms w_j + 1e-5 in order,
//     the tile's chains side by side, one a lane.
//  3. Divisions on every lane: p_j = (w_j + 1e-5) / total has no dependence
//     on the running sum.
//  4. Prefix sums: lane r of warp 0 adds ray r's p_j in order into the CDF.
//  5. Searches: an item is 64 draws of one row, two a lane (draws lane and
//     lane + 32), so a warp's lanes read one row; each lane keeps kBatch
//     items' 2 searches in flight at once. The CDF is padded with +inf to Bp, the
//     power of two above B, and searched by log2(Bp) halving steps, unrolled
//     at compile time for the main path's Bp = 64; then the guarded lerp
//     without FMA. A tile's first draws are loaded before the wait for its
//     rows.
// The two add chains stay sequential float32 sums in the plain version's
// order (ops/sampling_cuda.py:inverse_cdf_plain) because the reference's
// inversion is discontinuous: a draw u = 1 against cdf[B-1] rounded to either
// side of 1.0 lands in different bins, and where the last weight is floored
// the denominator guard moves that sample by a whole bin. Each division and
// add here is the same IEEE operation on the same values as in the plain
// version, so the CDF and the samples equal it bit for bit. B up to 8,191.

#include <cuda_runtime.h>

namespace {

constexpr int kRays = 16;     // most rays a tile: lane r of warp 0 runs ray r's chains
constexpr int kThreads = 128; // four warps stage, divide and search
constexpr int kWarps = kThreads / 32;
constexpr int kRowsPerWarp = kRays / kWarps;  // rows a warp stages and divides
constexpr int kSlots = 2;     // draws a lane takes of an item: an item is 64 draws of a row
constexpr int kBatch = 4;     // items a warp searches at once
constexpr int kBlocksPerSm = 8;   // resident blocks the grid is sized for (64 registers)
constexpr int kStages = 2;    // tiles in shared memory: one worked, one arriving
constexpr int kSmemMax = 227 * 1024;

// The CDF padded with +inf to Bp, the least power of two above B, so that
// the search is log2(Bp) halving steps whose count reaches B; rows at the
// odd pitch Bp + 1.
__host__ __device__ inline int padded(int B) {
  int p = 1;
  while (p <= B) p <<= 1;
  return p;
}

// Shared floats of a block of `rays` rays a tile: kStages x (cdf, bins) at
// pitch Bp + 1, and the totals.
__host__ __device__ inline int smem_floats(int rays, int B) {
  return rays * (kStages * 2 * (padded(B) + 1) + 1);
}

__device__ inline void cp_async4(float* dst, const float* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d), "l"(src));
}
__device__ inline void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
__device__ inline void cp_async_wait_prior() { asm volatile("cp.async.wait_group 1;\n" ::); }

// kBp: the padded length where it is known at compile time (64, the main
// path's B = 63), else 0.
template <int kBp>
__global__ void __launch_bounds__(kThreads)
sample_pdf_kernel(const float* __restrict__ bins, long long sb,
                  const float* __restrict__ weights, long long sw,
                  const float* __restrict__ u, long long su,
                  float* __restrict__ out, int N, int B, int V, int rays) {
  extern __shared__ float smem[];
  const int Bp = kBp > 0 ? kBp : padded(B), P = Bp + 1, nw = B - 1;
  const int tiles = (N + rays - 1) / rays;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  float* tot = smem + kStages * 2 * rays * P;  // [rays]
  // stage s: cdf rows (0, then raw weights -> pdf -> cdf, +inf pad), bins rows
  auto cdf_of = [&](int s) { return smem + s * 2 * rays * P; };
  auto bn_of = [&](int s) { return smem + (s * 2 + 1) * rays * P; };

  for (int s = 0; s < kStages; ++s)
    for (int r = warp; r < rays; r += kWarps)
      for (int j = B + lane; j < Bp; j += 32) cdf_of(s)[r * P + j] = __int_as_float(0x7f800000);

  // Staging: warp w copies rows w, w + 4, ... of a tile, its lanes along a
  // row, with cp.async into stage s; every load of the tile in flight at once.
  auto stage = [&](int tile, int s) {
    const int ray0 = tile * rays, nr = min(rays, N - ray0);
    float* cdf = cdf_of(s);
    float* bn = bn_of(s);
    for (int c0 = 0; c0 < B; c0 += 32) {
      const int j = c0 + lane;
#pragma unroll
      for (int m = 0; m < kRowsPerWarp; ++m) {
        const int r = warp + m * kWarps;
        if (r < nr && j < nw) cp_async4(cdf + r * P + j + 1, weights + (ray0 + r) * sw + j);
        if (r < nr && j < B) cp_async4(bn + r * P + j, bins + (ray0 + r) * sb + j);
      }
    }
  };

  // Search items: item it is row it / nch's draws 64 (it % nch) ..; a warp
  // takes items warp, warp + 4, ..., kBatch at a time. Draw slot k of a lane:
  // 64 c + lane + 32 k.
  const int nch = (V + 32 * kSlots - 1) / (32 * kSlots);
  auto draw = [&](int c, int k) { return 32 * kSlots * c + lane + 32 * k; };
  float x[kBatch][kSlots];
  auto load_draws = [&](int ray0, int items, int it0) {
#pragma unroll
    for (int e = 0; e < kBatch; ++e) {
      const int it = it0 + e * kWarps, r = it / nch, c = it - r * nch;
      const float* ur = u + (ray0 + r) * su;
#pragma unroll
      for (int k = 0; k < kSlots; ++k)
        x[e][k] = (it < items && draw(c, k) < V) ? ur[draw(c, k)] : 0.f;
    }
  };

  int tile = blockIdx.x;
  if (tile < tiles) stage(tile, 0);
  cp_async_commit();
  for (int s = 0; tile < tiles; tile += gridDim.x, s ^= 1) {
    const int next = tile + gridDim.x;
    if (next < tiles) stage(next, s ^ 1);  // arrives while this tile is worked
    cp_async_commit();
    const int ray0 = tile * rays, nr = min(rays, N - ray0), items = nr * nch;
    load_draws(ray0, items, warp);  // the first batch's draws, in flight meanwhile
    cp_async_wait_prior();
    __syncthreads();
    float* cdf = cdf_of(s);
    const float* bn = bn_of(s);

    // 1. Totals, one chain a lane, in the plain version's order.
    if (threadIdx.x < nr) {
      const float* cr = cdf + threadIdx.x * P;
      float t = 0.f;
#pragma unroll 8
      for (int j = 1; j <= nw; ++j) t = __fadd_rn(t, cr[j] + 1e-5f);
      tot[threadIdx.x] = t;
    }
    __syncthreads();

    // 2. Divisions on every lane.
    for (int c0 = 0; c0 < nw; c0 += 32) {
      const int j = c0 + lane + 1;
#pragma unroll
      for (int m = 0; m < kRowsPerWarp; ++m) {
        const int r = warp + m * kWarps;
        if (r < nr && j <= nw) cdf[r * P + j] = __fdiv_rn(cdf[r * P + j] + 1e-5f, tot[r]);
      }
    }
    __syncthreads();

    // 3. Prefix sums, one chain a lane, in the plain version's order.
    if (threadIdx.x < nr) {
      float* cr = cdf + threadIdx.x * P;
      float c = 0.f;
      cr[0] = 0.f;
#pragma unroll 8
      for (int j = 1; j <= nw; ++j) {
        c = __fadd_rn(c, cr[j]);
        cr[j] = c;
      }
    }
    __syncthreads();

    // 4. Searches, kBatch items x kSlots draws of a lane in flight at once.
    for (int it0 = warp; it0 < items; it0 += kWarps * kBatch) {
      if (it0 != warp) load_draws(ray0, items, it0);
      int i[kBatch][kSlots];
      const float* cr[kBatch];
#pragma unroll
      for (int e = 0; e < kBatch; ++e) {
        // items past the tile's last search its last row; never stored
        cr[e] = cdf + min((it0 + e * kWarps) / nch, nr - 1) * P;
#pragma unroll
        for (int k = 0; k < kSlots; ++k) i[e][k] = 0;
      }
      // i = #{j : cdf[j] <= x} over the padded row, by halving steps (with
      // kBp, unrolled at immediate offsets)
#pragma unroll
      for (int h = Bp >> 1; h > 0; h >>= 1) {
#pragma unroll
        for (int e = 0; e < kBatch; ++e)
#pragma unroll
          for (int k = 0; k < kSlots; ++k)
            if (cr[e][i[e][k] + h - 1] <= x[e][k]) i[e][k] += h;
      }
#pragma unroll
      for (int e = 0; e < kBatch; ++e) {
        const int it = it0 + e * kWarps, r = it / nch, c = it - r * nch;
        const float* br = bn + (cr[e] - cdf);
        float y[kSlots];
#pragma unroll
        for (int k = 0; k < kSlots; ++k) {
          const int n = min(i[e][k], B);  // upper_bound over the B real entries
          const int below = n - 1 < 0 ? 0 : n - 1;
          const int above = n < B - 1 ? n : B - 1;
          const float c0 = cr[e][below], c1 = cr[e][above];
          const float b0 = br[below], b1 = br[above];
          float denom = c1 - c0;
          if (denom < 1e-5f) denom = 1.f;
          const float t = __fdiv_rn(__fsub_rn(x[e][k], c0), denom);
          y[k] = __fadd_rn(b0, __fmul_rn(t, __fsub_rn(b1, b0)));  // no FMA: as the plain version
        }
        if (it < items) {
          float* o_r = out + (ray0 + r) * (long long)V;
#pragma unroll
          for (int k = 0; k < kSlots; ++k)
            if (draw(c, k) < V) o_r[draw(c, k)] = y[k];
        }
      }
    }
    __syncthreads();  // stage s and the totals are free for the next tiles
  }
}

// The current device's SM count, asked at each launch (the device may change).
cudaError_t sm_count(int* n) {
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  return cudaDeviceGetAttribute(n, cudaDevAttrMultiProcessorCount, dev);
}

template <int kBp>
int launch(const float* bins, long long sb, const float* weights, long long sw,
           const float* u, long long su, float* out, int N, int B, int V,
           int rays, int blocks, cudaStream_t stream) {
  const size_t smem = sizeof(float) * (size_t)smem_floats(rays, B);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        sample_pdf_kernel<kBp>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  sample_pdf_kernel<kBp><<<blocks, kThreads, smem, stream>>>(
      bins, sb, weights, sw, u, su, out, N, B, V, rays);
  return (int)cudaGetLastError();
}

}  // namespace

// Rows of bins, weights and u start `sb`, `sw`, `su` floats apart (0 allowed);
// out is a dense [N, V].
extern "C" int sample_pdf_launch(const float* bins, long long sb,
                                 const float* weights, long long sw,
                                 const float* u, long long su, float* out,
                                 int N, int B, int V, void* stream) {
  if (N <= 0 || V <= 0) return 0;
  // kRays rays a tile at large N, each block walking several tiles; fewer
  // where the grid's blocks would be left idle, or the rows would not fit.
  int sms = 0;
  const cudaError_t e = sm_count(&sms);
  if (e != cudaSuccess) return (int)e;
  const long long slots = (long long)sms * kBlocksPerSm;
  int rays = (int)((N + slots - 1) / slots);
  rays = rays < 1 ? 1 : (rays > kRays ? kRays : rays);
  while (rays > 1 && sizeof(float) * (size_t)smem_floats(rays, B) > (size_t)kSmemMax)
    rays = (rays + 1) / 2;
  if (sizeof(float) * (size_t)smem_floats(rays, B) > (size_t)kSmemMax)
    return (int)cudaErrorInvalidValue;
  const long long tiles = (N + rays - 1) / rays;
  const int blocks = (int)(tiles < slots ? tiles : slots);
  cudaStream_t s = (cudaStream_t)stream;
  if (padded(B) == 64)  // 32 <= B < 64: the main path's B = 63
    return launch<64>(bins, sb, weights, sw, u, su, out, N, B, V, rays, blocks, s);
  return launch<0>(bins, sb, weights, sw, u, su, out, N, B, V, rays, blocks, s);
}

extern "C" const char* sample_pdf_error_string(int e) {
  return cudaGetErrorString((cudaError_t)e);
}
