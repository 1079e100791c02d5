// Shared device code of the fused NeRF MLP kernels (fused_nerf_fwd.cu, fused_nerf_bwd.cu,
// fused_nerf_q8.cu, fused_nerf_packed.cu).
//
// The MLP and its packed layout (see fused_nerf_fwd.cu for the forward's source note):
// for points [3, P] (float32) with point p on ray p / S and per-ray unit view directions
// [3, N], layer l's weight is packed twice in one element type T (float or bfloat16):
// `w`  as [in, out] row-major (the Flax kernel layout: a skip layer's encoding rows come
// first) and `wt` as [out, in] row-major (torch's Linear.weight), both at offset woff[l];
// biases are float32 at boff[l]. Layers in order: trunk_0..trunk_{D-1}, sigma, feature,
// views_0, rgb. The forward reads `w`; the backward's input products read `wt`, so every
// weight load of a warp is contiguous.
//
// One block of 256 threads owns a tile of kTP = 64 consecutive points. Activations live
// transposed in shared memory, [channel][kLD] with kLD = kTP + 4. The generic products (`mac`
// for every float32 product and for the backward's float32 input products, `outer` for the
// weight gradients) run on the CUDA cores (FMA): a thread's register tile is 8 points (warp ty
// owns points 8 ty .. 8 ty + 7) x (W / 32) columns (lane tx owns columns tx + 32 j). The
// bfloat16 forward tile's trunk, skip, feature and view-layer products run on the tensor
// cores instead (`tc_layer`, mma.sync m16n8k16; the bfloat16 backward's input products
// likewise, `tc_mac_in`, and its weight gradients in fused_nerf_bwd.cu's GEMM): warp ty owns
// all 64 points and an eighth of the output columns, and reads its B operand from a third
// weight copy, `wp` (below).
// Each mma sums one k-step's 16 products from zero and the result is added to a float32
// accumulator (round to nearest), k-step by k-step: the tensor cores align a sum to its
// largest term and truncate, so carrying the accumulator through the mma would truncate
// at its magnitude every k-step and round more activations the wrong way than FMA sums do.
// Every product accumulates in float32 and every stored activation or activation gradient
// is rounded to T, where the JAX kernel rounds
// (depth_lidar_nerf_tpu/ops/fused_mlp_t.py: _forward_tile, _bwd_tile_body).
//
// `wp` (bfloat16 only, ops/fused_mlp_t.py:pack_params) holds the tensor-core rows of the
// trunk, feature and views_0 layers at poff[l], each as [out][K] with the input segments
// (the encoding's rows, then the previous activation's; views_0 keeps only its W feature
// rows) each zero-padded to a multiple of 16, and each run of 16 k stored in the order
// 0 1 8 9 2 3 10 11 4 5 12 13 6 7 14 15, so that lane t of a quad loads its four B values
// (k = 2t, 2t + 1, 2t + 8, 2t + 9) as one 8-byte word. The encoding in shared memory has
// zero rows up to pad16(e_p), so the padded K adds exact zeros.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace fnerf {

constexpr int kTP = 64;           // points per tile
constexpr int kThreads = 256;     // 8 warps
constexpr int kLD = kTP + 4;      // shared row stride (floats)
constexpr int kMaxLayers = 12;    // depth <= 8 trunk layers + sigma, feature, views, rgb

struct Net {
  const void* w;    // packed weights [in, out] (T)
  const void* wt;   // packed weights [out, in] (T); backward only
  const void* wp;   // tensor-core rows, padded [out][K] (bfloat16 forward only; see above)
  const void* wi;   // the backward's tensor-core rows (bfloat16 backward only; set by its
                    // launchers; tc_mac_in)
  const float* b;   // packed biases
  int depth, n_p, n_v, skip_mask;
  int woff[kMaxLayers];
  int boff[kMaxLayers];
  int poff[kMaxLayers];  // offsets into wp (trunk, feature and views_0 layers)
};

// The launchers' Net from their arguments: wt (backward only) and wp with poff (the
// bfloat16 forward tile's tensor-core rows) may be null where unused.
inline Net make_net(const void* w, const void* wt, const void* wp, const float* b, int depth,
                    int n_p, int n_v, int skip_mask, const int* woff, const int* boff,
                    const int* poff) {
  Net net;
  net.w = w; net.wt = wt; net.wp = wp; net.wi = nullptr; net.b = b;
  net.depth = depth; net.n_p = n_p; net.n_v = n_v; net.skip_mask = skip_mask;
  for (int i = 0; i < kMaxLayers; ++i) {
    net.woff[i] = i < depth + 4 ? woff[i] : 0;
    net.boff[i] = i < depth + 4 ? boff[i] : 0;
    net.poff[i] = i < depth + 4 && poff != nullptr ? poff[i] : 0;
  }
  return net;
}

// K of an input segment of a tensor-core product: a multiple of the mma's 16.
__host__ __device__ inline int pad16(int k) { return (k + 15) & ~15; }

template <typename T> __device__ __forceinline__ float to_f(T x);
template <> __device__ __forceinline__ float to_f<float>(float x) { return x; }
template <> __device__ __forceinline__ float to_f<__nv_bfloat16>(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

template <typename T> __device__ __forceinline__ float rnd(float x) {
  return to_f<T>(from_f<T>(x));
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

// Shared memory of one tile, in floats. The forward uses buf0, buf1, enc and encv; the
// backward uses buf0 (activation operand), buf1 (gradient operand), enc, encv, gb (the
// cotangent rounded to T) and seg (per-ray sums of the view-layer gradient).
struct Smem {
  float *buf0, *buf1, *enc, *encv, *gb, *seg;
};

__host__ __device__ inline size_t fwd_smem_floats(int W, int e_p, int e_v) {
  return (size_t)2 * W * kLD + (size_t)pad16(e_p) * kLD + (size_t)kTP * e_v;
}
__host__ __device__ inline size_t bwd_smem_floats(int W, int e_p, int e_v) {
  return fwd_smem_floats(W, e_p, e_v) + (size_t)4 * kLD + (size_t)kTP * (W / 2);
}

// gb and seg lie past the forward's share, so a forward-only launch never touches them.
__device__ __forceinline__ Smem carve(float* smem, int W, int e_p, int e_v) {
  Smem s;
  s.buf0 = smem;
  s.buf1 = s.buf0 + W * kLD;
  s.enc = s.buf1 + W * kLD;
  s.encv = s.enc + pad16(e_p) * kLD;
  s.gb = s.encv + kTP * e_v;
  s.seg = s.gb + 4 * kLD;
  return s;
}

// Encodings of one tile: per point (masked points encode x = 0; rows e_p .. pad16(e_p) - 1
// are zero) and per ray.
template <typename T>
__device__ __forceinline__ void encode_tile(const Smem& s, const float* __restrict__ pts,
                                            const float* __restrict__ vd, int P, int S, int p0,
                                            int n_valid, int e_p, int e_v) {
  const int N = P / S, r_lo = p0 / S;
  const int n_rays = (p0 + n_valid - 1) / S - r_lo + 1;
  for (int idx = threadIdx.x; idx < pad16(e_p) * kTP; idx += kThreads) {
    const int row = idx / kTP, p = idx % kTP;
    if (row >= e_p) {
      s.enc[row * kLD + p] = 0.f;
      continue;
    }
    float x[3] = {0.f, 0.f, 0.f};
    if (p < n_valid) {
#pragma unroll
      for (int d = 0; d < 3; ++d) x[d] = pts[(size_t)d * P + p0 + p];
    }
    s.enc[row * kLD + p] = rnd<T>(enc_row(x, row));
  }
  for (int idx = threadIdx.x; idx < n_rays * e_v; idx += kThreads) {
    const int r = idx / e_v, row = idx % e_v;
    float x[3];
#pragma unroll
    for (int d = 0; d < 3; ++d) x[d] = vd[(size_t)d * N + r_lo + r];
    s.encv[r * e_v + row] = rnd<T>(enc_row(x, row));
  }
}

template <int NJ>
__device__ __forceinline__ void init_acc(float (&acc)[8][NJ], const float* __restrict__ bias,
                                         int tx) {
#pragma unroll
  for (int j = 0; j < NJ; ++j) {
    const float bj = bias ? bias[tx + 32 * j] : 0.f;
#pragma unroll
    for (int i = 0; i < 8; ++i) acc[i][j] = bj;
  }
}

// acc[i][j] += sum_k in[k][8 ty + i] * w[k * ld + tx + 32 j] for k < K.
template <typename T, int NJ>
__device__ __forceinline__ void mac(float (&acc)[8][NJ], const float* __restrict__ in, int K,
                                    const T* __restrict__ w, int ld, int ty, int tx) {
  const float* a_ptr = in + ty * 8;
  const T* w_ptr = w + tx;
#pragma unroll 2
  for (int k = 0; k < K; ++k) {
    const float4 a0 = *reinterpret_cast<const float4*>(a_ptr + k * kLD);
    const float4 a1 = *reinterpret_cast<const float4*>(a_ptr + k * kLD + 4);
    const float a[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
    float wv[NJ];
#pragma unroll
    for (int j = 0; j < NJ; ++j) wv[j] = to_f<T>(w_ptr[(size_t)k * ld + 32 * j]);
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < NJ; ++j) acc[i][j] = fmaf(a[i], wv[j], acc[i][j]);
  }
}

// Round (after a ReLU if asked) into shared memory, transposed; with `g`, also write the
// tile's valid rows to device memory as [point][ld] in T.
template <typename T, int NJ>
__device__ __forceinline__ void store(float (&acc)[8][NJ], float* __restrict__ out, bool relu,
                                      int ty, int tx, T* __restrict__ g = nullptr, int ld = 0,
                                      int n_valid = 0) {
#pragma unroll
  for (int j = 0; j < NJ; ++j) {
    float v[8];
#pragma unroll
    for (int i = 0; i < 8; ++i) v[i] = rnd<T>(relu ? fmaxf(acc[i][j], 0.f) : acc[i][j]);
    float4* dst = reinterpret_cast<float4*>(out + (tx + 32 * j) * kLD + ty * 8);
    dst[0] = make_float4(v[0], v[1], v[2], v[3]);
    dst[1] = make_float4(v[4], v[5], v[6], v[7]);
    if (g) {
#pragma unroll
      for (int i = 0; i < 8; ++i)
        if (ty * 8 + i < n_valid) g[(size_t)(ty * 8 + i) * ld + tx + 32 * j] = from_f<T>(v[i]);
    }
  }
}

// Where gate > 0 (or everywhere without a gate), the accumulator rounded to T; else 0.
// Stored transposed into shared memory: the JAX kernel's _mask_cast.
template <typename T, int NJ>
__device__ __forceinline__ void store_masked(float (&acc)[8][NJ], const float* __restrict__ gate,
                                             float* __restrict__ out, int ty, int tx) {
#pragma unroll
  for (int j = 0; j < NJ; ++j) {
    const int c = tx + 32 * j;
    float v[8];
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const bool on = gate == nullptr || gate[c * kLD + ty * 8 + i] > 0.f;
      v[i] = on ? rnd<T>(acc[i][j]) : 0.f;
    }
    float4* dst = reinterpret_cast<float4*>(out + c * kLD + ty * 8);
    dst[0] = make_float4(v[0], v[1], v[2], v[3]);
    dst[1] = make_float4(v[4], v[5], v[6], v[7]);
  }
}

// ---- backward building blocks (fused_nerf_bwd.cu, fused_nerf_packed.cu) ----

// dW[k * ld + j] += sum_p a[k][p] * d[j][p] for k < K, j < N (N % 8 == 0; ld = N unless
// given, a multiple of 4); a and d in shared memory as [rows][kLD]; dW is this block's own
// float32 partial. Lane tx takes
// rows k = k0 + tx + 32 i (a warp's float4 loads of a then hit distinct banks), warp ty
// the 8-column groups ty, ty + 8, ...; every load of d is a broadcast.
__device__ __forceinline__ void outer(float* __restrict__ dW, const float* __restrict__ a,
                                      int K, const float* __restrict__ d, int N, int ty,
                                      int tx, int ld = 0) {
  if (ld == 0) ld = N;
  for (int k0 = 0; k0 < K; k0 += 256) {
    for (int jb = ty; jb < N / 8; jb += 8) {
      float acc[8][8];
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
#pragma unroll 1
      for (int p = 0; p < kTP; p += 4) {
        float4 dv[8];
#pragma unroll
        for (int j = 0; j < 8; ++j)
          dv[j] = *reinterpret_cast<const float4*>(d + (jb * 8 + j) * kLD + p);
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          const int k = k0 + tx + 32 * i;
          const float4 av = k < K ? *reinterpret_cast<const float4*>(a + k * kLD + p)
                                  : make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
          for (int j = 0; j < 8; ++j) {
            acc[i][j] = fmaf(av.x, dv[j].x, acc[i][j]);
            acc[i][j] = fmaf(av.y, dv[j].y, acc[i][j]);
            acc[i][j] = fmaf(av.z, dv[j].z, acc[i][j]);
            acc[i][j] = fmaf(av.w, dv[j].w, acc[i][j]);
          }
        }
      }
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const int k = k0 + tx + 32 * i;
        if (k < K) {
          float4* dst = reinterpret_cast<float4*>(dW + (size_t)k * ld + jb * 8);
          float4 u = dst[0], v = dst[1];
          u.x += acc[i][0]; u.y += acc[i][1]; u.z += acc[i][2]; u.w += acc[i][3];
          v.x += acc[i][4]; v.y += acc[i][5]; v.z += acc[i][6]; v.w += acc[i][7];
          dst[0] = u;
          dst[1] = v;
        }
      }
    }
  }
}

// db[j] += sum_p d[j][p] for j < N.
__device__ __forceinline__ void bias_sum(float* __restrict__ db, const float* __restrict__ d,
                                         int N) {
  for (int j = threadIdx.x; j < N; j += kThreads) {
    float sm = 0.f;
    for (int p = 0; p < kTP; ++p) sm += d[j * kLD + p];
    db[j] += sm;
  }
}

// dst[c][p] = src row p, column c (rows row0 + p of a [rows][C] array in T), 0 past n_valid.
template <typename T>
__device__ __forceinline__ void load_rows(float* __restrict__ dst, const T* __restrict__ src,
                                          int C, int n_valid) {
  for (int idx = threadIdx.x; idx < kTP * C; idx += kThreads) {
    const int p = idx / C, c = idx % C;
    dst[c * kLD + p] = p < n_valid ? to_f<T>(src[(size_t)p * C + c]) : 0.f;
  }
}

// The semantic kernels take S that divides kTP or that kTP divides (every S that the route
// predicate admits divides 2,048), so no ray straddles a tile unaligned.
__host__ __device__ inline bool sem_aligned(int S) {
  return S >= 1 && (kTP % S == 0 || S % kTP == 0);
}

// Slots of a tile's semantic partial sums: the rays that touch kTP consecutive points.
__host__ __device__ inline int sem_tile_slots(int S) {
  return S >= kTP ? 1 : kTP / S;
}

// First ray that touches tile t.
__host__ __device__ inline int tile_first_ray(int t, int S) {
  return (int)(((long long)t * kTP) / S);
}

// Sigma head (row 3 of raw [4, P]) from the last trunk activation h, one thread a point.
template <typename T, int W>
__device__ __forceinline__ void sigma_head(const Net& net, const float* __restrict__ h,
                                           float* __restrict__ out, int P, int p0, int n_valid) {
  const int tid = threadIdx.x;
  if (tid < n_valid) {
    const T* ws = reinterpret_cast<const T*>(net.w) + net.woff[net.depth];
    float sg = net.b[net.boff[net.depth]];
    for (int k = 0; k < W; ++k) sg = fmaf(h[k * kLD + tid], to_f<T>(ws[k]), sg);
    out[(size_t)3 * P + p0 + tid] = sg;
  }
}

// Semantic partial sums of one tile: the rounded feature `feat` [W][kLD] of each ray's points
// in the tile, summed in float32 in point order; slot r holds ray r_lo + r.
template <int W>
__device__ __forceinline__ void sem_partials(const float* __restrict__ feat,
                                             float* __restrict__ fpart, int S, int p0,
                                             int n_valid, int r_lo, int n_rays) {
  for (int idx = threadIdx.x; idx < n_rays * W; idx += kThreads) {
    const int r = idx / W, c = idx % W;
    const int lo = max(0, (r_lo + r) * S - p0), hi = min(n_valid, (r_lo + r + 1) * S - p0);
    float sm = 0.f;
    for (int p = lo; p < hi; ++p) sm += feat[c * kLD + p];
    fpart[r * W + c] = sm;
  }
}

// Per-ray half of the view layer, enc_v W_v[W:] rounded to T, once per ray the tile touches,
// into hv_ray [n_rays][W / 2].
template <typename T, int W>
__device__ __forceinline__ void view_ray_half(const Net& net, const Smem& s,
                                              float* __restrict__ hv_ray, int n_rays, int e_v) {
  constexpr int WV = W / 2;
  const T* wv = reinterpret_cast<const T*>(net.w) + net.woff[net.depth + 2];
  for (int idx = threadIdx.x; idx < n_rays * WV; idx += kThreads) {
    const int r = idx / WV, c = idx % WV;
    float sm = 0.f;
    for (int k = 0; k < e_v; ++k)
      sm = fmaf(s.encv[r * e_v + k], to_f<T>(wv[(size_t)(W + k) * WV + c]), sm);
    hv_ray[r * WV + c] = rnd<T>(sm);
  }
}

// RGB head (rows 0-2 of raw [4, P]) from the view activation hv [W / 2][kLD].
template <typename T, int W>
__device__ __forceinline__ void rgb_head(const Net& net, const float* __restrict__ hv,
                                         float* __restrict__ out, int P, int p0, int n_valid) {
  constexpr int WV = W / 2;
  const T* wr = reinterpret_cast<const T*>(net.w) + net.woff[net.depth + 3];
  for (int idx = threadIdx.x; idx < 3 * kTP; idx += kThreads) {
    const int c = idx / kTP, p = idx % kTP;
    if (p >= n_valid) continue;
    float sm = net.b[net.boff[net.depth + 3] + c];
    for (int k = 0; k < WV; ++k) sm = fmaf(hv[k * kLD + p], to_f<T>(wr[k * 3 + c]), sm);
    out[(size_t)c * P + p0 + p] = sm;
  }
}

// ---- the bfloat16 forward tile's products on the tensor cores ----

constexpr int kMT = kTP / 16;  // m16 tiles of a tile's points

__device__ __forceinline__ uint32_t bf16x2(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // cvt.rn.bf16x2.f32
  return *reinterpret_cast<uint32_t*>(&v);
}

// c += a b over one m16n8k16 step: bfloat16 operands; the step's 16 products summed on the
// tensor cores from zero, then added to the float32 accumulators c (header note).
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4], uint2 b) {
  float d[4];
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%10, %11, %12, %13};\n"
      : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b.x), "r"(b.y), "f"(0.f), "f"(0.f),
        "f"(0.f), "f"(0.f));
#pragma unroll
  for (int i = 0; i < 4; ++i) c[i] += d[i];
}

// acc[mt][nt] += in[k][16 mt + row] * B[n0 + 8 nt + col][k] for k < K (K % 16 == 0), k-steps
// in order, in the m16n8k16 fragment layout: lane (g = lane / 4, t = lane % 4) holds rows g and
// g + 8 of columns 2t and 2t + 1. `in` is [K][kLD] float32 in shared memory whose values are
// bfloat16 already, so converting the A fragments is exact; lane (g, t) reads (2t) kLD + g +
// ..., banks 8t + g, all 32 distinct. B is row-major [n][ldk] in the permuted order of the
// header note, read through L1/L2 one k-step ahead of the MMAs that use it (three steps ahead
// measured slower, PERF.md).
template <int NT>
__device__ __forceinline__ void tc_mac(float (&acc)[kMT][NT][4], const float* __restrict__ in,
                                       int K, const __nv_bfloat16* __restrict__ w, int ldk,
                                       int n0, int lane) {
  const int g = lane >> 2, t = lane & 3;
  const __nv_bfloat16* bp = w + (size_t)(n0 + g) * ldk + 4 * t;
  const float* ap = in + 2 * t * kLD + g;
  uint2 b[NT];
#pragma unroll
  for (int nt = 0; nt < NT; ++nt)
    b[nt] = __ldg(reinterpret_cast<const uint2*>(bp + (size_t)nt * 8 * ldk));
#pragma unroll 1
  for (int k0 = 0; k0 < K; k0 += 16) {
    const int kn = k0 + 16 < K ? k0 + 16 : k0;
    uint2 bn[NT];
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
      bn[nt] = __ldg(reinterpret_cast<const uint2*>(bp + (size_t)nt * 8 * ldk + kn));
#pragma unroll
    for (int mt = 0; mt < kMT; ++mt) {
      const float* a = ap + k0 * kLD + 16 * mt;
      const uint32_t af[4] = {bf16x2(a[0], a[kLD]), bf16x2(a[8], a[kLD + 8]),
                              bf16x2(a[8 * kLD], a[9 * kLD]),
                              bf16x2(a[8 * kLD + 8], a[9 * kLD + 8])};
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) mma_bf16(acc[mt][nt], af, b[nt]);
    }
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) b[nt] = bn[nt];
  }
}

// One dense layer of the bfloat16 forward tile over N = 64 NT outputs, warp ty taking
// columns n0 = 8 NT ty .. n0 + 8 NT - 1 of all 64 points: the products of input a
// ([Ka][kLD], Ka % 16 == 0) and then of input b ([Kb][kLD], may be absent) with the layer's
// rows `w` ([N][Ka + Kb]), accumulated from zero k-step by k-step (mma_bf16); then, in
// float32, with `hv_ray` ([n_rays][N], the view layer) the term of each point's ray, then the
// bias; the ReLU if asked, rounding to bfloat16 and the transposed store into `out`
// ([N][kLD]); with `g`, also the tile's valid rows to device memory as [point][N]. This is
// the order of the plain
// twin's `relu(x @ W^T (+ hv) + b)` (ops/fused_mlp_t.py:_forward_plain), whose bfloat16
// products add the same 16-k sums in the same order (ops/fused_mlp_t.py:_tc_mm).
template <int NT>
__device__ __forceinline__ void tc_layer(const float* __restrict__ bias,
                                         const float* __restrict__ a, int Ka,
                                         const float* __restrict__ b, int Kb,
                                         const __nv_bfloat16* __restrict__ w,
                                         float* __restrict__ out, bool relu,
                                         __nv_bfloat16* __restrict__ g, int n_valid,
                                         const float* __restrict__ hv_ray = nullptr, int S = 1,
                                         int p0 = 0) {
  constexpr int N = 64 * NT;
  const int lane = threadIdx.x & 31, gq = lane >> 2, t = lane & 3;
  const int n0 = (threadIdx.x >> 5) * 8 * NT;
  float acc[kMT][NT][4];
#pragma unroll
  for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[mt][nt][i] = 0.f;
  tc_mac<NT>(acc, a, Ka, w, Ka + Kb, n0, lane);
  if (Kb) tc_mac<NT>(acc, b, Kb, w + Ka, Ka + Kb, n0, lane);
  if (hv_ray) {
    const int r_lo = p0 / S;
#pragma unroll
    for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int p = min(16 * mt + gq + 8 * h, n_valid - 1);
        const float* hr = hv_ray + ((p0 + p) / S - r_lo) * N + n0 + 2 * t;
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) {
          acc[mt][nt][2 * h] += hr[8 * nt];
          acc[mt][nt][2 * h + 1] += hr[8 * nt + 1];
        }
      }
  }
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) {
    const float b0 = bias[n0 + 8 * nt + 2 * t], b1 = bias[n0 + 8 * nt + 2 * t + 1];
#pragma unroll
    for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int p = 16 * mt + gq + 8 * h, c = n0 + 8 * nt + 2 * t;
        const float x0 = acc[mt][nt][2 * h] + b0, x1 = acc[mt][nt][2 * h + 1] + b1;
        const float v0 = rnd<__nv_bfloat16>(relu ? fmaxf(x0, 0.f) : x0);
        const float v1 = rnd<__nv_bfloat16>(relu ? fmaxf(x1, 0.f) : x1);
        out[c * kLD + p] = v0;
        out[(c + 1) * kLD + p] = v1;
        if (g && p < n_valid)
          *reinterpret_cast<__nv_bfloat162*>(g + (size_t)p * N + c) =
              __floats2bfloat162_rn(v0, v1);
      }
  }
}

// ---- the backward tile's input products on the tensor cores (fused_nerf_bwd.cu,
// fused_nerf_packed.cu) ----

// acc[mt][nt] += sum_k in[k][16 mt + row] * w[(n0 + 8 nt + col) * ldk + k] for k < K
// (K % 16 == 0): a backward input product dX = dY W^T on the tensor cores, in tc_mac's fragment
// layout and k-step order (each k-step's 16 products summed from zero, then added in float32).
// `in` is the gradient [K][kLD] in shared memory (bfloat16 values, so the A fragments convert
// exactly); B is `wi`, the [in, out] weights with each run of 16 k of a row permuted as the
// forward's `wp` (pack_params' weights_ip): row n holds input n's ldk = out weights, and lane t
// of a quad reads its four, k = 2t, 2t + 1, 2t + 8, 2t + 9, as one 8-byte word, one k-step
// ahead of the MMAs that use them. (Read as two 4-byte words from the natural [in, out]
// rows, kernel 5's chain takes ~7% longer on the H100: scripts/torch_bwd_b_layout.py.)
template <int NT>
__device__ __forceinline__ void tc_mac_in(float (&acc)[kMT][NT][4], const float* __restrict__ in,
                                          int K, const __nv_bfloat16* __restrict__ w, int ldk,
                                          int n0, int lane) {
  const int g = lane >> 2, t = lane & 3;
  const uint2* bp = reinterpret_cast<const uint2*>(w + (size_t)(n0 + g) * ldk) + t;
  const float* ap = in + 2 * t * kLD + g;
  uint2 b[NT];
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) b[nt] = __ldg(bp + (size_t)nt * 2 * ldk);
#pragma unroll 1
  for (int k0 = 0; k0 < K; k0 += 16) {
    const int kn = k0 + 16 < K ? k0 + 16 : k0;
    uint2 bn[NT];
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) bn[nt] = __ldg(bp + (size_t)nt * 2 * ldk + kn / 4);
#pragma unroll
    for (int mt = 0; mt < kMT; ++mt) {
      const float* a = ap + k0 * kLD + 16 * mt;
      const uint32_t af[4] = {bf16x2(a[0], a[kLD]), bf16x2(a[8], a[kLD + 8]),
                              bf16x2(a[8 * kLD], a[9 * kLD]),
                              bf16x2(a[8 * kLD + 8], a[9 * kLD + 8])};
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) mma_bf16(acc[mt][nt], af, b[nt]);
    }
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) b[nt] = bn[nt];
  }
}

// store_masked for tc_mac_in's fragment layout (lane (gq, t) holds points 16 mt + gq + 8 h of
// columns n0 + 8 nt + 2t, + 1): where gate > 0 (or everywhere without a gate) the accumulator
// rounded to bfloat16, else 0, transposed into `out` ([N][kLD]); with `g`, also the tile's
// valid rows to device memory as [point][N].
template <int NT, int N>
__device__ __forceinline__ void tc_store_masked(const float (&acc)[kMT][NT][4],
                                                const float* __restrict__ gate,
                                                float* __restrict__ out,
                                                __nv_bfloat16* __restrict__ g, int n_valid,
                                                int n0, int lane) {
  const int gq = lane >> 2, t = lane & 3;
#pragma unroll
  for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int p = 16 * mt + gq + 8 * h, c = n0 + 8 * nt + 2 * t;
        const bool on0 = gate == nullptr || gate[c * kLD + p] > 0.f;
        const bool on1 = gate == nullptr || gate[(c + 1) * kLD + p] > 0.f;
        const float v0 = on0 ? rnd<__nv_bfloat16>(acc[mt][nt][2 * h]) : 0.f;
        const float v1 = on1 ? rnd<__nv_bfloat16>(acc[mt][nt][2 * h + 1]) : 0.f;
        out[c * kLD + p] = v0;
        out[(c + 1) * kLD + p] = v1;
        if (g && p < n_valid)
          *reinterpret_cast<__nv_bfloat162*>(g + (size_t)p * N + c) =
              __floats2bfloat162_rn(v0, v1);
      }
}

// dst[p][c] = src[c][p] for p < n_valid, c < C (C even): a [C][kLD] shared array of bfloat16
// values to device memory as [point][C] rows.
__device__ __forceinline__ void write_rows(__nv_bfloat16* __restrict__ dst,
                                           const float* __restrict__ src, int C, int n_valid) {
  const int C2 = C / 2;
  for (int idx = threadIdx.x; idx < n_valid * C2; idx += kThreads) {
    const int p = idx / C2, c = 2 * (idx % C2);
    *reinterpret_cast<__nv_bfloat162*>(dst + (size_t)p * C + c) =
        __floats2bfloat162_rn(src[c * kLD + p], src[(c + 1) * kLD + p]);
  }
}

// One tile of the forward: encodings, trunk, sigma and feature heads, view layer, rgb head.
// `out` (raw [4, P]) may be null: then the heads are skipped. With `acts`, each trunk
// activation, the feature activation and the view activation of the tile's valid points
// are written in T: layer l (l <= D) row r at acts + l * lstride + (row0 + r) * W, the view
// activation at acts + (D + 1) * lstride + (row0 + r) * W / 2. With `fpart` (this tile's
// sem_tile_slots(S) x W floats), the feature activation summed in float32 over each ray's
// points in the tile, in point order: slot r holds ray tile_first_ray(t, S) + r. The
// semantic head (fused_nerf_sem_head in fused_nerf_fwd.cu) adds a ray's slots in tile order.
template <typename T, int W>
__device__ void forward_tile(const Net& net, const Smem& s, const float* __restrict__ pts,
                             const float* __restrict__ vd, int P, int S, int p0,
                             float* __restrict__ out, T* __restrict__ acts, size_t lstride,
                             size_t row0, float* __restrict__ fpart = nullptr) {
  constexpr int NJ = W / 32;   // trunk / feature columns per thread
  constexpr int NJV = W / 64;  // view-layer columns per thread
  constexpr int WV = W / 2;
  const int e_p = 3 + 6 * net.n_p, e_v = 3 + 6 * net.n_v;
  const int tid = threadIdx.x, ty = tid >> 5, tx = tid & 31;
  const int n_valid = min(kTP, P - p0);
  const int r_lo = p0 / S;
  const int n_rays = (p0 + n_valid - 1) / S - r_lo + 1;
  const T* w = reinterpret_cast<const T*>(net.w);
  const float* b = net.b;
  const int D = net.depth;
  T* arow = acts ? acts + row0 * W : nullptr;

  // The bfloat16 products run on the tensor cores (tc_layer), the float32 ones on FMA (mac).
  constexpr bool kTC = std::is_same<T, __nv_bfloat16>::value;
  const __nv_bfloat16* wp = reinterpret_cast<const __nv_bfloat16*>(net.wp);
  const int ep16 = pad16(e_p);

  encode_tile<T>(s, pts, vd, P, S, p0, n_valid, e_p, e_v);
  __syncthreads();

  // Trunk, ping-ponging between buf0 and buf1.
  float acc[8][NJ];
  const float* h = s.enc;
  for (int l = 0; l < D; ++l) {
    float* dst = (l & 1) ? s.buf1 : s.buf0;
    if constexpr (kTC) {
      const bool skip = l > 0 && ((net.skip_mask >> (l - 1)) & 1);
      const bool enc_first = l == 0 || skip;
      tc_layer<W / 64>(b + net.boff[l], enc_first ? s.enc : h, enc_first ? ep16 : W, h,
                       skip ? W : 0, wp + net.poff[l], dst, true,
                       arow ? arow + l * lstride : nullptr, n_valid);
    } else {
      const T* wl = w + net.woff[l];
      init_acc<NJ>(acc, b + net.boff[l], tx);
      if (l == 0) {
        mac<T, NJ>(acc, s.enc, e_p, wl, W, ty, tx);
      } else if ((net.skip_mask >> (l - 1)) & 1) {
        mac<T, NJ>(acc, s.enc, e_p, wl, W, ty, tx);
        mac<T, NJ>(acc, h, W, wl + (size_t)e_p * W, W, ty, tx);
      } else {
        mac<T, NJ>(acc, h, W, wl, W, ty, tx);
      }
      store<T, NJ>(acc, dst, true, ty, tx, arow ? arow + l * lstride : nullptr, W, n_valid);
    }
    __syncthreads();
    h = dst;
  }
  float* feat = (h == s.buf0) ? s.buf1 : s.buf0;
  float* hbuf = (h == s.buf0) ? s.buf0 : s.buf1;

  if (out) sigma_head<T, W>(net, h, out, P, p0, n_valid);
  // Feature layer (linear).
  if constexpr (kTC) {
    tc_layer<W / 64>(b + net.boff[D + 1], h, W, nullptr, 0, wp + net.poff[D + 1], feat, false,
                     arow ? arow + D * lstride : nullptr, n_valid);
  } else {
    init_acc<NJ>(acc, b + net.boff[D + 1], tx);
    mac<T, NJ>(acc, h, W, w + net.woff[D + 1], W, ty, tx);
    store<T, NJ>(acc, feat, false, ty, tx, arow ? arow + D * lstride : nullptr, W, n_valid);
  }
  __syncthreads();

  if (fpart) sem_partials<W>(feat, fpart, S, p0, n_valid, r_lo, n_rays);

  // Per-ray half of the view layer, once per ray, into the free trunk buffer.
  float* hv = hbuf;                 // [WV][kLD]
  float* hv_ray = hbuf + WV * kLD;  // [n_rays][WV]
  view_ray_half<T, W>(net, s, hv_ray, n_rays, e_v);
  __syncthreads();

  // View layer: feat rows of views_0 per point plus the ray's term.
  if constexpr (kTC) {
    tc_layer<W / 128>(b + net.boff[D + 2], feat, W, nullptr, 0, wp + net.poff[D + 2], hv, true,
                      acts ? acts + (D + 1) * lstride + row0 * WV : nullptr, n_valid, hv_ray, S,
                      p0);
  } else {
    float accv[8][NJV];
    init_acc<NJV>(accv, b + net.boff[D + 2], tx);
    mac<T, NJV>(accv, feat, W, w + net.woff[D + 2], WV, ty, tx);
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int p = min(ty * 8 + i, n_valid - 1);
      const int r = (p0 + p) / S - r_lo;
#pragma unroll
      for (int j = 0; j < NJV; ++j) accv[i][j] += hv_ray[r * WV + tx + 32 * j];
    }
    // hv and hv_ray are disjoint
    store<T, NJV>(accv, hv, true, ty, tx,
                  acts ? acts + (D + 1) * lstride + row0 * WV : nullptr, WV, n_valid);
  }
  __syncthreads();

  if (out) rgb_head<T, W>(net, hv, out, P, p0, n_valid);
}

}  // namespace fnerf
