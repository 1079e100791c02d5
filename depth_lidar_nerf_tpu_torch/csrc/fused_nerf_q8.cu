// W8A8 serving forward for Hopper (sm_90a): kernel 10 and, with the per-tile semantic
// partial sums, kernel 11's trunk.
//
// Kernel 10 replaces the Pallas TPU kernel depth_lidar_nerf_tpu/ops/fused_mlp_t.py:_fwd_kernel_q8
// (body _forward_tile_q8, entry _fwd_impl_q8); kernel 11 replaces _fwd_kernel_q8_sem (entry
// _fwd_impl_q8_sem), whose head runs in fused_nerf_fwd.cu's fused_nerf_sem_head kernel on the
// partial sums written here, as for kernel 6. The network is kernel 1's (fused_nerf_fwd.cu),
// with the wide products in int8: for each point and each of trunk layers 1..D-1, the feature
// layer and the feature half of the view layer, with the point's input row h (W values, already
// rounded to T),
//   m   = max_c |h_c|,   r = 127 / max(m, 1e-30),   q_c = rint(h_c r)        (int8, per point)
//   acc = sum_c q_c Wq[c, n]                                                (exact, int32)
//   y_n = acc * ((m * (1/127)) * s_n)                                       (float32)
// where Wq and the column scales s are the int8 weights of JAX _quant_cols (made on the host,
// ops/fused_mlp_t.py:pack_params_q8). Then, as _forward_tile_q8 orders it: a trunk layer adds
// its bias and then, after a live skip, the encoding product enc W_l[:e_p] in T; the feature
// layer adds its bias; the view layer adds the ray's term and then its bias. ReLU and the
// rounding to T follow as in kernel 1. The first layer, the skip products, the sigma and rgb
// heads and the view layer's per-ray half stay in T with float32 sums: they are kernel 1's
// code (fused_nerf.cuh). Every rounding step of the quantization is IEEE: the division 127 / m
// is a true division (no --use_fast_math), q uses __float2int_rn (half to even, as jnp.round),
// and the dequantization is written with __fmul_rn/__fadd_rn so that nvcc cannot contract it
// into an FMA that JAX's arithmetic lacks.
//
// Bound on the H100: operations. A point costs ~(D + 1/2) W^2 int8 multiply-adds and
// ~(e_p (1 + skips) + W + 3 W / 2) W multiply-adds in T against 28 bytes of input and output.
// This first version forms the int8 products with __dp4a on the CUDA cores (4 multiply-adds
// an instruction, exact int32 sums), not with the tensor cores (mma.sync s8 or wgmma), so it
// reaches neither bound; what it does about the bound: the activations stay in shared memory,
// a tile's quantized activation is packed 4 along K into one int32 so that one shared load
// feeds a dp4a, each thread keeps an 8-point x (W/32)-column register tile so that each
// weight word it loads feeds 8 dp4a, and the int8 weights (a quarter of kernel 1's bytes in
// float32, half in bfloat16) stay in L2.
//
// Layout. One block of 256 threads owns a tile of kTP = 64 consecutive points (kernel 1's
// tile walk, a ragged last tile masked); the shared memory is kernel 1's plus the quantized
// activation [W/4][kLD] int32 and per-point scale scratch. The results depend only on the
// point (the activation scale is per point), so a render does not depend on the tiling.

#include "fused_nerf.cuh"

namespace {

using namespace fnerf;

constexpr float kInv127 = (float)(1.0 / 127.0);

// The int8 weights: layer j (trunk_1..trunk_{D-1}, feature, views_0's feature rows) as
// [K/4][N] int32 words of 4 int8 along K (byte e = row 4 k + e), at qoff[j] words into wq; its
// column scales are row j of sc [pad8(D+1)][W] (float32; the view layer uses W/2 of its row).
struct NetQ8 {
  const int* wq;
  const float* sc;
  int qoff[kMaxLayers];
};

// Extra shared memory (floats) past the forward's: the packed activation [W/4][kLD] int32,
// the 4 x kTP partial maxima, 127 / m and m * (1/127) per point.
__host__ __device__ inline size_t q8_smem_floats(int W) {
  return (size_t)(W / 4) * kLD + (size_t)6 * kTP;
}

static_assert(kThreads == 4 * kTP, "quantize_tile splits each row across 4 threads");

// JAX _qdot's activation quantization of the tile h [K][kLD] (values of T): per point p,
// m = max_c |h[c][p]|, then qa[k4][p] packs rint(h[4 k4 + e][p] * (127 / max(m, 1e-30))),
// e = 0..3, and ms[p] = m * (1/127). Ends with a barrier.
template <int K>
__device__ __forceinline__ void quantize_tile(const float* __restrict__ h, int* __restrict__ qa,
                                              float* __restrict__ red, float* __restrict__ ms) {
  const int tid = threadIdx.x;
  const int p = tid % kTP, part = tid / kTP;
  float mx = 0.f;
  for (int c = part; c < K; c += 4) mx = fmaxf(mx, fabsf(h[c * kLD + p]));
  red[part * kTP + p] = mx;
  __syncthreads();
  float* r = red + 4 * kTP;
  if (tid < kTP) {
    const float m = fmaxf(fmaxf(red[tid], red[kTP + tid]),
                          fmaxf(red[2 * kTP + tid], red[3 * kTP + tid]));
    r[tid] = 127.f / fmaxf(m, 1e-30f);
    ms[tid] = __fmul_rn(m, kInv127);
  }
  __syncthreads();
  for (int idx = tid; idx < (K / 4) * kTP; idx += kThreads) {
    const int k4 = idx / kTP, pp = idx % kTP;
    const float rr = r[pp];
    unsigned word = 0;
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int qv = __float2int_rn(__fmul_rn(h[(4 * k4 + e) * kLD + pp], rr));
      word |= (unsigned)(qv & 0xff) << (8 * e);
    }
    qa[k4 * kLD + pp] = (int)word;
  }
  __syncthreads();
}

// acc[i][j] = sum over k4 of dp4a(qa[k4][8 ty + i], wq[k4 * ld + tx + 32 j]): the exact int32
// product of the point's int8 row with the weight column.
template <int NJ>
__device__ __forceinline__ void mac_q8(int (&acc)[8][NJ], const int* __restrict__ qa, int K4,
                                       const int* __restrict__ wq, int ld, int ty, int tx) {
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < NJ; ++j) acc[i][j] = 0;
  const int* a_ptr = qa + ty * 8;
  const int* w_ptr = wq + tx;
#pragma unroll 2
  for (int k = 0; k < K4; ++k) {
    const int4 a0 = *reinterpret_cast<const int4*>(a_ptr + k * kLD);
    const int4 a1 = *reinterpret_cast<const int4*>(a_ptr + k * kLD + 4);
    const int a[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
    int wv[NJ];
#pragma unroll
    for (int j = 0; j < NJ; ++j) wv[j] = __ldg(w_ptr + (size_t)k * ld + 32 * j);
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < NJ; ++j) acc[i][j] = __dp4a(a[i], wv[j], acc[i][j]);
  }
}

__device__ __forceinline__ float dequant(int acc, float ms, float s) {
  return __fmul_rn(__int2float_rn(acc), __fmul_rn(ms, s));
}

// A trunk or feature layer's epilogue: (dequant + bias) [+ post[c][p]], ReLU if asked, rounded
// to T, stored transposed into `out`. `post` may be `out` itself (each element is read before
// it is written, by the same thread), so neither is __restrict__.
template <typename T, int NJ>
__device__ __forceinline__ void store_q8(const int (&acc)[8][NJ], const float* __restrict__ ms,
                                         const float* __restrict__ sc,
                                         const float* __restrict__ bias, const float* post,
                                         float* out, bool relu, int ty, int tx) {
#pragma unroll
  for (int j = 0; j < NJ; ++j) {
    const int c = tx + 32 * j;
    const float s = sc[c], bj = bias[c];
    float v[8];
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int p = ty * 8 + i;
      float x = __fadd_rn(dequant(acc[i][j], ms[p], s), bj);
      if (post) x = __fadd_rn(x, post[c * kLD + p]);
      v[i] = rnd<T>(relu ? fmaxf(x, 0.f) : x);
    }
    float4* dst = reinterpret_cast<float4*>(out + c * kLD + ty * 8);
    dst[0] = make_float4(v[0], v[1], v[2], v[3]);
    dst[1] = make_float4(v[4], v[5], v[6], v[7]);
  }
}

// The skip product enc W_l[:e_p] (T operands, float32 sums), unrounded, into out [W][kLD].
template <typename T, int NJ>
__device__ __forceinline__ void skip_product(const Smem& s, int e_p, const T* __restrict__ wl,
                                             int W, float* __restrict__ out, int ty, int tx) {
  float acc[8][NJ];
  init_acc<NJ>(acc, nullptr, tx);
  mac<T, NJ>(acc, s.enc, e_p, wl, W, ty, tx);
#pragma unroll
  for (int j = 0; j < NJ; ++j) {
    float4* dst = reinterpret_cast<float4*>(out + (tx + 32 * j) * kLD + ty * 8);
    dst[0] = make_float4(acc[0][j], acc[1][j], acc[2][j], acc[3][j]);
    dst[1] = make_float4(acc[4][j], acc[5][j], acc[6][j], acc[7][j]);
  }
}

// One tile of the int8 forward (see the source note). `fpart` as forward_tile's.
template <typename T, int W>
__device__ void forward_tile_q8(const Net& net, const NetQ8& q, const Smem& s,
                                int* __restrict__ qa, float* __restrict__ red,
                                float* __restrict__ ms, const float* __restrict__ pts,
                                const float* __restrict__ vd, int P, int S, int p0,
                                float* __restrict__ out, float* __restrict__ fpart) {
  constexpr int NJ = W / 32, NJV = W / 64, WV = W / 2;
  const int e_p = 3 + 6 * net.n_p, e_v = 3 + 6 * net.n_v;
  const int tid = threadIdx.x, ty = tid >> 5, tx = tid & 31;
  const int n_valid = min(kTP, P - p0);
  const int r_lo = p0 / S;
  const int n_rays = (p0 + n_valid - 1) / S - r_lo + 1;
  const T* w = reinterpret_cast<const T*>(net.w);
  const float* b = net.b;
  const int D = net.depth;

  encode_tile<T>(s, pts, vd, P, S, p0, n_valid, e_p, e_v);
  __syncthreads();

  // First layer in T, as kernel 1.
  {
    float acc[8][NJ];
    init_acc<NJ>(acc, b + net.boff[0], tx);
    mac<T, NJ>(acc, s.enc, e_p, w + net.woff[0], W, ty, tx);
    store<T, NJ>(acc, s.buf0, true, ty, tx);
  }
  __syncthreads();

  // Trunk layers 1..D-1 in int8, ping-ponging between buf0 and buf1. A live skip's encoding
  // product is parked in the destination buffer, which each thread then reads back for the
  // same elements it wrote.
  float* h = s.buf0;
  int acc[8][NJ];
  for (int l = 1; l < D; ++l) {
    float* dst = (h == s.buf0) ? s.buf1 : s.buf0;
    const bool skip = (net.skip_mask >> (l - 1)) & 1;
    if (skip) skip_product<T, NJ>(s, e_p, w + net.woff[l], W, dst, ty, tx);
    quantize_tile<W>(h, qa, red, ms);
    mac_q8<NJ>(acc, qa, W / 4, q.wq + q.qoff[l - 1], W, ty, tx);
    store_q8<T, NJ>(acc, ms, q.sc + (size_t)(l - 1) * W, b + net.boff[l], skip ? dst : nullptr,
                    dst, true, ty, tx);
    __syncthreads();
    h = dst;
  }
  float* feat = (h == s.buf0) ? s.buf1 : s.buf0;
  float* hbuf = h;

  if (out) sigma_head<T, W>(net, h, out, P, p0, n_valid);
  // Feature layer (linear) in int8.
  quantize_tile<W>(h, qa, red, ms);
  mac_q8<NJ>(acc, qa, W / 4, q.wq + q.qoff[D - 1], W, ty, tx);
  store_q8<T, NJ>(acc, ms, q.sc + (size_t)(D - 1) * W, b + net.boff[D + 1], nullptr, feat, false,
                  ty, tx);
  __syncthreads();

  if (fpart) sem_partials<W>(feat, fpart, S, p0, n_valid, r_lo, n_rays);

  // Per-ray half of the view layer (T), once per ray, into the free trunk buffer.
  float* hv = hbuf;                 // [WV][kLD]
  float* hv_ray = hbuf + WV * kLD;  // [n_rays][WV]
  view_ray_half<T, W>(net, s, hv_ray, n_rays, e_v);
  // View layer: the feature half in int8, then the ray's term, then the bias (the barriers
  // of quantize_tile also publish hv_ray).
  quantize_tile<W>(feat, qa, red, ms);
  {
    int accv[8][NJV];
    mac_q8<NJV>(accv, qa, W / 4, q.wq + q.qoff[D], WV, ty, tx);
    const float* sv = q.sc + (size_t)D * W;
    const float* bv = b + net.boff[D + 2];
#pragma unroll
    for (int j = 0; j < NJV; ++j) {
      const int c = tx + 32 * j;
      float v[8];
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const int p = ty * 8 + i;
        const int r = (p0 + min(p, n_valid - 1)) / S - r_lo;
        const float x = __fadd_rn(__fadd_rn(dequant(accv[i][j], ms[p], sv[c]),
                                            hv_ray[r * WV + c]), bv[c]);
        v[i] = rnd<T>(fmaxf(x, 0.f));
      }
      float4* dst = reinterpret_cast<float4*>(hv + c * kLD + ty * 8);
      dst[0] = make_float4(v[0], v[1], v[2], v[3]);
      dst[1] = make_float4(v[4], v[5], v[6], v[7]);
    }
  }
  __syncthreads();

  if (out) rgb_head<T, W>(net, hv, out, P, p0, n_valid);
}

// Kernel 10 (fpart null) and kernel 11's trunk (fpart: MR x W floats a tile).
template <typename T, int W>
__global__ void __launch_bounds__(kThreads, 1)
    fused_nerf_q8_kernel(const Net net, const NetQ8 q, const float* __restrict__ pts,
                         const float* __restrict__ vd, float* __restrict__ out,
                         float* __restrict__ fpart, int MR, int P, int S) {
  extern __shared__ __align__(16) float smem[];
  const int e_p = 3 + 6 * net.n_p, e_v = 3 + 6 * net.n_v;
  const Smem s = carve(smem, W, e_p, e_v);
  float* tail = smem + fwd_smem_floats(W, e_p, e_v);
  int* qa = reinterpret_cast<int*>(tail);
  float* red = tail + (W / 4) * kLD;  // [4][kTP] partial maxima, then [kTP] 127 / m
  float* ms = red + 5 * kTP;
  forward_tile_q8<T, W>(net, q, s, qa, red, ms, pts, vd, P, S, blockIdx.x * kTP, out,
                        fpart ? fpart + (size_t)blockIdx.x * MR * W : nullptr);
}

template <typename T, int W>
int launch(const Net& net, const NetQ8& q, const float* pts, const float* vd, float* out,
           float* fpart, int MR, int P, int S, cudaStream_t stream) {
  const size_t smem = sizeof(float) * (fwd_smem_floats(W, 3 + 6 * net.n_p, 3 + 6 * net.n_v) +
                                       q8_smem_floats(W));
  auto k = fused_nerf_q8_kernel<T, W>;
  cudaError_t e = cudaFuncSetAttribute(k, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  k<<<(P + kTP - 1) / kTP, kThreads, smem, stream>>>(net, q, pts, vd, out, fpart, MR, P, S);
  return (int)cudaGetLastError();
}

}  // namespace

// Kernel 10 (fpart null) or kernel 11's trunk (fpart: ceil(P / 64) x MR x W floats with
// MR >= sem_tile_slots(S), for S with sem_aligned(S)). Returns a cudaError_t (0 on success).
// w, b, woff and boff are kernel 1's packed weights (fused_nerf_fwd.cu); wq, sc and qoff (host
// array of depth + 1 word offsets) the int8 layers of NetQ8.
extern "C" int fused_nerf_q8_launch(const float* pts, const float* vd, const void* w,
                                    const float* b, const int* wq, const float* sc, float* out,
                                    float* fpart, int MR, int P, int S, int depth, int width,
                                    int n_p, int n_v, int skip_mask, int is_bf16,
                                    const int* woff, const int* boff, const int* qoff,
                                    void* stream) {
  if (depth < 1 || depth > 8 || S < 1 || P % S != 0 || (width != 128 && width != 256) ||
      (fpart != nullptr && (!sem_aligned(S) || MR < sem_tile_slots(S))))
    return (int)cudaErrorInvalidValue;
  if (P == 0) return 0;
  Net net;
  net.w = w; net.wt = nullptr; net.b = b;
  net.depth = depth; net.n_p = n_p; net.n_v = n_v; net.skip_mask = skip_mask;
  NetQ8 q;
  q.wq = wq; q.sc = sc;
  for (int i = 0; i < kMaxLayers; ++i) {
    net.woff[i] = i < depth + 4 ? woff[i] : 0;
    net.boff[i] = i < depth + 4 ? boff[i] : 0;
    q.qoff[i] = i < depth + 1 ? qoff[i] : 0;
  }
  cudaStream_t s = (cudaStream_t)stream;
  if (is_bf16) {
    return width == 256 ? launch<__nv_bfloat16, 256>(net, q, pts, vd, out, fpart, MR, P, S, s)
                        : launch<__nv_bfloat16, 128>(net, q, pts, vd, out, fpart, MR, P, S, s);
  }
  return width == 256 ? launch<float, 256>(net, q, pts, vd, out, fpart, MR, P, S, s)
                      : launch<float, 128>(net, q, pts, vd, out, fpart, MR, P, S, s);
}

extern "C" const char* fused_nerf_q8_error_string(int e) {
  return cudaGetErrorString((cudaError_t)e);
}
