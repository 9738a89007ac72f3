// Layernorm over the last axis, forward and the gradient with respect to x.
//
// For x [M, K] and the layernorm's scale and bias [K] (f32):
//
//   forward   mu_m   = mean_k x_mk,  rstd_m = rsqrt(mean_k (x_mk - mu_m)^2
//                      + eps)                                   (f32)
//                      (with `ex2` the variance mean_k x_mk^2 - mu_m^2,
//                      floored at 0)
//             y_mk   = ((x_mk - mu_m) * rstd_m) * scale_k + bias_k, each
//                      operation rounded on its own (layer_norm.cuh), then
//                      once to x's dtype; mu and rstd stored where asked
//   backward  g_mk   = dy_mk * scale_k,  xh_mk = (x_mk - mu_m) * rstd_m
//             dx_mk  = rstd_m * (g_mk - mean_k g_mk - xh_mk * mean_k g_mk
//                      xh_mk)                     (f32, rounded once)
//
// the function of models/clip.py::layer_norm (in either TTL_LN_STATS mode)
// and of its gradient with respect to x, which is the same in both; scale
// and bias take none on any path.
//
// RMS statistics (stats code 2; AIMv2's RMSNorm, models/aimv2.py): mu is
// taken as 0 and there is no bias,
//   forward   rstd_m = rsqrt(mean_k x_mk^2 + eps),  y_mk = (x_mk * rstd_m)
//                      * scale_k                (rounded apart, then to T)
//   backward  dx_mk  = rstd_m * (g_mk - xh_mk * mean_k g_mk xh_mk),
//                      xh_mk = x_mk * rstd_m
// in kernels of their own names (rms_norm_fwd_kernel, rms_norm_bwd_kernel),
// instances of the same bodies with the mean's sweep and term left out, so
// that a trace tells their time apart. They take the full width only.
//
// A logical width n <= K: the statistics, the backward's two means and
// the division by the width run over the first n columns of each row, and
// y and dx are 0 in the n..K-1 past them, which are never read. EVA02 on
// the card stores its 2730-wide SwiGLU hidden on a 2736-wide row (16-byte
// strides for the products around it, models/eva02.py::card_layout) and
// normalises the 2730. The route is chosen by K, the row length; n < K
// takes the masked instance of the same route, n = K the unmasked one,
// which reads no n.
//
// It replaces no TPU kernel: the JAX package leaves its layernorms to XLA,
// which fuses each into one pass. PyTorch runs the plain version as ten
// elementwise and reduction passes over the row in f32 (about 68 bytes moved
// an element where one pass moves 4 in bf16), and its autograd backward
// keeps two f32 copies of the centered input. Bound: bytes. The forward
// reads x and writes y, the backward reads x and dy and writes dx, with a
// few operations a byte, far below the card's ~295 FLOP a byte.
//
// Design: each row is read from device memory once and held in registers
// from the load to the store. Up to K = 1024 one warp takes a row (four rows
// a block of 128 threads) and reduces by shuffles alone; past it, up to
// kMaxK = 4096, a block of 128 threads takes a row and its four warps meet
// in shared memory. Each thread moves a pair of neighbouring columns with one
// access (__nv_bfloat162 or float2): rows of even K start on boundaries of
// the pair's size, and EVA02's 2730-wide rows (5460 bytes) on no wider one.
// kPer pairs a thread, the fewest of {4, 8, 12, 16} that cover the row, so
// that the loads of a row are in flight together. The statistics and the
// backward's two means are reduced in a fixed order, so a call gives the
// same bits every time.
//
// C interface (loaded with ctypes): ttl_layer_norm_fwd and
// ttl_layer_norm_bwd, on the caller's stream; each returns the cudaError_t
// of its launch, cudaErrorInvalidValue for an odd K, one past kMaxK
// (ops/layer_norm.py's MAX_K), a logical width n outside [1, K], an
// unknown stats code or RMS statistics over n < K, and
// cudaErrorMisalignedAddress for a row pointer not on a pair boundary.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <stddef.h>
#include <stdint.h>

#include "layer_norm.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kWarpMaxK = 1024;  // one warp a row up to this width
constexpr int kMaxK = 4096;

// a pair of neighbouring columns of T as two f32 values
template <typename T> struct Pair;

template <> struct Pair<float> {
  using V = float2;
  __device__ static float2 load(const V* p) { return *p; }
  __device__ static V pack(float a, float b) { return make_float2(a, b); }
};

template <> struct Pair<__nv_bfloat16> {
  using V = __nv_bfloat162;
  __device__ static float2 load(const V* p) { return __bfloat1622float2(*p); }
  __device__ static V pack(float a, float b) {
    return __floats2bfloat162_rn(a, b);
  }
};

// the sum of v over the row's kRowThreads threads, the same in each; a
// block-wide row meets in red (one slot a warp)
template <int kRowThreads>
__device__ __forceinline__ float row_sum(float v, float* red) {
  v = warp_sum(v);
  if constexpr (kRowThreads == 32) {
    return v;
  } else {
    if (threadIdx.x % 32 == 0) red[threadIdx.x / 32] = v;
    __syncthreads();
    float s = 0.f;
#pragma unroll
    for (int w = 0; w < kRowThreads / 32; ++w) s += red[w];
    __syncthreads();  // red is free again for the next sum
    return s;
  }
}

// two sums at once (the backward's)
template <int kRowThreads>
__device__ __forceinline__ float2 row_sum2(float a, float b, float2* red) {
  a = warp_sum(a);
  b = warp_sum(b);
  if constexpr (kRowThreads == 32) {
    return make_float2(a, b);
  } else {
    if (threadIdx.x % 32 == 0) red[threadIdx.x / 32] = make_float2(a, b);
    __syncthreads();
    float2 s = make_float2(0.f, 0.f);
#pragma unroll
    for (int w = 0; w < kRowThreads / 32; ++w) {
      s.x += red[w].x;
      s.y += red[w].y;
    }
    return s;
  }
}

// kRowThreads threads a row (32: a warp, kThreads: the block), kPer pairs a
// thread: thread t of a row holds pairs t, t + kRowThreads, ...
// kMasked: the logical width n < k (see the top); else n is not read.
// kRms: RMS statistics (mu 0, no bias; bias and ex2 are not read)
template <typename T, int kRowThreads, int kPer, bool kMasked, bool kRms>
__device__ __forceinline__ void fwd_rows(const T* __restrict__ x,
                                         const float* __restrict__ scale,
                                         const float* __restrict__ bias,
                                         T* __restrict__ y,
                                         float* __restrict__ mu_out,
                                         float* __restrict__ rstd_out,
                                         long long rows, int k, int n,
                                         float eps, bool ex2) {
  static_assert(!(kMasked && kRms), "RMS statistics take the full width");
  using P = Pair<T>;
  __shared__ float red[kThreads / 32];
  const long long r = (long long)blockIdx.x * (kThreads / kRowThreads) +
                      threadIdx.x / kRowThreads;
  if (r >= rows) return;  // a warp's row past the end; never a block's
  const int t = threadIdx.x % kRowThreads, half = k / 2;
  // the pairs that hold a logical column; with an odd n the last holds one
  const int live = kMasked ? (n + 1) / 2 : half;
  const typename P::V* xr = reinterpret_cast<const typename P::V*>(x) +
                            r * half;
  float2 v[kPer];
  float s = 0.f, q = 0.f;
#pragma unroll
  for (int i = 0; i < kPer; ++i) {
    const int j = t + i * kRowThreads;
    v[i] = j < live ? P::load(xr + j) : make_float2(0.f, 0.f);
    if (kMasked && 2 * j + 1 >= n) v[i].y = 0.f;
    s += v[i].x + v[i].y;
    // RMS: the squares in the loads' own loop, which keeps a row's loads in
    // flight together; in a second loop after them ptxas spread the loads
    // out and the forward ran 25 % slower on an H100
    if (kRms) q += v[i].x * v[i].x + v[i].y * v[i].y;
  }
  const float kf = (float)(kMasked ? n : k);
  const float mu = kRms ? 0.f : ln_mean(row_sum<kRowThreads>(s, red), kf);
  // the squared deviations from mu, or with ex2 the squares
  const float c = ex2 ? 0.f : mu;
#pragma unroll
  for (int i = 0; i < kPer && !kRms; ++i) {
    const int j = t + i * kRowThreads;
    if (j < live) {
      const float d0 = v[i].x - c;
      const float d1 = kMasked && 2 * j + 1 >= n ? 0.f : v[i].y - c;
      q += d0 * d0 + d1 * d1;
    }
  }
  const float sq = row_sum<kRowThreads>(q, red);
  const float rstd = ex2 && !kRms ? ln_rstd_ex2(sq, mu, kf, eps)
                                  : ln_rstd(sq, kf, eps);
  typename P::V* yr = reinterpret_cast<typename P::V*>(y) + r * half;
#pragma unroll
  for (int i = 0; i < kPer; ++i) {
    const int j = t + i * kRowThreads;
    if (kRms && j < live)
      yr[j] = P::pack(rms_affine(v[i].x, rstd, __ldg(scale + 2 * j)),
                      rms_affine(v[i].y, rstd, __ldg(scale + 2 * j + 1)));
    else if (j < live)
      yr[j] = P::pack(
          ln_affine(v[i].x, mu, rstd, __ldg(scale + 2 * j),
                    __ldg(bias + 2 * j)),
          kMasked && 2 * j + 1 >= n
              ? 0.f
              : ln_affine(v[i].y, mu, rstd, __ldg(scale + 2 * j + 1),
                          __ldg(bias + 2 * j + 1)));
    else if (kMasked && j < half)
      yr[j] = P::pack(0.f, 0.f);
  }
  if (mu_out != nullptr && t == 0) {
    mu_out[r] = mu;
    rstd_out[r] = rstd;
  }
}

// kRms: the RMS statistics' gradient, without the mean's term (mu_in is
// not read)
template <typename T, int kRowThreads, int kPer, bool kMasked, bool kRms>
__device__ __forceinline__ void bwd_rows(const T* __restrict__ x,
                                         const T* __restrict__ dy,
                                         const float* __restrict__ scale,
                                         const float* __restrict__ mu_in,
                                         const float* __restrict__ rstd_in,
                                         T* __restrict__ dx, long long rows,
                                         int k, int n) {
  static_assert(!(kMasked && kRms), "RMS statistics take the full width");
  using P = Pair<T>;
  __shared__ float2 red[kThreads / 32];
  const long long r = (long long)blockIdx.x * (kThreads / kRowThreads) +
                      threadIdx.x / kRowThreads;
  if (r >= rows) return;
  const int t = threadIdx.x % kRowThreads, half = k / 2;
  const int live = kMasked ? (n + 1) / 2 : half;
  const typename P::V* xr = reinterpret_cast<const typename P::V*>(x) +
                            r * half;
  const typename P::V* dr = reinterpret_cast<const typename P::V*>(dy) +
                            r * half;
  const float mu = kRms ? 0.f : mu_in[r], rstd = rstd_in[r];
  // xh and g in place of x and dy
  float2 xh[kPer], g[kPer];
  float sg = 0.f, sgx = 0.f;
#pragma unroll
  for (int i = 0; i < kPer; ++i) {
    const int j = t + i * kRowThreads;
    if (kRms) {
      // RMS: loads selected, not branched over, so that a row's loads issue
      // together; under the branch, without the mean's sum, ptxas issued
      // them one by one and dx ran 1.6x slower on an H100
      xh[i] = j < live ? P::load(xr + j) : make_float2(0.f, 0.f);
      g[i] = j < live ? P::load(dr + j) : make_float2(0.f, 0.f);
    } else if (j < live) {
      xh[i] = P::load(xr + j);
      g[i] = P::load(dr + j);
    }
  }
#pragma unroll
  for (int i = 0; i < kPer; ++i) {
    const int j = t + i * kRowThreads;
    if (j < live) {
      xh[i].x = (xh[i].x - mu) * rstd;
      xh[i].y = (xh[i].y - mu) * rstd;
      g[i].x *= __ldg(scale + 2 * j);
      g[i].y *= __ldg(scale + 2 * j + 1);
      if (kMasked && 2 * j + 1 >= n) xh[i].y = g[i].y = 0.f;
      sg += g[i].x + g[i].y;
      sgx += g[i].x * xh[i].x + g[i].y * xh[i].y;
    }
  }
  const float kf = (float)(kMasked ? n : k);
  const float2 sums = row_sum2<kRowThreads>(sg, sgx, red);
  const float mg = kRms ? 0.f : __fdiv_rn(sums.x, kf);
  const float mgx = __fdiv_rn(sums.y, kf);
  typename P::V* out = reinterpret_cast<typename P::V*>(dx) + r * half;
#pragma unroll
  for (int i = 0; i < kPer; ++i) {
    const int j = t + i * kRowThreads;
    if (kRms && j < live)
      out[j] = P::pack(rstd * (g[i].x - xh[i].x * mgx),
                       rstd * (g[i].y - xh[i].y * mgx));
    else if (j < live)
      out[j] = P::pack(rstd * (g[i].x - mg - xh[i].x * mgx),
                       kMasked && 2 * j + 1 >= n
                           ? 0.f
                           : rstd * (g[i].y - mg - xh[i].y * mgx));
    else if (kMasked && j < half)
      out[j] = P::pack(0.f, 0.f);
  }
}

// The kernels: the layernorm's (centered or ex2 statistics) and the RMS
// statistics', each an instance of the bodies above under its own name
template <typename T, int kRowThreads, int kPer, bool kMasked>
__global__ void __launch_bounds__(kThreads)
layer_norm_fwd_kernel(const T* __restrict__ x,
                      const float* __restrict__ scale,
                      const float* __restrict__ bias, T* __restrict__ y,
                      float* __restrict__ mu_out,
                      float* __restrict__ rstd_out, long long rows, int k,
                      int n, float eps, bool ex2) {
  fwd_rows<T, kRowThreads, kPer, kMasked, false>(x, scale, bias, y, mu_out,
                                                 rstd_out, rows, k, n, eps,
                                                 ex2);
}

template <typename T, int kRowThreads, int kPer>
__global__ void __launch_bounds__(kThreads)
rms_norm_fwd_kernel(const T* __restrict__ x, const float* __restrict__ scale,
                    T* __restrict__ y, float* __restrict__ mu_out,
                    float* __restrict__ rstd_out, long long rows, int k,
                    float eps) {
  fwd_rows<T, kRowThreads, kPer, false, true>(x, scale, nullptr, y, mu_out,
                                              rstd_out, rows, k, k, eps,
                                              false);
}

template <typename T, int kRowThreads, int kPer, bool kMasked>
__global__ void __launch_bounds__(kThreads)
layer_norm_bwd_kernel(const T* __restrict__ x, const T* __restrict__ dy,
                      const float* __restrict__ scale,
                      const float* __restrict__ mu_in,
                      const float* __restrict__ rstd_in, T* __restrict__ dx,
                      long long rows, int k, int n) {
  bwd_rows<T, kRowThreads, kPer, kMasked, false>(x, dy, scale, mu_in,
                                                 rstd_in, dx, rows, k, n);
}

template <typename T, int kRowThreads, int kPer>
__global__ void __launch_bounds__(kThreads)
rms_norm_bwd_kernel(const T* __restrict__ x, const T* __restrict__ dy,
                    const float* __restrict__ scale,
                    const float* __restrict__ rstd_in, T* __restrict__ dx,
                    long long rows, int k) {
  bwd_rows<T, kRowThreads, kPer, false, true>(x, dy, scale, nullptr, rstd_in,
                                              dx, rows, k, k);
}

// The route for width k: (threads a row, pairs a thread) -> the launch of
// Launch::run<T, kRowThreads, kPer>(grid) on the rows
template <typename T, typename Launch>
int route(long long rows, int k, Launch launch) {
  const int half = k / 2;
  const unsigned warp_grid =
      static_cast<unsigned>((rows + kThreads / 32 - 1) / (kThreads / 32));
  const unsigned block_grid = static_cast<unsigned>(rows);
  if (half <= 32 * 4) {
    launch.template run<T, 32, 4>(warp_grid);
  } else if (half <= 32 * 8) {
    launch.template run<T, 32, 8>(warp_grid);
  } else if (half <= 32 * 12) {
    launch.template run<T, 32, 12>(warp_grid);
  } else if (k <= kWarpMaxK) {
    launch.template run<T, 32, 16>(warp_grid);
  } else if (half <= kThreads * 8) {
    launch.template run<T, kThreads, 8>(block_grid);
  } else if (half <= kThreads * 12) {
    launch.template run<T, kThreads, 12>(block_grid);
  } else {
    launch.template run<T, kThreads, 16>(block_grid);
  }
  return static_cast<int>(cudaGetLastError());
}

struct Fwd {
  const void* x;
  const float *scale, *bias;
  void* y;
  float *mu, *rstd;
  long long rows;
  int k, n;
  float eps;
  bool ex2, rms;
  cudaStream_t s;
  template <typename T, int kRowThreads, int kPer>
  void run(unsigned grid) const {
    if (rms)
      rms_norm_fwd_kernel<T, kRowThreads, kPer><<<grid, kThreads, 0, s>>>(
          static_cast<const T*>(x), scale, static_cast<T*>(y), mu, rstd,
          rows, k, eps);
    else if (n < k)
      layer_norm_fwd_kernel<T, kRowThreads, kPer, true>
          <<<grid, kThreads, 0, s>>>(static_cast<const T*>(x), scale, bias,
                                     static_cast<T*>(y), mu, rstd, rows, k,
                                     n, eps, ex2);
    else
      layer_norm_fwd_kernel<T, kRowThreads, kPer, false>
          <<<grid, kThreads, 0, s>>>(static_cast<const T*>(x), scale, bias,
                                     static_cast<T*>(y), mu, rstd, rows, k,
                                     n, eps, ex2);
  }
};

struct Bwd {
  const void *x, *dy;
  const float *scale, *mu, *rstd;
  void* dx;
  long long rows;
  int k, n;
  bool rms;
  cudaStream_t s;
  template <typename T, int kRowThreads, int kPer>
  void run(unsigned grid) const {
    if (rms)
      rms_norm_bwd_kernel<T, kRowThreads, kPer><<<grid, kThreads, 0, s>>>(
          static_cast<const T*>(x), static_cast<const T*>(dy), scale, rstd,
          static_cast<T*>(dx), rows, k);
    else if (n < k)
      layer_norm_bwd_kernel<T, kRowThreads, kPer, true>
          <<<grid, kThreads, 0, s>>>(static_cast<const T*>(x),
                                     static_cast<const T*>(dy), scale, mu,
                                     rstd, static_cast<T*>(dx), rows, k, n);
    else
      layer_norm_bwd_kernel<T, kRowThreads, kPer, false>
          <<<grid, kThreads, 0, s>>>(static_cast<const T*>(x),
                                     static_cast<const T*>(dy), scale, mu,
                                     rstd, static_cast<T*>(dx), rows, k, n);
  }
};

// the stats codes of the C interface
constexpr int kCentered = 0, kEx2 = 1, kRmsStats = 2;

// 0 where the call fits the kernels, else the error to return
int refuse(int k, int n, int dtype, int stats, const void* a, const void* b,
           const void* c, const void* d) {
  if (k < 2 || k % 2 || k > kMaxK || n < 1 || n > k ||
      (dtype != 0 && dtype != 1) || stats < kCentered || stats > kRmsStats ||
      (stats == kRmsStats && n != k))
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t pair = dtype == 1 ? 4 : 8;
  const size_t any = (size_t)a | (size_t)b | (size_t)c | (size_t)d;
  return any % pair ? static_cast<int>(cudaErrorMisalignedAddress) : 0;
}

}  // namespace

extern "C" {

// x [rows, k] -> y [rows, k] (dtype 0 f32, 1 bf16), normalised over the
// first n <= k columns of each row and 0 past them; scale, bias [k] f32; mu
// and rstd [rows] f32, or both null; stats 0 the centered variance, 1
// E[x^2] - mu^2, 2 RMS statistics (n = k; bias not read, mu written 0)
int ttl_layer_norm_fwd(const void* x, const float* scale, const float* bias,
                       void* y, float* mu, float* rstd, int dtype,
                       long long rows, int k, int n, float eps, int stats,
                       void* stream) {
  if (const int rc = refuse(k, n, dtype, stats, x, y, x, y)) return rc;
  if (rows == 0) return 0;
  const Fwd f{x, scale, bias, y, mu, rstd, rows, k, n, eps,
              stats == kEx2, stats == kRmsStats,
              static_cast<cudaStream_t>(stream)};
  return dtype == 1 ? route<__nv_bfloat16>(rows, k, f)
                    : route<float>(rows, k, f);
}

// x, dy [rows, k] with the forward's mu, rstd [rows] -> dx [rows, k], over
// the first n <= k columns and 0 past them; stats as the forward's (0 and 1
// share one gradient; 2, RMS statistics, does not read mu)
int ttl_layer_norm_bwd(const void* x, const void* dy, const float* scale,
                       const float* mu, const float* rstd, void* dx,
                       int dtype, long long rows, int k, int n, int stats,
                       void* stream) {
  if (const int rc = refuse(k, n, dtype, stats, x, dy, dx, x)) return rc;
  if (rows == 0) return 0;
  const Bwd b{x, dy, scale, mu, rstd, dx, rows, k, n, stats == kRmsStats,
              static_cast<cudaStream_t>(stream)};
  return dtype == 1 ? route<__nv_bfloat16>(rows, k, b)
                    : route<float>(rows, k, b);
}

}  // extern "C"
