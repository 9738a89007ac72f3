// Int8 linear of the frozen vision prefix on Hopper (sm_90a): "K5".
//
// Replaces the Pallas TPU kernel of the JAX package:
//   ttl_tpu/ops/quant_matmul.py::_qmm_kernel (quantized_matmul)
// and computes what the JAX int8 path runs, ttl_tpu/ops/quant.py::linear_q
// (the Pallas kernel divides by 127 where linear_q multiplies by 1/127
// rounded to x's dtype; the port follows linear_q):
//   s_t   = max(absmax_k |x_tk|, 1e-12) * (1/127), rounded to x's dtype
//   q_tk  = clip(rint(x_tk / s_t), -127, 127) as int8, x / s in x's dtype
//   acc   = q @ wq, int8 x int8 -> int32
//   y_tn  = fma(f32(acc_tn), s_t * col_scale_n, b_n), cast to x's dtype
// bit for bit as ttl_tpu_torch/ops/quant.py::linear_q_plain. Every step is
// a correctly rounded IEEE operation (__fdiv_rn, __fmul_rn, fmaf,
// __int2float_rn, rintf), so nothing depends on contraction or order: the
// int32 sum is exact.
//
// What bounds it on the H100: at fc1 of the main path, [106496, 768] x
// [768, 3072], 5.0e11 int8 operations take 0.25 ms at the dense int8 peak
// (1,979 TOP/s) and the 0.65 GB bf16 output about 0.2 ms at 3.35 TB/s; the
// product sits near the balance point of both. This first design is
// simple rather than fast: WMMA m16n16k16 int8 tiles (the mma.sync path,
// not wgmma), one shared-memory stage per K step, no TMA. What it does
// about the bounds: the accumulator never leaves the SM (the epilogue
// writes the output once, in x's dtype, where an unfused int8 product
// would write and re-read an int32 [T, N]), and the grid runs the N tiles
// fastest, so the 64-row x tile that every N tile of a row block
// re-quantises is read from L2, not from device memory.
//
// Design: grid (N / 128, T / 64), 256 threads (8 warps, 2 x 4, each a
// 32 x 32 output tile). Pass 1: each warp reduces 8 rows' absmax over K
// with 16-byte loads and forms s exactly as linear_q_plain does. Pass 2,
// per 64-wide K step: the x tile is quantised to int8 while it is staged,
// the wq tile ([K, N], kept in the JAX layout: WMMA's row-major matrix_b
// reads it as it is) is copied in, and each 16-wide slice of either tile
// is stored as its own contiguous block of 16-byte rows, so every WMMA
// operand is 256 contiguous, 32-byte aligned bytes (no bank conflicts).
// Epilogue: the int32 accumulators go through shared memory and each
// thread writes consecutive outputs. Rows past T and K or N past the
// matrix are zero-filled or skipped: no uninitialised memory is read.
//
// C interface (loaded with ctypes): ttl_quant_matmul. The launch goes to
// the caller's stream; the function returns the cudaError_t of the launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>

#include <stdint.h>

namespace {

constexpr int kBM = 64;        // rows (T) per block
constexpr int kBN = 128;       // columns (N) per block
constexpr int kBK = 64;        // K per shared-memory stage
constexpr int kThreads = 256;  // 8 warps: 2 (rows) x 4 (columns)
constexpr int kWarpsN = 4;
constexpr int kLdC = kBN + 4;  // int32 row stride of the epilogue stage

__device__ __forceinline__ float warp_max(float v) {
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

template <typename T> struct Num;

template <> struct Num<float> {
  static constexpr int kVec = 4;  // elements per 16-byte load
  __device__ static void unpack(const uint4& u, float* out) {
    out[0] = __uint_as_float(u.x);
    out[1] = __uint_as_float(u.y);
    out[2] = __uint_as_float(u.z);
    out[3] = __uint_as_float(u.w);
  }
  // max(amax, 1e-12) * (1/127), all in f32
  __device__ static float row_scale(float amax) {
    return __fmul_rn(fmaxf(amax, 1e-12f), 1.0f / 127.0f);
  }
  __device__ static float quotient(float x, float s) {
    return __fdiv_rn(x, s);
  }
  __device__ static float store(float v) { return v; }
};

__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

template <> struct Num<__nv_bfloat16> {
  static constexpr int kVec = 8;
  __device__ static void unpack(const uint4& u, float* out) {
    const unsigned w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      out[2 * i] = __uint_as_float(w[i] << 16);
      out[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
    }
  }
  // bf16(max(amax, bf16(1e-12)) * bf16(1/127)): the product of two bf16
  // values is exact in f32, so one rounding gives bf16 multiplication
  __device__ static float row_scale(float amax) {
    return round_bf16(__fmul_rn(fmaxf(amax, round_bf16(1e-12f)),
                                round_bf16(1.0f / 127.0f)));
  }
  // f32 division, then one rounding to bf16: the correctly rounded bf16
  // quotient, as 24 >= 2 * 8 + 2 bits make the double rounding harmless
  __device__ static float quotient(float x, float s) {
    return round_bf16(__fdiv_rn(x, s));
  }
  __device__ static __nv_bfloat16 store(float v) {
    return __float2bfloat16_rn(v);
  }
};

__device__ __forceinline__ signed char code(float q) {
  return static_cast<signed char>(fminf(fmaxf(rintf(q), -127.f), 127.f));
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
qmm_kernel(const T* __restrict__ x, const int8_t* __restrict__ wq,
           const float* __restrict__ col_scale,
           const float* __restrict__ bias, T* __restrict__ y, int rows,
           int K, int N) {
  using namespace nvcuda;
  constexpr int kVec = Num<T>::kVec;
  // one contiguous [rows][16] block per 16-wide slice of each tile
  __shared__ __align__(128) signed char xs[kBK / 16][kBM][16];
  __shared__ __align__(128) signed char ws[kBN / 16][kBK][16];
  __shared__ __align__(128) int cstage[kBM * kLdC];
  __shared__ float s_row[kBM];

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int n0 = blockIdx.x * kBN, t0 = blockIdx.y * kBM;

  // ---- pass 1: the row scales of this block's rows
  for (int r = warp; r < kBM; r += kThreads / 32) {
    const int t = t0 + r;
    float amax = 0.f;
    if (t < rows) {
      const T* xr = x + (size_t)t * K;
      for (int c = lane * kVec; c < K; c += 32 * kVec) {
        float v[kVec];
        Num<T>::unpack(*reinterpret_cast<const uint4*>(xr + c), v);
#pragma unroll
        for (int i = 0; i < kVec; ++i) amax = fmaxf(amax, fabsf(v[i]));
      }
    }
    amax = warp_max(amax);
    if (lane == 0) s_row[r] = Num<T>::row_scale(amax);
  }
  __syncthreads();

  // ---- pass 2: int8 tiles on the tensor cores
  const int wm = warp / kWarpsN, wn = warp % kWarpsN;
  wmma::fragment<wmma::accumulator, 16, 16, 16, int> acc[2][2];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[i][j], 0);

  for (int k0 = 0; k0 < K; k0 += kBK) {
    // x tile [kBM, kBK], quantised while staged
    for (int e = tid; e < kBM * kBK / kVec; e += kThreads) {
      const int r = e / (kBK / kVec), c = (e % (kBK / kVec)) * kVec;
      const int t = t0 + r, k = k0 + c;
      unsigned packed[kVec / 4] = {};
      if (t < rows && k < K) {
        float v[kVec];
        Num<T>::unpack(
            *reinterpret_cast<const uint4*>(x + (size_t)t * K + k), v);
        const float s = s_row[r];
#pragma unroll
        for (int i = 0; i < kVec; ++i)
          packed[i / 4] |= (unsigned)(unsigned char)code(
                               Num<T>::quotient(v[i], s)) << (8 * (i % 4));
      }
      signed char* dst = &xs[c / 16][r][c % 16];
      if constexpr (kVec == 8) {
        *reinterpret_cast<uint2*>(dst) = make_uint2(packed[0], packed[1]);
      } else {
        *reinterpret_cast<unsigned*>(dst) = packed[0];
      }
    }
    // wq tile [kBK, kBN], 16 bytes (16 columns) per copy
    for (int e = tid; e < kBK * kBN / 16; e += kThreads) {
      const int kr = e / (kBN / 16), j = e % (kBN / 16);
      const int k = k0 + kr, n = n0 + j * 16;
      uint4 v = make_uint4(0, 0, 0, 0);
      if (k < K && n < N)
        v = *reinterpret_cast<const uint4*>(wq + (size_t)k * N + n);
      *reinterpret_cast<uint4*>(&ws[j][kr][0]) = v;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, signed char,
                     wmma::row_major> a[2];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, signed char,
                     wmma::row_major> b[2];
#pragma unroll
      for (int i = 0; i < 2; ++i)
        wmma::load_matrix_sync(a[i], &xs[kk][wm * 32 + i * 16][0], 16);
#pragma unroll
      for (int j = 0; j < 2; ++j)
        wmma::load_matrix_sync(b[j], &ws[wn * 2 + j][kk * 16][0], 16);
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j)
          wmma::mma_sync(acc[i][j], a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }

  // ---- epilogue: y = fma(acc, s * col_scale, b) in f32, then x's dtype
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j)
      wmma::store_matrix_sync(
          &cstage[(wm * 32 + i * 16) * kLdC + wn * 32 + j * 16], acc[i][j],
          kLdC, wmma::mem_row_major);
  __syncthreads();
  for (int e = tid; e < kBM * kBN; e += kThreads) {
    const int r = e / kBN, c = e % kBN;
    const int t = t0 + r, n = n0 + c;
    if (t < rows && n < N) {
      const float step = __fmul_rn(s_row[r], col_scale[n]);
      y[(size_t)t * N + n] = Num<T>::store(
          fmaf(__int2float_rn(cstage[r * kLdC + c]), step, bias[n]));
    }
  }
}

template <typename T>
int launch(const void* x, const void* wq, const void* scale, const void* b,
           void* y, int rows, int K, int N, cudaStream_t stream) {
  const dim3 grid((N + kBN - 1) / kBN, (rows + kBM - 1) / kBM);
  if (grid.y > 65535u) return (int)cudaErrorInvalidValue;
  qmm_kernel<T><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const int8_t*>(wq),
      static_cast<const float*>(scale), static_cast<const float*>(b),
      static_cast<T*>(y), rows, K, N);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// x [rows, K] (dtype 0: f32, 1: bf16), wq [K, N] int8, scale and b [N] f32,
// y [rows, N] in x's dtype; K and N multiples of 16, every pointer 16-byte
// aligned (the wrapper checks both).
int ttl_quant_matmul(const void* x, const void* wq, const void* scale,
                     const void* b, void* y, int dtype, int rows, int K,
                     int N, void* stream) {
  auto st = static_cast<cudaStream_t>(stream);
  if (K % 16 || N % 16 || rows <= 0) return (int)cudaErrorInvalidValue;
  if (dtype == 0) return launch<float>(x, wq, scale, b, y, rows, K, N, st);
  if (dtype == 1)
    return launch<__nv_bfloat16>(x, wq, scale, b, y, rows, K, N, st);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
