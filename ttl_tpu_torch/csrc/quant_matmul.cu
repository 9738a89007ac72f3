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
// product sits near the balance point of both. What the design does about
// it: x is read and quantised once, the accumulators stay in registers, and
// the output is written once, in x's dtype, in 16-byte stores. What holds
// it back: mma.sync reaches a fraction of the int8 rate that wgmma would,
// and a 128 x 128 tile reads one operand byte from L2 for every 128
// operations.
//
// Design: three launches a call, into scratch the caller allocates
// (ttl_quant_matmul_scratch_bytes):
//   (Q) k5_quant_rows_kernel: one warp per row of x, 16-byte loads; the
//       absmax, the row scale s_t (an f32 holding x's rounded value) and
//       the int8 codes xq [T, Kp], Kp = K rounded up to kBK, the tail zero;
//   (W) k5_transpose_w_kernel: wq [K, N] (the JAX layout, kept in the
//       parameters) copied to wt [N, Kp], K-major and zero-padded, since the
//       int8 mma.sync takes both operands K-contiguous and ldmatrix .trans
//       moves 16-bit elements, not bytes; 2.4 MB at fc1;
//   (G) k5_gemm_kernel: block tiles of 128 x 128 outputs, 4 warps as 2 x 2
//       (a warp's tile 64 x 64: 128 int32 accumulators in registers), a
//       3-stage cp.async ring of 128-byte K slices of xq and wt (rows padded
//       by 16 bytes against ldmatrix bank conflicts, 108 KB, two blocks an
//       SM, one barrier a slice), ldmatrix_x4 on both operands feeding
//       mma.sync m16n8k32 s8. Epilogue: each lane forms its outputs with the
//       steps above, rounds once, and stages them in shared memory, from
//       where the block writes whole rows in 16-byte stores. The grid runs
//       the N tiles of a row block side by side, so xq is re-read from L2.
//       One tile for every T: tools/torch_k5_tiles.py timed the others (8
//       warps of 64 x 32, 64-byte K slices in 4 stages, 256- and 64-row
//       tiles) no faster, at zero-shot's 1664 rows too. Rows past T and
//       columns past N re-read the last row or column and are never
//       stored; the zero codes past K add nothing, so no edge of the
//       product is masked.
// Not used: wgmma, TMA, mbarriers, a persistent grid.
//
// C interface (loaded with ctypes): ttl_quant_matmul,
// ttl_quant_matmul_scratch_bytes. The launches go to the caller's stream;
// the function returns the first non-zero cudaGetLastError() of them.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <stdint.h>

#include "mma_sm90.cuh"

namespace {

constexpr int kThreads = 256;  // 8 warps: (Q), (W)
constexpr int kBN = 128;       // (G): output columns per block
constexpr int kBK = 128;       // (G): K bytes per ring stage; Kp's step
constexpr int kStages = 3;     // (G): ring depth
constexpr int kLd = kBK + 16;  // (G): shared row stride of a stage, bytes
constexpr int kTile = 64;      // (W): a [64 k][64 n] byte tile per block

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
  // two neighbouring outputs into the staged tile
  __device__ static void store_pair(unsigned char* p, float lo, float hi) {
    *reinterpret_cast<float2*>(p) = make_float2(lo, hi);
  }
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
  __device__ static void store_pair(unsigned char* p, float lo, float hi) {
    *reinterpret_cast<unsigned*>(p) = pack_bf16x2(lo, hi);
  }
};

__device__ __forceinline__ unsigned code(float q) {
  return static_cast<unsigned char>(
      static_cast<signed char>(fminf(fmaxf(rintf(q), -127.f), 127.f)));
}

int padded_k(int K) { return (K + kBK - 1) / kBK * kBK; }

// Scratch of one call, each part at a 16-byte boundary: xq [T, Kp], s [T]
// f32, wt [N, Kp].
struct Scratch {
  size_t s_off, wt_off, bytes;
  Scratch(int rows, int K, int N) {
    const size_t kp = padded_k(K);
    s_off = (size_t)rows * kp;
    wt_off = s_off + ((size_t)rows * 4 + 15) / 16 * 16;
    bytes = wt_off + (size_t)N * kp;
  }
};

// (Q): grid ceil(T / 8), one warp per row
template <typename T>
__global__ void __launch_bounds__(kThreads)
k5_quant_rows_kernel(const T* __restrict__ x, int8_t* __restrict__ xq,
                     float* __restrict__ s_row, int rows, int K, int Kp) {
  constexpr int kVec = Num<T>::kVec;
  const int lane = threadIdx.x % 32;
  const int t = blockIdx.x * (kThreads / 32) + threadIdx.x / 32;
  if (t >= rows) return;  // the whole warp: t is the warp's
  const T* xr = x + (size_t)t * K;
  float amax = 0.f;
#pragma unroll 4
  for (int c = lane * kVec; c < K; c += 32 * kVec) {
    float v[kVec];
    Num<T>::unpack(*reinterpret_cast<const uint4*>(xr + c), v);
#pragma unroll
    for (int i = 0; i < kVec; ++i) amax = fmaxf(amax, fabsf(v[i]));
  }
  const float s = Num<T>::row_scale(warp_max(amax));
  if (lane == 0) s_row[t] = s;
  // the row again (from L1/L2), as codes; zeros from K to Kp
  int8_t* qr = xq + (size_t)t * Kp;
#pragma unroll 4
  for (int c = lane * kVec; c < Kp; c += 32 * kVec) {
    unsigned packed[kVec / 4] = {};
    if (c < K) {
      float v[kVec];
      Num<T>::unpack(*reinterpret_cast<const uint4*>(xr + c), v);
#pragma unroll
      for (int i = 0; i < kVec; ++i)
        packed[i / 4] |= code(Num<T>::quotient(v[i], s)) << (8 * (i % 4));
    }
    if constexpr (kVec == 8) {
      *reinterpret_cast<uint2*>(qr + c) = make_uint2(packed[0], packed[1]);
    } else {
      *reinterpret_cast<unsigned*>(qr + c) = packed[0];
    }
  }
}

// (W): grid (ceil(N / 64), Kp / 64); thread (r, c) reads 16 bytes of row r
// of the [64 k][64 n] tile, then writes 16 bytes (k0 + c ..) of wt's row
// n0 + r
__global__ void __launch_bounds__(kThreads)
k5_transpose_w_kernel(const int8_t* __restrict__ wq, int8_t* __restrict__ wt,
                      int K, int N, int Kp) {
  __shared__ __align__(16) unsigned char tile[kTile][kTile + 16];
  const int n0 = blockIdx.x * kTile, k0 = blockIdx.y * kTile;
  const int r = threadIdx.x / 4, c = (threadIdx.x % 4) * 16;
  uint4 v = make_uint4(0, 0, 0, 0);
  if (k0 + r < K && n0 + c < N)
    v = *reinterpret_cast<const uint4*>(wq + (size_t)(k0 + r) * N + n0 + c);
  *reinterpret_cast<uint4*>(&tile[r][c]) = v;
  __syncthreads();
  if (n0 + r >= N) return;
  unsigned w[4] = {};
#pragma unroll
  for (int i = 0; i < 16; ++i)
    w[i / 4] |= (unsigned)tile[c + i][r] << (8 * (i % 4));
  *reinterpret_cast<uint4*>(wt + (size_t)(n0 + r) * Kp + k0 + c) =
      make_uint4(w[0], w[1], w[2], w[3]);
}

template <int BM> __host__ __device__ constexpr int stage_bytes() {
  return (BM + kBN) * kLd;
}

// dynamic shared memory of (G): the ring, later the staged output tile
template <typename T, int BM>
__host__ __device__ constexpr size_t gemm_smem_bytes() {
  constexpr size_t ring = (size_t)kStages * stage_bytes<BM>();
  constexpr size_t out = (size_t)BM * (kBN * sizeof(T) + 16);
  return ring > out ? ring : out;
}

template <int WM, int WN> __host__ __device__ constexpr int gemm_threads() {
  return 32 * WM * WN;
}

// two blocks an SM where their registers fit: at most 64 accumulators a
// thread, or at most 4 warps
template <int BM, int WM, int WN>
__host__ __device__ constexpr int gemm_min_blocks() {
  return (BM / WM) * (kBN / WN) / 32 <= 64 || WM * WN <= 4 ? 2 : 1;
}

// (G): grid (ceil(N / 128), ceil(T / BM)), WM x WN warps, each a
// (BM / WM) x (128 / WN) tile
template <typename T, int BM, int WM, int WN>
__global__ void __launch_bounds__(gemm_threads<WM, WN>(),
                                  gemm_min_blocks<BM, WM, WN>())
k5_gemm_kernel(const int8_t* __restrict__ xq, const float* __restrict__ s_row,
               const int8_t* __restrict__ wt,
               const float* __restrict__ col_scale,
               const float* __restrict__ bias, T* __restrict__ y, int rows,
               int Kp, int N) {
  constexpr int kGemmThreads = gemm_threads<WM, WN>();
  constexpr int MI = BM / WM / 16;  // m16 tiles of a warp's rows
  constexpr int WC = kBN / WN;       // a warp's columns
  constexpr int NJ = WC / 8;         // n8 tiles of them
  constexpr int kChunks = kBK / 16;
  extern __shared__ __align__(128) unsigned char smem[];
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int wm = warp / WN, wn = warp % WN;
  const int n0 = blockIdx.x * kBN, t0 = blockIdx.y * BM;
  const int nk = Kp / kBK;

  // one stage: BM rows of xq and 128 rows of wt, 64 bytes each
  auto load_stage = [&](int stage, int kt) {
    unsigned char* a = smem + stage * stage_bytes<BM>();
    unsigned char* b = a + BM * kLd;
    const int k0 = kt * kBK;
#pragma unroll
    for (int i = 0; i < BM * kChunks / kGemmThreads; ++i) {
      const int e = tid + i * kGemmThreads, r = e / kChunks;
      const int c = (e % kChunks) * 16;
      const int t = min(t0 + r, rows - 1);
      cp_async16(a + r * kLd + c, xq + (size_t)t * Kp + k0 + c);
    }
#pragma unroll
    for (int i = 0; i < kBN * kChunks / kGemmThreads; ++i) {
      const int e = tid + i * kGemmThreads, r = e / kChunks;
      const int c = (e % kChunks) * 16;
      const int n = min(n0 + r, N - 1);
      cp_async16(b + r * kLd + c, wt + (size_t)n * Kp + k0 + c);
    }
  };

  int acc[MI][NJ][4];
#pragma unroll
  for (int i = 0; i < MI; ++i)
#pragma unroll
    for (int j = 0; j < NJ; ++j)
#pragma unroll
      for (int h = 0; h < 4; ++h) acc[i][j][h] = 0;

#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < nk) load_stage(s, s);
    cp_async_commit();
  }
  // the lane's ldmatrix row and 16-byte half of a 32-byte K slice: A's four
  // blocks are (rows 0-7, 8-15) x (bytes 0-15, 16-31), B's two n8 tiles x
  // (bytes 0-15, 16-31)
  const int a_row = wm * (BM / WM) + lane % 16, a_col = (lane / 16) * 16;
  const int b_row = wn * WC + (lane / 16) * 8 + lane % 8;
  const int b_col = ((lane / 8) % 2) * 16;
  const unsigned base = smem_addr(smem);
  for (int kt = 0; kt < nk; ++kt) {
    cp_async_wait<kStages - 2>();
    __syncthreads();  // stage kt is in; every warp is done with kt - 1
    const int next = kt + kStages - 1;
    if (next < nk) load_stage(next % kStages, next);
    cp_async_commit();
    const unsigned a_s = base + (kt % kStages) * stage_bytes<BM>();
    const unsigned b_s = a_s + BM * kLd;
#pragma unroll
    for (int kk = 0; kk < kBK; kk += 32) {
      unsigned af[MI][4], bf[NJ / 2][4];
#pragma unroll
      for (int i = 0; i < MI; ++i)
        ldmatrix_x4(af[i], a_s + (a_row + i * 16) * kLd + kk + a_col);
#pragma unroll
      for (int p = 0; p < NJ / 2; ++p)
        ldmatrix_x4(bf[p], b_s + (b_row + p * 16) * kLd + kk + b_col);
#pragma unroll
      for (int i = 0; i < MI; ++i)
#pragma unroll
        for (int j = 0; j < NJ; ++j)
          mma_s8(acc[i][j], af[i], bf[j / 2][(j % 2) * 2],
                 bf[j / 2][(j % 2) * 2 + 1]);
    }
  }
  cp_async_wait<0>();
  __syncthreads();  // the ring is free for the output tile

  // epilogue: y = fma(acc, s_t * col_scale_n, b_n) in f32, rounded once to
  // T, into the staged [BM][128] tile; lane (g, q) holds rows g and g + 8,
  // columns 2q and 2q + 1 of each 16 x 8 accumulator
  constexpr int kOutLd = kBN * sizeof(T) + 16;  // bytes
  const int g = lane / 4, q = lane % 4;
  float cs[NJ][2], bb[NJ][2];
#pragma unroll
  for (int j = 0; j < NJ; ++j)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int n = min(n0 + wn * WC + j * 8 + 2 * q + h, N - 1);
      cs[j][h] = col_scale[n];
      bb[j][h] = bias[n];
    }
#pragma unroll
  for (int i = 0; i < MI; ++i)
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      const int r = wm * (BM / WM) + i * 16 + g + 8 * hr;
      const float s = s_row[min(t0 + r, rows - 1)];
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        float v[2];
#pragma unroll
        for (int h = 0; h < 2; ++h)
          v[h] = fmaf(__int2float_rn(acc[i][j][2 * hr + h]),
                      __fmul_rn(s, cs[j][h]), bb[j][h]);
        Num<T>::store_pair(
            smem + r * kOutLd + (wn * WC + j * 8 + 2 * q) * sizeof(T), v[0],
            v[1]);
      }
    }
  __syncthreads();
  constexpr int kOutChunks = kBN * sizeof(T) / 16;  // per output row
  constexpr int kPerChunk = 16 / sizeof(T);
  for (int e = tid; e < BM * kOutChunks; e += kGemmThreads) {
    const int r = e / kOutChunks, c = e % kOutChunks;
    const int t = t0 + r, n = n0 + c * kPerChunk;
    if (t < rows && n < N)
      *reinterpret_cast<uint4*>(y + (size_t)t * N + n) =
          *reinterpret_cast<const uint4*>(smem + r * kOutLd + c * 16);
  }
}

template <typename T, int BM, int WM, int WN>
cudaError_t launch_gemm(const int8_t* xq, const float* s, const int8_t* wt,
                        const void* scale, const void* b, void* y, int rows,
                        int Kp, int N, cudaStream_t stream) {
  constexpr size_t bytes = gemm_smem_bytes<T, BM>();
  const dim3 grid((N + kBN - 1) / kBN, (rows + BM - 1) / BM);
  if (grid.y > 65535u) return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      k5_gemm_kernel<T, BM, WM, WN>,
      cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)bytes);
  if (err != cudaSuccess) return err;
  k5_gemm_kernel<T, BM, WM, WN><<<grid, gemm_threads<WM, WN>(), bytes,
                                  stream>>>(
      xq, s, wt, static_cast<const float*>(scale),
      static_cast<const float*>(b), static_cast<T*>(y), rows, Kp, N);
  return cudaGetLastError();
}

template <typename T>
int launch(const void* x, const void* wq, const void* scale, const void* b,
           void* y, void* scratch, int rows, int K, int N,
           cudaStream_t stream) {
  const Scratch sc(rows, K, N);
  const int kp = padded_k(K);
  auto* base = static_cast<unsigned char*>(scratch);
  auto* xq = reinterpret_cast<int8_t*>(base);
  auto* s = reinterpret_cast<float*>(base + sc.s_off);
  auto* wt = reinterpret_cast<int8_t*>(base + sc.wt_off);
  k5_quant_rows_kernel<T><<<(rows + kThreads / 32 - 1) / (kThreads / 32),
                            kThreads, 0, stream>>>(static_cast<const T*>(x),
                                                   xq, s, rows, K, kp);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  k5_transpose_w_kernel<<<dim3((N + kTile - 1) / kTile, kp / kTile),
                          kThreads, 0, stream>>>(
      static_cast<const int8_t*>(wq), wt, K, N, kp);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  // one tile for every T: 64-row tiles gain nothing at zero-shot's 1664
  // rows (tools/torch_k5_tiles.py)
  err = launch_gemm<T, 128, 2, 2>(xq, s, wt, scale, b, y, rows, kp, N,
                                  stream);
  return (int)err;
}

}  // namespace

extern "C" {

// bytes of scratch ttl_quant_matmul needs at these sizes
long long ttl_quant_matmul_scratch_bytes(int rows, int K, int N) {
  return (long long)Scratch(rows, K, N).bytes;
}

// x [rows, K] (dtype 0: f32, 1: bf16), wq [K, N] int8, scale and b [N] f32,
// y [rows, N] in x's dtype, scratch of at least
// ttl_quant_matmul_scratch_bytes(rows, K, N) bytes; K and N multiples of
// 16, every pointer 16-byte aligned (the wrapper checks both).
int ttl_quant_matmul(const void* x, const void* wq, const void* scale,
                     const void* b, void* y, void* scratch,
                     long long scratch_bytes, int dtype, int rows, int K,
                     int N, void* stream) {
  auto st = static_cast<cudaStream_t>(stream);
  if (K % 16 || N % 16 || rows <= 0 ||
      scratch_bytes < (long long)Scratch(rows, K, N).bytes ||
      reinterpret_cast<uintptr_t>(scratch) % 16)
    return (int)cudaErrorInvalidValue;
  if (dtype == 0)
    return launch<float>(x, wq, scale, b, y, scratch, rows, K, N, st);
  if (dtype == 1)
    return launch<__nv_bfloat16>(x, wq, scale, b, y, scratch, rows, K, N,
                                 st);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
