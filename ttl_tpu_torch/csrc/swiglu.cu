// SwiGLU, the gated activation of EVA02's MLP, forward and backward.
//
// For the product gu = h [W1 | W2] + [b1 | b2], [M, 2F] (u its first F
// columns, g its last F):
//
//   forward   s  = SiLU(u) * g                                   [M, F]
//   backward  du = dy * g * sig(u) * (1 + u * (1 - sig(u)))
//             dg = dy * SiLU(u)                                  [M, 2F]
//
// each element computed in f32 from the stored values and rounded once.
//
// It replaces no TPU kernel: the JAX package has no gated MLP. It was added
// with the EVA02 tower, whose MLP (F = 2730 at L/14) would otherwise cost
// PyTorch's separate silu, multiply and casts, each a pass over [M, F] or
// [M, 2F] at M = 295,424 rows a step. Bound: bytes. Forward reads 2F and
// writes F values a row, backward reads 3F and writes 2F; neither does more
// than a few operations a byte, far below the card's ~295 FLOP a byte.
//
// Design: one block a row, its threads striding over the row's columns. In
// bf16 with F even each thread moves a pair of neighbouring columns with
// 4-byte loads and stores (__nv_bfloat162): rows of 2F = 5460 values keep
// both halves on 4-byte boundaries, and not on 16-byte ones, so wider
// vectors would need a second path for misaligned rows. Other shapes and
// f32 take one column a thread. Sigmoid is 1 / (1 + e^-u) with the fast
// exponential and reciprocal (__expf, __fdividef): the kernel stays bound by
// its bytes, and both differ from the exactly rounded f32 operations by a
// few units in the last place, which one rounding to bf16 hides in nearly
// every output.
//
// C interface (loaded with ctypes): ttl_swiglu_fwd and ttl_swiglu_bwd, on
// the caller's stream; each returns the cudaError_t of its launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <stddef.h>

namespace {

constexpr int kThreads = 128;

__device__ __forceinline__ float silu(float u) {
  return __fdividef(u, 1.f + __expf(-u));
}

__device__ __forceinline__ void swiglu_grad(float u, float g, float dy,
                                            float& du, float& dg) {
  const float sig = __fdividef(1.f, 1.f + __expf(-u));
  dg = dy * (u * sig);
  du = dy * g * sig * (1.f + u * (1.f - sig));
}

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

// one column a thread
template <typename T>
__global__ void __launch_bounds__(kThreads)
swiglu_fwd_kernel(const T* __restrict__ gu, T* __restrict__ out, int f) {
  const T* u = gu + (size_t)blockIdx.x * 2 * f;
  const T* g = u + f;
  T* o = out + (size_t)blockIdx.x * f;
  for (int j = threadIdx.x; j < f; j += kThreads)
    o[j] = from_f32<T>(silu(to_f32(u[j])) * to_f32(g[j]));
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
swiglu_bwd_kernel(const T* __restrict__ gu, const T* __restrict__ dy,
                  T* __restrict__ dgu, int f) {
  const size_t row = blockIdx.x;
  const T* u = gu + row * 2 * f;
  const T* g = u + f;
  const T* d = dy + row * f;
  T* du = dgu + row * 2 * f;
  T* dg = du + f;
  for (int j = threadIdx.x; j < f; j += kThreads) {
    float a, b;
    swiglu_grad(to_f32(u[j]), to_f32(g[j]), to_f32(d[j]), a, b);
    du[j] = from_f32<T>(a);
    dg[j] = from_f32<T>(b);
  }
}

// bf16, a pair of columns a thread: half = F / 2
__global__ void __launch_bounds__(kThreads)
swiglu_fwd_pairs_kernel(const __nv_bfloat162* __restrict__ gu,
                        __nv_bfloat162* __restrict__ out, int half) {
  const __nv_bfloat162* u = gu + (size_t)blockIdx.x * 2 * half;
  const __nv_bfloat162* g = u + half;
  __nv_bfloat162* o = out + (size_t)blockIdx.x * half;
#pragma unroll 4
  for (int j = threadIdx.x; j < half; j += kThreads) {
    const float2 uf = __bfloat1622float2(u[j]);
    const float2 gf = __bfloat1622float2(g[j]);
    o[j] = __floats2bfloat162_rn(silu(uf.x) * gf.x, silu(uf.y) * gf.y);
  }
}

__global__ void __launch_bounds__(kThreads)
swiglu_bwd_pairs_kernel(const __nv_bfloat162* __restrict__ gu,
                        const __nv_bfloat162* __restrict__ dy,
                        __nv_bfloat162* __restrict__ dgu, int half) {
  const size_t row = blockIdx.x;
  const __nv_bfloat162* u = gu + row * 2 * half;
  const __nv_bfloat162* g = u + half;
  const __nv_bfloat162* d = dy + row * half;
  __nv_bfloat162* du = dgu + row * 2 * half;
  __nv_bfloat162* dg = du + half;
#pragma unroll 4
  for (int j = threadIdx.x; j < half; j += kThreads) {
    const float2 uf = __bfloat1622float2(u[j]);
    const float2 gf = __bfloat1622float2(g[j]);
    const float2 df = __bfloat1622float2(d[j]);
    float du0, dg0, du1, dg1;
    swiglu_grad(uf.x, gf.x, df.x, du0, dg0);
    swiglu_grad(uf.y, gf.y, df.y, du1, dg1);
    du[j] = __floats2bfloat162_rn(du0, du1);
    dg[j] = __floats2bfloat162_rn(dg0, dg1);
  }
}

bool pairs(int dtype, int f, const void* a, const void* b, const void* c) {
  const size_t any = (size_t)a | (size_t)b | (size_t)c;
  return dtype == 1 && f % 2 == 0 && any % 4 == 0;
}

}  // namespace

extern "C" {

// gu [rows, 2f] -> out [rows, f]; dtype 0 f32, 1 bf16
int ttl_swiglu_fwd(const void* gu, void* out, int dtype, long long rows,
                   int f, void* stream) {
  if (rows == 0) return 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid(static_cast<unsigned>(rows));
  if (pairs(dtype, f, gu, out, gu)) {
    swiglu_fwd_pairs_kernel<<<grid, kThreads, 0, s>>>(
        static_cast<const __nv_bfloat162*>(gu),
        static_cast<__nv_bfloat162*>(out), f / 2);
  } else if (dtype == 1) {
    swiglu_fwd_kernel<__nv_bfloat16><<<grid, kThreads, 0, s>>>(
        static_cast<const __nv_bfloat16*>(gu),
        static_cast<__nv_bfloat16*>(out), f);
  } else {
    swiglu_fwd_kernel<float><<<grid, kThreads, 0, s>>>(
        static_cast<const float*>(gu), static_cast<float*>(out), f);
  }
  return static_cast<int>(cudaGetLastError());
}

// gu [rows, 2f], dy [rows, f] -> dgu [rows, 2f] (du, then dg)
int ttl_swiglu_bwd(const void* gu, const void* dy, void* dgu, int dtype,
                   long long rows, int f, void* stream) {
  if (rows == 0) return 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid(static_cast<unsigned>(rows));
  if (pairs(dtype, f, gu, dy, dgu)) {
    swiglu_bwd_pairs_kernel<<<grid, kThreads, 0, s>>>(
        static_cast<const __nv_bfloat162*>(gu),
        static_cast<const __nv_bfloat162*>(dy),
        static_cast<__nv_bfloat162*>(dgu), f / 2);
  } else if (dtype == 1) {
    swiglu_bwd_kernel<__nv_bfloat16><<<grid, kThreads, 0, s>>>(
        static_cast<const __nv_bfloat16*>(gu),
        static_cast<const __nv_bfloat16*>(dy),
        static_cast<__nv_bfloat16*>(dgu), f);
  } else {
    swiglu_bwd_kernel<float><<<grid, kThreads, 0, s>>>(
        static_cast<const float*>(gu), static_cast<const float*>(dy),
        static_cast<float*>(dgu), f);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
