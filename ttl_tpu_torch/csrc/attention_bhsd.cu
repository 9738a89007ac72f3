// Head-split ("bhsd") attention for both CLIP towers on Hopper (sm_90a),
// with an optional causal mask: the kernels behind
// TTL_FUSED_ATTENTION=per_head and =heads.
//
// Replaces four Pallas TPU kernels of the JAX package:
//   per_head forward  : ttl_tpu/ops/attention.py::_attn_kernel
//   per_head backward : ttl_tpu/ops/attention.py::_attn_bwd_kernel
//   heads forward     : ttl_tpu/ops/attention.py::_heads_kernel
//   heads backward    : ttl_tpu/ops/attention.py::_heads_bwd_kernel
//
// All read q/k/v (and do) as contiguous [B, H, S, D] tensors: head h of
// batch element b is the [S, D] slab at offset (b*H + h)*S*D. They compute
// softmax(mask(q k^T / sqrt(D))) v and its VJP with the Pallas kernels'
// numerics: scores, softmax and every product sum in f32; the forward
// rounds the probabilities to the input type before P.V; the backward
// recomputes the softmax from q and k and keeps P and dS in f32. A key is
// kept when kpos <= qpos (causal towers); masked scores are -1e9 and masked
// dS is 0. Any S >= 1 is taken as it is: the 16-row padding of the Pallas
// wrappers is the TPU's, and staged rows past S are zero-filled here.
//
// The two routes differ in their grids, as the Pallas ones do:
//   per_head: one block per (batch*head, tile of 32 query rows); the
//             backward's second kernel per (batch*head, tile of 32 keys).
//   heads:    one block per (batch element, tile), which walks all H heads
//             of its element inside the kernel, one after the other, with
//             the same shared memory.
// The work per head is the key-tiled f32 FMA code of attention_tiled.cuh,
// shared with the bshd kernels: K and V stream through shared memory 64
// keys at a time under an online softmax; the backward is a rows kernel
// (softmax statistics, rowsum(dP*P), dQ) and a keys kernel (dK, dV) with
// the statistics in a scratch buffer between them. With the causal mask the
// key tiles past a query tile's last row are skipped. No tensor cores yet:
// simple and right first.
//
// C interface (loaded with ctypes): ttl_per_head_attention_fwd / _bwd and
// ttl_heads_attention_fwd / _bwd. The launches go to the caller's stream;
// each function returns the cudaError_t of its launches.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <stddef.h>

#include "attention_tiled.cuh"

namespace {

// ------------------------------------------------------------------ per_head
// grid (B*H, tiles): blockIdx.x is the (batch, head) slab.

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
per_head_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, T* __restrict__ o, Geometry g) {
  extern __shared__ __align__(16) unsigned char smem[];
  const size_t base = (size_t)blockIdx.x * g.S * D;
  tiled_fwd_body<T, D>(q + base, k + base, v + base, o + base,
                       blockIdx.y * kTiledRows, g, smem);
}

// stats: [3][B*H][S] f32 scratch (m, l, rs) between the two backward kernels.
template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
per_head_bwd_rows_kernel(const T* __restrict__ q, const T* __restrict__ k,
                         const T* __restrict__ v, const T* __restrict__ dout,
                         T* __restrict__ dq, float* __restrict__ stats,
                         Geometry g) {
  extern __shared__ __align__(16) unsigned char smem[];
  const size_t base = (size_t)blockIdx.x * g.S * D;
  const size_t plane = (size_t)gridDim.x * g.S;
  float* st = stats + (size_t)blockIdx.x * g.S;
  tiled_bwd_rows_body<T, D>(q + base, k + base, v + base, dout + base,
                            dq + base, st, st + plane, st + 2 * plane,
                            blockIdx.y * kTiledRows, g, smem);
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
per_head_bwd_keys_kernel(const T* __restrict__ q, const T* __restrict__ k,
                         const T* __restrict__ v, const T* __restrict__ dout,
                         T* __restrict__ dk, T* __restrict__ dv,
                         const float* __restrict__ stats, Geometry g) {
  extern __shared__ __align__(16) unsigned char smem[];
  const size_t base = (size_t)blockIdx.x * g.S * D;
  const size_t plane = (size_t)gridDim.x * g.S;
  const float* st = stats + (size_t)blockIdx.x * g.S;
  tiled_bwd_keys_body<T, D>(q + base, k + base, v + base, dout + base,
                            dk + base, dv + base, st, st + plane,
                            st + 2 * plane, blockIdx.y * kTiledKeyRows, g,
                            smem);
}

// --------------------------------------------------------------------- heads
// grid (B, tiles): blockIdx.x is the batch element; the block walks its H
// heads. The barrier after each head keeps the next head's staging from
// overwriting shared memory that slower threads still read.

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
heads_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ o, int H,
                 Geometry g) {
  extern __shared__ __align__(16) unsigned char smem[];
  for (int h = 0; h < H; ++h) {
    const size_t base = ((size_t)blockIdx.x * H + h) * g.S * D;
    tiled_fwd_body<T, D>(q + base, k + base, v + base, o + base,
                         blockIdx.y * kTiledRows, g, smem);
    __syncthreads();
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
heads_bwd_rows_kernel(const T* __restrict__ q, const T* __restrict__ k,
                      const T* __restrict__ v, const T* __restrict__ dout,
                      T* __restrict__ dq, float* __restrict__ stats, int H,
                      Geometry g) {
  extern __shared__ __align__(16) unsigned char smem[];
  const size_t plane = (size_t)gridDim.x * H * g.S;
  for (int h = 0; h < H; ++h) {
    const size_t bh = (size_t)blockIdx.x * H + h;
    const size_t base = bh * g.S * D;
    float* st = stats + bh * g.S;
    tiled_bwd_rows_body<T, D>(q + base, k + base, v + base, dout + base,
                              dq + base, st, st + plane, st + 2 * plane,
                              blockIdx.y * kTiledRows, g, smem);
    __syncthreads();
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
heads_bwd_keys_kernel(const T* __restrict__ q, const T* __restrict__ k,
                      const T* __restrict__ v, const T* __restrict__ dout,
                      T* __restrict__ dk, T* __restrict__ dv,
                      const float* __restrict__ stats, int H, Geometry g) {
  extern __shared__ __align__(16) unsigned char smem[];
  const size_t plane = (size_t)gridDim.x * H * g.S;
  for (int h = 0; h < H; ++h) {
    const size_t bh = (size_t)blockIdx.x * H + h;
    const size_t base = bh * g.S * D;
    const float* st = stats + bh * g.S;
    tiled_bwd_keys_body<T, D>(q + base, k + base, v + base, dout + base,
                              dk + base, dv + base, st, st + plane,
                              st + 2 * plane, blockIdx.y * kTiledKeyRows, g,
                              smem);
    __syncthreads();
  }
}

// ------------------------------------------------------------------ launches

int tiles(int n, int per) { return (n + per - 1) / per; }

template <typename T, int D>
int launch_fwd(bool heads, const void* q, const void* k, const void* v,
               void* o, int B, int H, const Geometry& g, cudaStream_t st) {
  const size_t smem = TiledLayout::make<T, D>().fwd;
  auto qq = static_cast<const T*>(q);
  auto kk = static_cast<const T*>(k);
  auto vv = static_cast<const T*>(v);
  auto oo = static_cast<T*>(o);
  if (heads) {
    auto kernel = heads_fwd_kernel<T, D>;
    if (int err = set_smem(kernel, smem)) return err;
    kernel<<<dim3(B, tiles(g.S, kTiledRows)), kThreads, smem, st>>>(
        qq, kk, vv, oo, H, g);
  } else {
    auto kernel = per_head_fwd_kernel<T, D>;
    if (int err = set_smem(kernel, smem)) return err;
    kernel<<<dim3(B * H, tiles(g.S, kTiledRows)), kThreads, smem, st>>>(
        qq, kk, vv, oo, g);
  }
  return (int)cudaGetLastError();
}

template <typename T, int D>
int launch_bwd(bool heads, const void* q, const void* k, const void* v,
               const void* dout, void* dq, void* dk, void* dv, void* stats,
               int B, int H, const Geometry& g, cudaStream_t st) {
  const size_t smem = TiledLayout::make<T, D>().bwd;
  auto qq = static_cast<const T*>(q);
  auto kk = static_cast<const T*>(k);
  auto vv = static_cast<const T*>(v);
  auto dd = static_cast<const T*>(dout);
  auto ss = static_cast<float*>(stats);
  const int row_tiles = tiles(g.S, kTiledRows);
  const int key_tiles = tiles(g.S, kTiledKeyRows);
  if (heads) {
    auto rows_kernel = heads_bwd_rows_kernel<T, D>;
    auto keys_kernel = heads_bwd_keys_kernel<T, D>;
    if (int err = set_smem(rows_kernel, smem)) return err;
    if (int err = set_smem(keys_kernel, smem)) return err;
    rows_kernel<<<dim3(B, row_tiles), kThreads, smem, st>>>(
        qq, kk, vv, dd, static_cast<T*>(dq), ss, H, g);
    if (cudaError_t err = cudaGetLastError()) return (int)err;
    keys_kernel<<<dim3(B, key_tiles), kThreads, smem, st>>>(
        qq, kk, vv, dd, static_cast<T*>(dk), static_cast<T*>(dv), ss, H, g);
  } else {
    auto rows_kernel = per_head_bwd_rows_kernel<T, D>;
    auto keys_kernel = per_head_bwd_keys_kernel<T, D>;
    if (int err = set_smem(rows_kernel, smem)) return err;
    if (int err = set_smem(keys_kernel, smem)) return err;
    rows_kernel<<<dim3(B * H, row_tiles), kThreads, smem, st>>>(
        qq, kk, vv, dd, static_cast<T*>(dq), ss, g);
    if (cudaError_t err = cudaGetLastError()) return (int)err;
    keys_kernel<<<dim3(B * H, key_tiles), kThreads, smem, st>>>(
        qq, kk, vv, dd, static_cast<T*>(dk), static_cast<T*>(dv), ss, g);
  }
  return (int)cudaGetLastError();
}

template <typename T>
int fwd_for_type(bool heads, const void* q, const void* k, const void* v,
                 void* o, int B, int H, int D, const Geometry& g,
                 cudaStream_t st) {
  switch (D) {
    case 16: return launch_fwd<T, 16>(heads, q, k, v, o, B, H, g, st);
    case 32: return launch_fwd<T, 32>(heads, q, k, v, o, B, H, g, st);
    case 64: return launch_fwd<T, 64>(heads, q, k, v, o, B, H, g, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

template <typename T>
int bwd_for_type(bool heads, const void* q, const void* k, const void* v,
                 const void* dout, void* dq, void* dk, void* dv, void* stats,
                 int B, int H, int D, const Geometry& g, cudaStream_t st) {
  switch (D) {
    case 16:
      return launch_bwd<T, 16>(heads, q, k, v, dout, dq, dk, dv, stats, B, H,
                               g, st);
    case 32:
      return launch_bwd<T, 32>(heads, q, k, v, dout, dq, dk, dv, stats, B, H,
                               g, st);
    case 64:
      return launch_bwd<T, 64>(heads, q, k, v, dout, dq, dk, dv, stats, B, H,
                               g, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

int fwd(bool heads, const void* q, const void* k, const void* v, void* o,
        int dtype, int B, int H, int S, int D, int causal, float scale,
        void* stream) {
  const Geometry g{S, D, S, scale, causal};
  auto st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return fwd_for_type<float>(heads, q, k, v, o, B, H, D, g, st);
  if (dtype == 1)
    return fwd_for_type<__nv_bfloat16>(heads, q, k, v, o, B, H, D, g, st);
  return (int)cudaErrorInvalidValue;
}

int bwd(bool heads, const void* q, const void* k, const void* v,
        const void* dout, void* dq, void* dk, void* dv, void* stats,
        int dtype, int B, int H, int S, int D, int causal, float scale,
        void* stream) {
  const Geometry g{S, D, S, scale, causal};
  auto st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return bwd_for_type<float>(heads, q, k, v, dout, dq, dk, dv, stats, B, H,
                               D, g, st);
  if (dtype == 1)
    return bwd_for_type<__nv_bfloat16>(heads, q, k, v, dout, dq, dk, dv,
                                       stats, B, H, D, g, st);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// dtype: 0 float32, 1 bfloat16. q, k, v, o, dout, dq, dk, dv: contiguous
// [B, H, S, D]. stats: scratch of 3 * B * H * S floats.

int ttl_per_head_attention_fwd(const void* q, const void* k, const void* v,
                               void* o, int dtype, int B, int H, int S, int D,
                               int causal, float scale, void* stream) {
  return fwd(false, q, k, v, o, dtype, B, H, S, D, causal, scale, stream);
}

int ttl_per_head_attention_bwd(const void* q, const void* k, const void* v,
                               const void* dout, void* dq, void* dk, void* dv,
                               void* stats, int dtype, int B, int H, int S,
                               int D, int causal, float scale, void* stream) {
  return bwd(false, q, k, v, dout, dq, dk, dv, stats, dtype, B, H, S, D,
             causal, scale, stream);
}

int ttl_heads_attention_fwd(const void* q, const void* k, const void* v,
                            void* o, int dtype, int B, int H, int S, int D,
                            int causal, float scale, void* stream) {
  return fwd(true, q, k, v, o, dtype, B, H, S, D, causal, scale, stream);
}

int ttl_heads_attention_bwd(const void* q, const void* k, const void* v,
                            const void* dout, void* dq, void* dk, void* dv,
                            void* stats, int dtype, int B, int H, int S,
                            int D, int causal, float scale, void* stream) {
  return bwd(true, q, k, v, dout, dq, dk, dv, stats, dtype, B, H, S, D,
             causal, scale, stream);
}

}  // extern "C"
