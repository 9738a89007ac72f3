// Layout-native ("bshd") attention for CLIP vision towers on Hopper (sm_90a).
//
// Replaces the two Pallas TPU kernels of the JAX package:
//   forward  : ttl_tpu/ops/attention.py::_bshd_kernel
//   backward : ttl_tpu/ops/attention.py::_bshd_bwd_kernel
//
// Both read q/k/v (and do) in the towers' own [B, S, H*D] layout: head h is
// the column slice [h*D, (h+1)*D) of every row, addressed through strides,
// so no transpose is ever materialised. S is the padded token count (208 for
// ViT-B/16); keys at positions >= seq_len are masked to -1e9 before the
// softmax, exactly as in the Pallas kernels. Query rows past seq_len are
// computed like any other row: the towers never read them.
//
// Numerics follow the Pallas kernels: scores, softmax and every product sum
// in f32. The forward rounds the probabilities to the input type before P.V
// (bf16 on the main path), the backward keeps them f32-grade.
//
// What bounds them on the H100: at the main-path shapes (B = 512 views,
// S = 208, 12 heads of 64) the work is 4*S*S*D flops per head forward, 10
// backward, for 4 (7) tensors of S*D elements: 0.20 ms of bytes against
// 0.07 ms of bf16 tensor-core operations forward. A head's f32 score block
// (208 x 208 x 4 B = 173 KB) does not fit shared memory beside its q/k/v, so
// no kernel holds one: the scores stay in registers or in row tiles.
//
// Routes, by input type (ttl_bshd_attention_route):
//   bf16, at every S and head dims 16, 32, 64 and 128 (AIMv2's): the tensor-core bodies of attention_mma.cuh, shared
//       with K3/K4: mma.sync for all five products, cp.async rings, scores
//       and probabilities in registers. A head is a pointer to its row 0,
//       the row stride H*D and the key limit seq_len (HeadLayout, Geometry),
//       a block per (batch element, head) and tile of query rows, the tile
//       heights from S as for K3 (mma_attention_fwd / _bwd).
//       The forward streams K and V under an online softmax and rounds P
//       against the running max (the Pallas kernel rounds exp(s - m) / l
//       against the final one; a head of one stage, 64 keys or fewer,
//       rounds as it does); the backward is a rows kernel (dQ and each
//       row's m, l, rowsum(P dP)) and a keys kernel (dK, dV) with those
//       statistics in the 3*B*H*S scratch between them; P and dS enter the
//       tensor cores as hi + lo bf16 terms. No atomics: the same bits every
//       run.
//   f32, at head dims 16, 32 and 64 (128 takes bf16 alone): f32 FMA (TF32
//       would lose the f32 contract). The forward is
//       key-tiled (bshd_fwd_tiled_kernel: K and V stream through shared
//       memory 64 keys at a time under an online softmax). The backward
//       keeps a whole head's K and V in shared memory (bshd_bwd_kernel)
//       where they fit with the score rows beside them, and otherwise
//       (ViT-L/14's 272 keys and more) is key-tiled: a rows kernel
//       (bshd_bwd_tiled_rows_kernel: m and l by a first sweep over key
//       tiles, then P, rs = rowsum(dP * P) and
//       dQ = scale * (sum_j P dP k_j - rs * sum_j P k_j)) and a keys kernel
//       (bshd_bwd_tiled_keys_kernel: P and dS from the statistics,
//       dV += P^T dO, dK += dS^T Q). Their bodies live in
//       attention_tiled.cuh, shared with the f32 route of K3/K4.
// Where both f32 backward routes fit, the whole-head one was the faster
// (PERF.md). Every staged row past S is zero-filled, so no uninitialised
// memory is read.
//
// C interface (loaded with ctypes): ttl_bshd_attention_fwd,
// ttl_bshd_attention_bwd, ttl_bshd_attention_route and
// ttl_cuda_error_string. The launches go to the caller's stream; each
// launching function returns the cudaError_t of its launches.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <math.h>
#include <stddef.h>

#include "attention_mma.cuh"
#include "attention_tiled.cuh"

namespace {

// dst[j][d] = head slice of rows 0..S-1 of a [S, H*D] slab (src points at
// row 0, column h*D).
template <typename T, int D>
__device__ void load_slab(T* dst, const T* __restrict__ src, const Geometry& g) {
  constexpr int ld = slab_ld<T, D>();
  for (int e = threadIdx.x; e < g.S * D; e += kThreads) {
    const int j = e / D, d = e % D;
    dst[j * ld + d] = src[(size_t)j * g.HD + d];
  }
}

// In place over rows of s: masked, scaled softmax in f32, one warp per row.
template <int ROWS>
__device__ void softmax_rows(float* s, int lds, const Geometry& g) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  for (int r = warp; r < ROWS; r += kThreads / 32) {
    float* row = s + r * lds;
    float m = -INFINITY;
    for (int j = lane; j < g.S; j += 32) {
      const float x = j < g.seq_len ? row[j] * g.scale : kMaskValue;
      row[j] = x;
      m = fmaxf(m, x);
    }
    m = warp_max(m);
    float sum = 0.f;
    for (int j = lane; j < g.S; j += 32) {
      const float e = expf(row[j] - m);
      row[j] = e;
      sum += e;
    }
    sum = warp_sum(sum);
    for (int j = lane; j < g.S; j += 32) row[j] /= sum;
  }
}

// ds = p * (dp - rowsum(dp * p)), zero on masked keys, times scale; in place
// over dp. One warp per row.
template <int ROWS>
__device__ void softmax_grad_rows(const float* p, float* dp, int ld,
                                  const Geometry& g) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  for (int r = warp; r < ROWS; r += kThreads / 32) {
    const float* pr = p + r * ld;
    float* dr = dp + r * ld;
    float rs = 0.f;
    for (int j = lane; j < g.S; j += 32) rs += dr[j] * pr[j];
    rs = warp_sum(rs);
    for (int j = lane; j < g.S; j += 32)
      dr[j] = j < g.seq_len ? pr[j] * (dr[j] - rs) * g.scale : 0.f;
  }
}

// out rows 0..S-1 (head slice) = T of acc [S][D+1].
template <typename T, int D>
__device__ void store_acc(T* __restrict__ out, const float* acc,
                          const Geometry& g) {
  for (int e = threadIdx.x; e < g.S * D; e += kThreads) {
    const int j = e / D, d = e % D;
    out[(size_t)j * g.HD + d] = from_f32<T>(acc[j * (D + 1) + d]);
  }
}

__device__ __forceinline__ int odd_ld(int s) { return s | 1; }

template <typename T, int D> size_t bwd_smem_bytes(int S) {
  const size_t slab = align16(sizeof(T) * S * slab_ld<T, D>());
  const size_t acc = align16(sizeof(float) * S * (D + 1));
  const size_t tile = align16(sizeof(float) * kBwdRows * (D + 1));
  const size_t s = align16(sizeof(float) * kBwdRows * (S | 1));
  return 2 * slab + acc + 2 * tile + 2 * s;
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
bshd_bwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                const T* __restrict__ v, const T* __restrict__ dout,
                T* __restrict__ dq, T* __restrict__ dk, T* __restrict__ dv,
                Geometry g) {
  extern __shared__ __align__(16) unsigned char smem[];
  const size_t slab = align16(sizeof(T) * g.S * slab_ld<T, D>());
  const size_t acc_b = align16(sizeof(float) * g.S * (D + 1));
  const size_t tile_b = align16(sizeof(float) * kBwdRows * (D + 1));
  const size_t s_b = align16(sizeof(float) * kBwdRows * (g.S | 1));
  T* ks = reinterpret_cast<T*>(smem);
  T* vs = reinterpret_cast<T*>(smem + slab);
  float* acc = reinterpret_cast<float*>(smem + 2 * slab);
  float* qs = reinterpret_cast<float*>(smem + 2 * slab + acc_b);
  float* dos = reinterpret_cast<float*>(smem + 2 * slab + acc_b + tile_b);
  float* ps = reinterpret_cast<float*>(smem + 2 * slab + acc_b + 2 * tile_b);
  float* dss = reinterpret_cast<float*>(smem + 2 * slab + acc_b + 2 * tile_b + s_b);
  const int lds = odd_ld(g.S);

  const size_t base = (size_t)blockIdx.y * g.S * g.HD + (size_t)blockIdx.x * D;
  load_slab<T, D>(ks, k + base, g);
  load_slab<T, D>(vs, v + base, g);
  for (int e = threadIdx.x; e < g.S * (D + 1); e += kThreads) acc[e] = 0.f;
  __syncthreads();

  // Sweep 1: dV = sum over tiles of P^T dO.
  for (int row0 = 0; row0 < g.S; row0 += kBwdRows) {
    load_tile<kBwdRows, T, D>(qs, q + base, row0, g);
    load_tile<kBwdRows, T, D>(dos, dout + base, row0, g);
    __syncthreads();
    row_dots<kBwdRows, T, D>(qs, ks, ps, lds, g.S);
    __syncthreads();
    softmax_rows<kBwdRows>(ps, lds, g);
    __syncthreads();
    accumulate_outer<kBwdRows, D>(ps, lds, dos, acc, g.S);
    __syncthreads();
  }
  store_acc<T, D>(dv + base, acc, g);
  __syncthreads();
  for (int e = threadIdx.x; e < g.S * (D + 1); e += kThreads) acc[e] = 0.f;
  __syncthreads();

  // Sweep 2: dS per tile, dQ = dS K written per tile, dK = sum of dS^T Q.
  T* dqb = dq + base;
  for (int row0 = 0; row0 < g.S; row0 += kBwdRows) {
    load_tile<kBwdRows, T, D>(qs, q + base, row0, g);
    load_tile<kBwdRows, T, D>(dos, dout + base, row0, g);
    __syncthreads();
    row_dots<kBwdRows, T, D>(qs, ks, ps, lds, g.S);
    row_dots<kBwdRows, T, D>(dos, vs, dss, lds, g.S);
    __syncthreads();
    softmax_rows<kBwdRows>(ps, lds, g);
    __syncthreads();
    softmax_grad_rows<kBwdRows>(ps, dss, lds, g);
    __syncthreads();
    rows_times_slab<kBwdRows, T, D>(dss, lds, ks, g.S,
                                    [&](int r, int d, float val) {
      const int row = row0 + r;
      if (row < g.S) dqb[(size_t)row * g.HD + d] = from_f32<T>(val);
    });
    accumulate_outer<kBwdRows, D>(dss, lds, qs, acc, g.S);
    __syncthreads();
  }
  store_acc<T, D>(dk + base, acc, g);
}

// The key-tiled kernels (bodies in attention_tiled.cuh): grid (tile, head,
// batch); head h of batch element b starts at row 0, column h*D of its slab.
template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
bshd_fwd_tiled_kernel(const T* __restrict__ q, const T* __restrict__ k,
                      const T* __restrict__ v, T* __restrict__ o,
                      Geometry g) {
  extern __shared__ __align__(16) unsigned char smem[];
  const size_t base = (size_t)blockIdx.z * g.S * g.HD + (size_t)blockIdx.y * D;
  tiled_fwd_body<T, D>(q + base, k + base, v + base, o + base,
                       blockIdx.x * kTiledRows, g, smem);
}

// stats: [3][B*H][S] f32 scratch (m, l, rs), written by the rows kernel and
// read by the keys kernel.
template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
bshd_bwd_tiled_rows_kernel(const T* __restrict__ q, const T* __restrict__ k,
                           const T* __restrict__ v,
                           const T* __restrict__ dout, T* __restrict__ dq,
                           float* __restrict__ stats, Geometry g) {
  extern __shared__ __align__(16) unsigned char smem[];
  const size_t bh = (size_t)blockIdx.z * gridDim.y + blockIdx.y;
  const size_t plane = (size_t)gridDim.z * gridDim.y * g.S;
  const size_t base = (size_t)blockIdx.z * g.S * g.HD + (size_t)blockIdx.y * D;
  float* st = stats + bh * g.S;
  tiled_bwd_rows_body<T, D>(q + base, k + base, v + base, dout + base,
                            dq + base, st, st + plane, st + 2 * plane,
                            blockIdx.x * kTiledRows, g, smem);
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
bshd_bwd_tiled_keys_kernel(const T* __restrict__ q, const T* __restrict__ k,
                           const T* __restrict__ v,
                           const T* __restrict__ dout, T* __restrict__ dk,
                           T* __restrict__ dv,
                           const float* __restrict__ stats, Geometry g) {
  extern __shared__ __align__(16) unsigned char smem[];
  const size_t bh = (size_t)blockIdx.z * gridDim.y + blockIdx.y;
  const size_t plane = (size_t)gridDim.z * gridDim.y * g.S;
  const size_t base = (size_t)blockIdx.z * g.S * g.HD + (size_t)blockIdx.y * D;
  const float* st = stats + bh * g.S;
  tiled_bwd_keys_body<T, D>(q + base, k + base, v + base, dout + base,
                            dk + base, dv + base, st, st + plane,
                            st + 2 * plane, blockIdx.x * kTiledKeyRows, g,
                            smem);
}

template <typename T, int D>
int launch_fwd_tiled(const void* q, const void* k, const void* v, void* o,
                     int B, int H, const Geometry& g, cudaStream_t stream) {
  const size_t smem = TiledLayout::make<T, D>().fwd;
  auto kernel = bshd_fwd_tiled_kernel<T, D>;
  if (int err = set_smem(kernel, smem)) return err;
  const dim3 grid((g.S + kTiledRows - 1) / kTiledRows, H, B);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), g);
  return (int)cudaGetLastError();
}

template <typename T, int D>
int launch_bwd_tiled(const void* q, const void* k, const void* v,
                     const void* dout, void* dq, void* dk, void* dv,
                     void* stats, int B, int H, const Geometry& g,
                     cudaStream_t stream) {
  const size_t smem = TiledLayout::make<T, D>().bwd;
  auto rows_kernel = bshd_bwd_tiled_rows_kernel<T, D>;
  auto keys_kernel = bshd_bwd_tiled_keys_kernel<T, D>;
  if (int err = set_smem(rows_kernel, smem)) return err;
  if (int err = set_smem(keys_kernel, smem)) return err;
  rows_kernel<<<dim3((g.S + kTiledRows - 1) / kTiledRows, H, B), kThreads,
                smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(dout),
      static_cast<T*>(dq), static_cast<float*>(stats), g);
  if (cudaError_t err = cudaGetLastError()) return (int)err;
  keys_kernel<<<dim3((g.S + kTiledKeyRows - 1) / kTiledKeyRows, H, B),
                kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(dout),
      static_cast<T*>(dk), static_cast<T*>(dv),
      static_cast<const float*>(stats), g);
  return (int)cudaGetLastError();
}

// ------------------------------------------------------------------ routes

// Routes, numbered as ops/attention.py::ROUTES names them.
enum Route { kRouteTensorCore = 0, kRouteWholeHead = 1, kRouteKeyTiled = 2 };

// The rule: head dims 16, 32, 64 and 128 (multiples of the tensor-core
// products' depth of 16). bf16 takes the tensor-core bodies at every S; f32
// keeps the f32 FMA routes, since TF32 would lose the f32 contract, at 16,
// 32 and 64: the key-tiled forward, and backward the whole-head kernel
// where a head fits shared memory, else the key-tiled pair. -1: no kernel.
int route_of(int backward, int dtype, int S, int D) {
  if (D != 16 && D != 32 && D != 64 && D != 128) return -1;
  if (dtype == 1) return kRouteTensorCore;
  if (dtype != 0 || D == 128) return -1;
  if (!backward) return kRouteKeyTiled;
  const size_t smem = D == 16   ? bwd_smem_bytes<float, 16>(S)
                      : D == 32 ? bwd_smem_bytes<float, 32>(S)
                                : bwd_smem_bytes<float, 64>(S);
  return smem <= kMaxSmem ? kRouteWholeHead : kRouteKeyTiled;
}

// bf16: a block per (batch element, head) and tile of rows; head h of batch
// element b starts at row 0, column h*D of its [S, H*D] slab.
HeadLayout bshd_heads(int H, const Geometry& g, int D) {
  return HeadLayout{H, (size_t)g.S * g.HD, (size_t)D};
}

template <int D>
int fwd_d(int route, const void* q, const void* k, const void* v, void* o,
          int B, int H, const Geometry& g, cudaStream_t st) {
  if (route == kRouteTensorCore)
    return mma_attention_fwd<D>(q, k, v, o, B * H, 1, bshd_heads(H, g, D), g,
                                st);
  if constexpr (D == 128) {
    return (int)cudaErrorInvalidValue;  // bf16 alone (route_of)
  } else {
    return launch_fwd_tiled<float, D>(q, k, v, o, B, H, g, st);
  }
}

// the f32 routes of the backward
template <int D>
int bwd_f32(int route, const void* q, const void* k, const void* v,
            const void* dout, void* dq, void* dk, void* dv, void* stats,
            int B, int H, const Geometry& g, cudaStream_t st) {
  if (route == kRouteKeyTiled)
    return launch_bwd_tiled<float, D>(q, k, v, dout, dq, dk, dv, stats, B, H,
                                      g, st);
  const size_t smem = bwd_smem_bytes<float, D>(g.S);
  auto kernel = bshd_bwd_kernel<float, D>;
  if (int err = set_smem(kernel, smem)) return err;
  kernel<<<dim3(H, B), kThreads, smem, st>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<const float*>(dout),
      static_cast<float*>(dq), static_cast<float*>(dk),
      static_cast<float*>(dv), g);
  return (int)cudaGetLastError();
}

template <int D>
int bwd_d(int route, const void* q, const void* k, const void* v,
          const void* dout, void* dq, void* dk, void* dv, void* stats, int B,
          int H, const Geometry& g, cudaStream_t st) {
  if (route == kRouteTensorCore)
    return mma_attention_bwd<D>(q, k, v, dout, dq, dk, dv, stats,
                                (size_t)B * H * g.S, B * H, 1,
                                bshd_heads(H, g, D), g, st);
  if constexpr (D == 128) {
    return (int)cudaErrorInvalidValue;  // bf16 alone (route_of)
  } else {
    return bwd_f32<D>(route, q, k, v, dout, dq, dk, dv, stats, B, H, g, st);
  }
}

}  // namespace

extern "C" {

// dtype: 0 float32, 1 bfloat16. q, k, v, o, dout, dq, dk, dv: contiguous
// [B, S, H*D], each starting at a 16-byte boundary. stats: scratch of
// 3 * B * H * S floats (every route but the whole-head one writes and reads
// it).

int ttl_bshd_attention_fwd(const void* q, const void* k, const void* v,
                           void* o, int dtype, int B, int S, int H, int D,
                           int seq_len, float scale, void* stream) {
  const Geometry g{S, H * D, seq_len, scale, /*causal=*/0};
  auto st = static_cast<cudaStream_t>(stream);
  const int route = route_of(0, dtype, S, D);
  if (route < 0) return (int)cudaErrorInvalidValue;
  switch (D) {
    case 16: return fwd_d<16>(route, q, k, v, o, B, H, g, st);
    case 32: return fwd_d<32>(route, q, k, v, o, B, H, g, st);
    case 64: return fwd_d<64>(route, q, k, v, o, B, H, g, st);
    case 128: return fwd_d<128>(route, q, k, v, o, B, H, g, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

int ttl_bshd_attention_bwd(const void* q, const void* k, const void* v,
                           const void* dout, void* dq, void* dk, void* dv,
                           void* stats, int dtype, int B, int S, int H, int D,
                           int seq_len, float scale, void* stream) {
  const Geometry g{S, H * D, seq_len, scale, /*causal=*/0};
  auto st = static_cast<cudaStream_t>(stream);
  const int route = route_of(1, dtype, S, D);
  if (route < 0) return (int)cudaErrorInvalidValue;
  switch (D) {
    case 16:
      return bwd_d<16>(route, q, k, v, dout, dq, dk, dv, stats, B, H, g, st);
    case 32:
      return bwd_d<32>(route, q, k, v, dout, dq, dk, dv, stats, B, H, g, st);
    case 64:
      return bwd_d<64>(route, q, k, v, dout, dq, dk, dv, stats, B, H, g, st);
    case 128:
      return bwd_d<128>(route, q, k, v, dout, dq, dk, dv, stats, B, H, g, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// The route a geometry takes: 0 tensor cores, 1 whole-head FMA (f32
// backward), 2 key-tiled FMA; -1 for a dtype or head dim the kernels do not
// take.
int ttl_bshd_attention_route(int backward, int dtype, int S, int D) {
  return route_of(backward, dtype, S, D);
}

const char* ttl_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
