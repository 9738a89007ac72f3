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
// (bf16 on the main path), the backward keeps them in f32.
//
// What bounds them on the H100: at the main-path shapes (B = 512 views,
// S = 208, 12 heads of 64) a head's f32 score block is 208 x 208 x 4 B =
// 173 KB, which with its q/k/v does not fit the 227 KB a block may use; so
// every kernel tiles the query rows. The work is 4*S*S*D flops per (batch,
// head) forward for 2*S*D*2 B of k/v, so the kernels are bound by
// arithmetic and by shared-memory traffic feeding it. bf16 inputs run on
// the tensor cores (WMMA, the mma.sync path; wgmma is later work); f32
// inputs, and geometries whose tiles do not fit, run on f32 FMA. Every FMA
// forward, and every backward where not even a whole head's K and V with
// the score rows beside them fit the 227 KB (ViT-L/14@336px), streams K and
// V through key-tiled kernels.
//
// Design:
//   forward, bf16 (bshd_fwd_tc_kernel): grid (head, batch). A block stages
//             one head's K and V in shared memory; each of its 8 warps takes
//             16-row query tiles: Q.K^T on the tensor cores (bf16 -> f32,
//             exact products), the masked softmax in f32 per row, P rounded
//             to bf16, P.V on the tensor cores.
//   backward, bf16 (bshd_bwd_tc_kernel): grid (head, batch), 4 warps. Phase
//             A per query tile: score and dP rows, the softmax statistics,
//             dS, and dQ = dS K; phase B per key tile over all query tiles:
//             P and dS again from the statistics, dV += P^T dO and
//             dK += dS^T Q in registers. f32 operands (P, dS) enter the
//             tensor cores split into two bf16 terms, which keeps f32-grade
//             products.
//   backward, otherwise (bshd_bwd_kernel): one block per (batch, head). K
//             and V stay in shared memory; one f32 [S, D] accumulator is
//             reused by two sweeps over 16-row query tiles. Sweep 1
//             recomputes P and sums dV = P^T dO; sweep 2 recomputes P, forms
//             dS = P*(dP - rowsum(dP*P)) masked and scaled, writes dQ = dS K
//             per tile and sums dK = dS^T Q. Two sweeps (one extra Q K^T)
//             keep the f32 case at 197 KB of shared memory where one
//             accumulator for each of dK and dV would need 251 KB.
//   key-tiled, f32 FMA like the kernel above: every forward the tensor
//             cores do not take (f32 inputs; bf16 past 288 keys), and the
//             backward where neither of the above fits shared memory
//             (ViT-L/14@336px's 592 keys in every dtype, ViT-L/14's 272 in
//             f32):
//     forward (bshd_fwd_tiled_kernel): grid (q-tile, head, batch). K and V
//             stream through shared memory 64 keys at a time; an online
//             softmax keeps a running max m and sum l per query row and
//             rescales the f32 accumulator at each tile. The probabilities
//             exp(s - m) are rounded to the input type before P.V, against
//             the running max (the Pallas kernel rounds exp(s - m) / l
//             against the final one): the two differ by one rounding of each
//             P, within the forward's bound in chip_smoke.py.
//     backward, phase A (bshd_bwd_tiled_rows_kernel): grid (q-tile, head,
//             batch). A first sweep over key tiles gives each query row's m
//             and l; a second gives P, rs = rowsum(dP * P) and
//             dQ = scale * (sum_j P dP k_j - rs * sum_j P k_j), which is
//             dS K without a third sweep. m, l and rs go to a scratch buffer.
//     backward, phase B (bshd_bwd_tiled_keys_kernel): grid (k-tile, head,
//             batch): per 32-key tile over all 32-row query tiles, P and dS
//             from the statistics, dV += P^T dO and dK += dS^T Q.
// The route is chosen per geometry (ttl_bshd_attention_route): tensor cores
// where they fit; then, forward, the key-tiled kernel, and backward the
// whole-head FMA kernel where it fits, else the key-tiled pair. So ViT-B/16's
// 208 keys in bf16 keep the tensor-core kernels. Where both FMA routes fit,
// the key-tiled forward was the faster and the whole-head backward the
// faster (PERF.md). The tensor-core kernels need a head dim that is a
// multiple of 16 and at most 288 keys (ViT-L/14's 272), and fit shared
// memory up to ViT-B's 208 keys in the backward, 288 in the forward.
// Every staged row past S is zero-filled, so no uninitialised memory is read.
//
// C interface (loaded with ctypes): ttl_bshd_attention_fwd,
// ttl_bshd_attention_bwd, ttl_bshd_attention_route and
// ttl_cuda_error_string. The launches go to the caller's stream; each
// launching function returns the cudaError_t of its launches.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>

#include <math.h>
#include <stddef.h>

namespace {

constexpr int kThreads = 256;
constexpr int kBwdRows = 16;      // query rows per backward tile
constexpr int kDotCols = 4;       // keys per thread and pass in row_dots
constexpr float kMaskValue = -1e9f;
constexpr size_t kMaxSmem = 232448;  // 227 KB: the most one block may use

struct Geometry {
  int S;         // padded token count: rows of each [S, H*D] slab
  int HD;        // H*D: row stride in elements
  int seq_len;   // keys at positions >= seq_len are masked
  float scale;   // 1/sqrt(D)
};

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) {
  return x;
}
template <> __device__ __forceinline__ __nv_bfloat16
from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

// Row stride (in elements) of a [S, D] slab of T in shared memory: the pad
// makes the stride an odd number of 32-bit words, so threads reading the same
// column of consecutive rows hit distinct banks.
template <typename T, int D> __host__ __device__ constexpr int slab_ld() {
  return sizeof(T) == 2 ? D + 2 : D + 1;
}

__host__ __device__ constexpr size_t align16(size_t n) {
  return (n + 15) & ~size_t(15);
}

__device__ __forceinline__ float warp_max(float v) {
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

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

// dst[r][d] = f32 of rows row0..row0+ROWS-1, zero past S.
template <int ROWS, typename T, int D>
__device__ void load_tile(float* dst, const T* __restrict__ src, int row0,
                          const Geometry& g) {
  for (int e = threadIdx.x; e < ROWS * D; e += kThreads) {
    const int r = e / D, d = e % D, row = row0 + r;
    dst[r * (D + 1) + d] =
        row < g.S ? to_f32(src[(size_t)row * g.HD + d]) : 0.f;
  }
}

// out[r][j] = sum_d a[r][d] * b[j][d] for r < ROWS, j < S.
// a: f32 tile [ROWS][D+1]; b: slab of T [S][slab_ld].
template <int ROWS, typename T, int D>
__device__ void row_dots(const float* a, const T* b, float* out, int ldo,
                         int S) {
  constexpr int TPR = kThreads / ROWS;  // threads per row
  constexpr int ldb = slab_ld<T, D>();
  const int r = threadIdx.x / TPR, c = threadIdx.x % TPR;
  const float* ar = a + r * (D + 1);
  for (int j0 = c; j0 < S; j0 += kDotCols * TPR) {
    const T* bp[kDotCols];
#pragma unroll
    for (int u = 0; u < kDotCols; ++u) {
      const int j = j0 + u * TPR;
      bp[u] = b + (j < S ? j : 0) * ldb;
    }
    float acc[kDotCols] = {};
#pragma unroll 16
    for (int d = 0; d < D; ++d) {
      const float x = ar[d];
#pragma unroll
      for (int u = 0; u < kDotCols; ++u) acc[u] = fmaf(x, to_f32(bp[u][d]), acc[u]);
    }
#pragma unroll
    for (int u = 0; u < kDotCols; ++u) {
      const int j = j0 + u * TPR;
      if (j < S) out[r * ldo + j] = acc[u];
    }
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

// emit(r, d, sum_j p[r][j] * b[j][d]) for r < ROWS, d < D.
template <int ROWS, typename T, int D, typename Emit>
__device__ void rows_times_slab(const float* p, int ldp, const T* b, int S,
                                Emit emit) {
  constexpr int GROUPS = kThreads / D;
  static_assert(kThreads % D == 0 && ROWS % GROUPS == 0, "tile shape");
  constexpr int RPT = ROWS / GROUPS;  // rows per thread
  constexpr int ldb = slab_ld<T, D>();
  const int d = threadIdx.x % D, g0 = threadIdx.x / D;
  float acc[RPT] = {};
  for (int j = 0; j < S; ++j) {
    const float bv = to_f32(b[j * ldb + d]);
#pragma unroll
    for (int k = 0; k < RPT; ++k)
      acc[k] = fmaf(p[(g0 + k * GROUPS) * ldp + j], bv, acc[k]);
  }
#pragma unroll
  for (int k = 0; k < RPT; ++k) emit(g0 + k * GROUPS, d, acc[k]);
}

// acc[j][d] += sum_r p[r][j] * a[r][d] for j < S, d < D.
// p: f32 [ROWS][ldp]; a: f32 tile [ROWS][D+1]; acc: f32 [S][D+1].
template <int ROWS, int D>
__device__ void accumulate_outer(const float* p, int ldp, const float* a,
                                 float* acc, int S) {
  constexpr int GROUPS = kThreads / D;
  const int d = threadIdx.x % D, jg = threadIdx.x / D;
  float a_col[ROWS];
#pragma unroll
  for (int r = 0; r < ROWS; ++r) a_col[r] = a[r * (D + 1) + d];
  for (int j = jg; j < S; j += GROUPS) {
    float s = 0.f;
#pragma unroll
    for (int r = 0; r < ROWS; ++r) s = fmaf(p[r * ldp + j], a_col[r], s);
    acc[j * (D + 1) + d] += s;
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

// ---------------------------------------------------------------------------
// Tensor-core forward for bf16 inputs (WMMA, 16x16x16 bf16 -> f32). Same
// numerics as the Pallas forward: bf16 products are exact in f32, the scores
// and the softmax stay f32, P is rounded to bf16 before P.V.
//
// One block per (batch, head) with kTcWarps warps; K and V are staged once
// in shared memory (rows S..S16 zero) and each warp takes 16-row query
// tiles in turn: Q.K^T into an f32 score tile, the masked softmax per row,
// P rounded to bf16 in place over the scores, then P.V one 16-column slice
// of the output at a time.

constexpr int kTcWarps = 8;
constexpr int kTcMaxKeys = 288;   // ViT-L/14's 272 keys; 9 per lane in softmax

__host__ __device__ constexpr size_t align128(size_t n) {
  return (n + 127) & ~size_t(127);
}

__host__ __device__ constexpr int round16(int n) { return (n + 15) & ~15; }

// dst[r][0..D) (row stride D+8) = bf16 rows row0 + r of a head slice, for
// r < rows; zero where row0 + r >= S. 16-byte copies, 8 bf16 each: rows
// are 16-byte aligned (the wrapper checks the pointers; D and H*D are
// multiples of 8).
template <int D>
__device__ void stage_rows(__nv_bfloat16* dst, const __nv_bfloat16* src,
                           int row0, int rows, const Geometry& g, int tid,
                           int nthreads) {
  constexpr int ld = D + 8, kVec = 8;
  const uint4 zero4 = make_uint4(0, 0, 0, 0);
  for (int e = tid; e < rows * (D / kVec); e += nthreads) {
    const int r = e / (D / kVec), d = (e % (D / kVec)) * kVec;
    const int row = row0 + r;
    *reinterpret_cast<uint4*>(dst + r * ld + d) =
        row < g.S
            ? *reinterpret_cast<const uint4*>(src + (size_t)row * g.HD + d)
            : zero4;
  }
}

struct TcLayout {
  size_t slab, scores, qtile, stage;
  __host__ __device__ TcLayout(int S, int D)
      : slab(align128(sizeof(__nv_bfloat16) * round16(S) * (D + 8))),
        scores(align128(sizeof(float) * 16 * (round16(S) + 4))),
        qtile(align128(sizeof(__nv_bfloat16) * 16 * (D + 8))),
        stage(align128(sizeof(float) * 16 * 16)) {}
  __host__ __device__ size_t per_warp() const { return scores + qtile + stage; }
  __host__ __device__ size_t total() const {
    return 2 * slab + kTcWarps * per_warp();
  }
};

template <int D>
__global__ void __launch_bounds__(kTcWarps * 32)
bshd_fwd_tc_kernel(const __nv_bfloat16* __restrict__ q,
                   const __nv_bfloat16* __restrict__ k,
                   const __nv_bfloat16* __restrict__ v,
                   __nv_bfloat16* __restrict__ o, Geometry g) {
  using namespace nvcuda;
  using bf16 = __nv_bfloat16;
  extern __shared__ __align__(128) unsigned char smem[];
  constexpr int ldk = D + 8;            // bf16 row stride of K, V, Q tiles
  const int S16 = round16(g.S);
  const int lds = S16 + 4;              // f32 row stride of the scores
  const int ldp = 2 * lds;              // bf16 row stride of P (aliased)
  const TcLayout lay(g.S, D);
  bf16* ks = reinterpret_cast<bf16*>(smem);
  bf16* vs = reinterpret_cast<bf16*>(smem + lay.slab);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  unsigned char* wbase = smem + 2 * lay.slab + warp * lay.per_warp();
  float* sw = reinterpret_cast<float*>(wbase);
  bf16* pw = reinterpret_cast<bf16*>(wbase);
  bf16* qw = reinterpret_cast<bf16*>(wbase + lay.scores);
  float* stage = reinterpret_cast<float*>(wbase + lay.scores + lay.qtile);

  const size_t base = (size_t)blockIdx.y * g.S * g.HD + (size_t)blockIdx.x * D;
  stage_rows<D>(ks, k + base, 0, S16, g, threadIdx.x, blockDim.x);
  stage_rows<D>(vs, v + base, 0, S16, g, threadIdx.x, blockDim.x);
  __syncthreads();

  const int ntiles = S16 / 16;
  for (int t = warp; t < ntiles; t += kTcWarps) {
    const int r0 = t * 16;
    stage_rows<D>(qw, q + base, r0, 16, g, lane, 32);
    __syncwarp();
    wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> qa[D / 16];
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      wmma::load_matrix_sync(qa[kk], qw + kk * 16, ldk);
    for (int n = 0; n < ntiles; ++n) {
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
      wmma::fill_fragment(acc, 0.f);
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> kb;
        wmma::load_matrix_sync(kb, ks + n * 16 * ldk + kk * 16, ldk);
        wmma::mma_sync(acc, qa[kk], kb, acc);
      }
      wmma::store_matrix_sync(sw + n * 16, acc, lds, wmma::mem_row_major);
    }
    __syncwarp();

    // softmax per row; P (bf16) overwrites the front of the row's scores
    for (int r = 0; r < 16; ++r) {
      const float* row = sw + r * lds;
      float x[kTcMaxKeys / 32];
      float m = -INFINITY;
#pragma unroll
      for (int u = 0; u < kTcMaxKeys / 32; ++u) {
        const int j = lane + 32 * u;
        x[u] = j < S16 ? (j < g.seq_len ? row[j] * g.scale : kMaskValue)
                       : -INFINITY;
        m = fmaxf(m, x[u]);
      }
      m = warp_max(m);
      float sum = 0.f;
#pragma unroll
      for (int u = 0; u < kTcMaxKeys / 32; ++u) {
        x[u] = lane + 32 * u < S16 ? expf(x[u] - m) : 0.f;
        sum += x[u];
      }
      sum = warp_sum(sum);
      __syncwarp();  // every lane has read the row before it is overwritten
      bf16* prow = pw + r * ldp;
#pragma unroll
      for (int u = 0; u < kTcMaxKeys / 32; ++u) {
        const int j = lane + 32 * u;
        if (j < S16) prow[j] = __float2bfloat16_rn(x[u] / sum);
      }
      __syncwarp();
    }

    for (int dd = 0; dd < D / 16; ++dd) {
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
      wmma::fill_fragment(acc, 0.f);
      for (int kk = 0; kk < ntiles; ++kk) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> pa;
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> vb;
        wmma::load_matrix_sync(pa, pw + kk * 16, ldp);
        wmma::load_matrix_sync(vb, vs + kk * 16 * ldk + dd * 16, ldk);
        wmma::mma_sync(acc, pa, vb, acc);
      }
      wmma::store_matrix_sync(stage, acc, 16, wmma::mem_row_major);
      __syncwarp();
      for (int e = lane; e < 256; e += 32) {
        const int r = e / 16, c = e % 16;
        if (r0 + r < g.S)
          o[base + (size_t)(r0 + r) * g.HD + dd * 16 + c] =
              __float2bfloat16_rn(stage[e]);
      }
      __syncwarp();
    }
  }
}

// Whether bf16 inputs of this geometry take the tensor-core forward.
template <int D> bool fwd_tc_fits(int S) {
  return D % 16 == 0 && round16(S) <= kTcMaxKeys &&
         TcLayout(S, D).total() <= kMaxSmem;
}

template <int D>
int launch_fwd_tc(const void* q, const void* k, const void* v, void* o,
                  int B, int H, const Geometry& g, cudaStream_t stream) {
  const size_t smem = TcLayout(g.S, D).total();
  auto kernel = bshd_fwd_tc_kernel<D>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<dim3(H, B), kTcWarps * 32, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(o), g);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// Tensor-core backward for bf16 inputs. The products with an f32 operand
// (P^T dO, dS K, dS^T Q) split it into two bf16 terms, x = hi + lo with
// hi = bf16(x) and lo = bf16(x - hi), so the tensor cores see x to about
// 16 bits and the result keeps the f32 kernel's accuracy; products of two
// bf16 inputs (Q K^T, dO V^T) are exact.
//
// One block per (batch, head), kTcBwdWarps warps, K and V staged once.
// Phase A, per 16-row query tile: the score and dP rows, the softmax row
// statistics (max m, sum l) and rs = rowsum(P * dP), dS in f32, then
// dQ = dS K. m, l and rs of every row stay in shared memory.
// Phase B, per 16-key tile, over all query tiles (Q and dO now staged):
// the 16 x 16 score and dP blocks again, P and dS from the row statistics,
// and dV += P^T dO, dK += dS^T Q in register accumulators.

constexpr int kTcBwdWarps = 4;

struct TcBwdLayout {
  int S16, lds;    // lds: row stride of the f32 rows and of the bf16 halves
  size_t slab, stats, scores, tile, stage, per_warp_a, blk, half, per_warp_b,
      region;
  __host__ __device__ TcBwdLayout(int S, int D)
      : S16(round16(S)), lds(round16(S) + 8),
        slab(align128(sizeof(__nv_bfloat16) * round16(S) * (D + 8))),
        stats(align128(sizeof(float) * 3 * round16(S))),
        scores(align128(sizeof(float) * 16 * (round16(S) + 8))),
        tile(align128(sizeof(__nv_bfloat16) * 16 * (D + 8))),
        stage(align128(sizeof(float) * 256)),
        per_warp_a(2 * scores + 2 * tile + stage),
        blk(align128(sizeof(float) * 256)),
        half(align128(sizeof(__nv_bfloat16) * 256)),
        per_warp_b(2 * blk + 4 * half),
        region(kTcBwdWarps * per_warp_a > 2 * slab + kTcBwdWarps * per_warp_b
                   ? kTcBwdWarps * per_warp_a
                   : 2 * slab + kTcBwdWarps * per_warp_b) {}
  __host__ __device__ size_t total() const { return 2 * slab + stats + region; }
};

__device__ __forceinline__ void split_bf16(float x, __nv_bfloat16* hi,
                                           __nv_bfloat16* lo) {
  const __nv_bfloat16 h = __float2bfloat16_rn(x);
  *hi = h;
  *lo = __float2bfloat16_rn(x - __bfloat162float(h));
}

template <int D>
__global__ void __launch_bounds__(kTcBwdWarps * 32)
bshd_bwd_tc_kernel(const __nv_bfloat16* __restrict__ q,
                   const __nv_bfloat16* __restrict__ k,
                   const __nv_bfloat16* __restrict__ v,
                   const __nv_bfloat16* __restrict__ dout,
                   __nv_bfloat16* __restrict__ dq,
                   __nv_bfloat16* __restrict__ dk,
                   __nv_bfloat16* __restrict__ dv, Geometry g) {
  using namespace nvcuda;
  using bf16 = __nv_bfloat16;
  using FragA = wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major>;
  using FragAT = wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::col_major>;
  using FragB = wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major>;
  using FragBT = wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major>;
  using FragC = wmma::fragment<wmma::accumulator, 16, 16, 16, float>;
  extern __shared__ __align__(128) unsigned char smem[];
  constexpr int ldk = D + 8;
  const TcBwdLayout L(g.S, D);
  const int S16 = L.S16, lds = L.lds, nt = S16 / 16;
  bf16* ks = reinterpret_cast<bf16*>(smem);
  bf16* vs = reinterpret_cast<bf16*>(smem + L.slab);
  float* st_m = reinterpret_cast<float*>(smem + 2 * L.slab);
  float* st_l = st_m + S16;
  float* st_rs = st_l + S16;
  unsigned char* region = smem + 2 * L.slab + L.stats;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const size_t base = (size_t)blockIdx.y * g.S * g.HD + (size_t)blockIdx.x * D;

  stage_rows<D>(ks, k + base, 0, S16, g, threadIdx.x, blockDim.x);
  stage_rows<D>(vs, v + base, 0, S16, g, threadIdx.x, blockDim.x);
  __syncthreads();

  // ---- phase A: row statistics, dS and dQ per query tile
  {
    unsigned char* wa = region + warp * L.per_warp_a;
    float* sc = reinterpret_cast<float*>(wa);
    float* dp = reinterpret_cast<float*>(wa + L.scores);
    bf16* qt = reinterpret_cast<bf16*>(wa + 2 * L.scores);
    bf16* dot = reinterpret_cast<bf16*>(wa + 2 * L.scores + L.tile);
    float* stage = reinterpret_cast<float*>(wa + 2 * L.scores + 2 * L.tile);
    bf16* hi = reinterpret_cast<bf16*>(sc);   // over the scores, once read
    bf16* lo = hi + 16 * lds;
    for (int t = warp; t < nt; t += kTcBwdWarps) {
      const int r0 = t * 16;
      stage_rows<D>(qt, q + base, r0, 16, g, lane, 32);
      stage_rows<D>(dot, dout + base, r0, 16, g, lane, 32);
      __syncwarp();
      FragA aq[D / 16], ado[D / 16];
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        wmma::load_matrix_sync(aq[kk], qt + kk * 16, ldk);
        wmma::load_matrix_sync(ado[kk], dot + kk * 16, ldk);
      }
      for (int n = 0; n < nt; ++n) {
        FragC acc_s, acc_p;
        wmma::fill_fragment(acc_s, 0.f);
        wmma::fill_fragment(acc_p, 0.f);
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk) {
          FragBT bk, bv;
          wmma::load_matrix_sync(bk, ks + n * 16 * ldk + kk * 16, ldk);
          wmma::load_matrix_sync(bv, vs + n * 16 * ldk + kk * 16, ldk);
          wmma::mma_sync(acc_s, aq[kk], bk, acc_s);
          wmma::mma_sync(acc_p, ado[kk], bv, acc_p);
        }
        wmma::store_matrix_sync(sc + n * 16, acc_s, lds, wmma::mem_row_major);
        wmma::store_matrix_sync(dp + n * 16, acc_p, lds, wmma::mem_row_major);
      }
      __syncwarp();
      for (int r = 0; r < 16; ++r) {
        float x[kTcMaxKeys / 32], pd[kTcMaxKeys / 32];
        float m = -INFINITY;
#pragma unroll
        for (int u = 0; u < kTcMaxKeys / 32; ++u) {
          const int j = lane + 32 * u;
          x[u] = j < S16 ? (j < g.seq_len ? sc[r * lds + j] * g.scale
                                          : kMaskValue)
                         : -INFINITY;
          pd[u] = j < S16 ? dp[r * lds + j] : 0.f;
          m = fmaxf(m, x[u]);
        }
        m = warp_max(m);
        float l = 0.f;
#pragma unroll
        for (int u = 0; u < kTcMaxKeys / 32; ++u) {
          x[u] = lane + 32 * u < S16 ? expf(x[u] - m) : 0.f;
          l += x[u];
        }
        l = warp_sum(l);
        float rs = 0.f;
#pragma unroll
        for (int u = 0; u < kTcMaxKeys / 32; ++u) {
          x[u] = x[u] / l;           // P
          rs += x[u] * pd[u];
        }
        rs = warp_sum(rs);
#pragma unroll
        for (int u = 0; u < kTcMaxKeys / 32; ++u) {
          const int j = lane + 32 * u;
          if (j < S16)
            dp[r * lds + j] =
                j < g.seq_len ? x[u] * (pd[u] - rs) * g.scale : 0.f;
        }
        if (lane == 0) {
          st_m[r0 + r] = m;
          st_l[r0 + r] = l;
          st_rs[r0 + r] = rs;
        }
      }
      __syncwarp();
      for (int e = lane; e < 16 * S16; e += 32) {
        const int r = e / S16, j = e % S16;
        split_bf16(dp[r * lds + j], hi + r * lds + j, lo + r * lds + j);
      }
      __syncwarp();
      for (int dd = 0; dd < D / 16; ++dd) {
        FragC acc;
        wmma::fill_fragment(acc, 0.f);
        for (int kk = 0; kk < nt; ++kk) {
          FragA a_hi, a_lo;
          FragB b;
          wmma::load_matrix_sync(a_hi, hi + kk * 16, lds);
          wmma::load_matrix_sync(a_lo, lo + kk * 16, lds);
          wmma::load_matrix_sync(b, ks + kk * 16 * ldk + dd * 16, ldk);
          wmma::mma_sync(acc, a_hi, b, acc);
          wmma::mma_sync(acc, a_lo, b, acc);
        }
        wmma::store_matrix_sync(stage, acc, 16, wmma::mem_row_major);
        __syncwarp();
        for (int e = lane; e < 256; e += 32) {
          const int r = e / 16, c = e % 16;
          if (r0 + r < g.S)
            dq[base + (size_t)(r0 + r) * g.HD + dd * 16 + c] =
                __float2bfloat16_rn(stage[e]);
        }
        __syncwarp();
      }
    }
  }
  __syncthreads();

  // ---- phase B: dK and dV per key tile
  bf16* qs = reinterpret_cast<bf16*>(region);
  bf16* dos = reinterpret_cast<bf16*>(region + L.slab);
  stage_rows<D>(qs, q + base, 0, S16, g, threadIdx.x, blockDim.x);
  stage_rows<D>(dos, dout + base, 0, S16, g, threadIdx.x, blockDim.x);
  __syncthreads();
  {
    unsigned char* wb = region + 2 * L.slab + warp * L.per_warp_b;
    float* sblk = reinterpret_cast<float*>(wb);
    float* pblk = reinterpret_cast<float*>(wb + L.blk);
    bf16* p_hi = reinterpret_cast<bf16*>(wb + 2 * L.blk);
    bf16* p_lo = reinterpret_cast<bf16*>(wb + 2 * L.blk + L.half);
    bf16* s_hi = reinterpret_cast<bf16*>(wb + 2 * L.blk + 2 * L.half);
    bf16* s_lo = reinterpret_cast<bf16*>(wb + 2 * L.blk + 3 * L.half);
    for (int kt = warp; kt < nt; kt += kTcBwdWarps) {
      const int k0 = kt * 16;
      FragBT bk[D / 16], bv[D / 16];
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        wmma::load_matrix_sync(bk[kk], ks + k0 * ldk + kk * 16, ldk);
        wmma::load_matrix_sync(bv[kk], vs + k0 * ldk + kk * 16, ldk);
      }
      FragC acc_dv[D / 16], acc_dk[D / 16];
#pragma unroll
      for (int dd = 0; dd < D / 16; ++dd) {
        wmma::fill_fragment(acc_dv[dd], 0.f);
        wmma::fill_fragment(acc_dk[dd], 0.f);
      }
      for (int qt = 0; qt < nt; ++qt) {
        const int q0 = qt * 16;
        FragC acc_s, acc_p;
        wmma::fill_fragment(acc_s, 0.f);
        wmma::fill_fragment(acc_p, 0.f);
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk) {
          FragA a;
          wmma::load_matrix_sync(a, qs + q0 * ldk + kk * 16, ldk);
          wmma::mma_sync(acc_s, a, bk[kk], acc_s);
          wmma::load_matrix_sync(a, dos + q0 * ldk + kk * 16, ldk);
          wmma::mma_sync(acc_p, a, bv[kk], acc_p);
        }
        wmma::store_matrix_sync(sblk, acc_s, 16, wmma::mem_row_major);
        wmma::store_matrix_sync(pblk, acc_p, 16, wmma::mem_row_major);
        __syncwarp();
        for (int e = lane; e < 256; e += 32) {
          const int row = q0 + e / 16, key = k0 + e % 16;
          float p = 0.f, ds = 0.f;
          if (key < g.seq_len) {
            p = expf(sblk[e] * g.scale - st_m[row]) / st_l[row];
            ds = p * (pblk[e] - st_rs[row]) * g.scale;
          }
          split_bf16(p, p_hi + e, p_lo + e);
          split_bf16(ds, s_hi + e, s_lo + e);
        }
        __syncwarp();
#pragma unroll
        for (int dd = 0; dd < D / 16; ++dd) {
          FragAT a_hi, a_lo;   // [query][key] read as [key][query]
          FragB b;
          wmma::load_matrix_sync(b, dos + q0 * ldk + dd * 16, ldk);
          wmma::load_matrix_sync(a_hi, p_hi, 16);
          wmma::load_matrix_sync(a_lo, p_lo, 16);
          wmma::mma_sync(acc_dv[dd], a_hi, b, acc_dv[dd]);
          wmma::mma_sync(acc_dv[dd], a_lo, b, acc_dv[dd]);
          wmma::load_matrix_sync(b, qs + q0 * ldk + dd * 16, ldk);
          wmma::load_matrix_sync(a_hi, s_hi, 16);
          wmma::load_matrix_sync(a_lo, s_lo, 16);
          wmma::mma_sync(acc_dk[dd], a_hi, b, acc_dk[dd]);
          wmma::mma_sync(acc_dk[dd], a_lo, b, acc_dk[dd]);
        }
        __syncwarp();
      }
      for (int dd = 0; dd < D / 16; ++dd) {
        for (int which = 0; which < 2; ++which) {
          wmma::store_matrix_sync(sblk, which ? acc_dk[dd] : acc_dv[dd], 16,
                                  wmma::mem_row_major);
          __syncwarp();
          bf16* out = which ? dk : dv;
          for (int e = lane; e < 256; e += 32) {
            const int r = e / 16, c = e % 16;
            if (k0 + r < g.S)
              out[base + (size_t)(k0 + r) * g.HD + dd * 16 + c] =
                  __float2bfloat16_rn(sblk[e]);
          }
          __syncwarp();
        }
      }
    }
  }
}

template <int D> bool bwd_tc_fits(int S) {
  return D % 16 == 0 && round16(S) <= kTcMaxKeys &&
         TcBwdLayout(S, D).total() <= kMaxSmem;
}

template <int D>
int launch_bwd_tc(const void* q, const void* k, const void* v,
                  const void* dout, void* dq, void* dk, void* dv, int B,
                  int H, const Geometry& g, cudaStream_t stream) {
  using bf16 = __nv_bfloat16;
  const size_t smem = TcBwdLayout(g.S, D).total();
  auto kernel = bshd_bwd_tc_kernel<D>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<dim3(H, B), kTcBwdWarps * 32, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<const bf16*>(dout),
      static_cast<bf16*>(dq), static_cast<bf16*>(dk), static_cast<bf16*>(dv),
      g);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// Key-tiled kernels (f32 FMA, any S): the forward for every geometry the
// tensor cores do not take; the backward for geometries where a whole
// head's K and V with the score rows beside them do not fit shared memory.

constexpr int kTiledRows = 32;     // query rows per block and per tile
constexpr int kTiledKeys = 64;     // keys per forward / phase A stage
constexpr int kTiledKeyRows = 32;  // keys per phase B block
constexpr int kTiledLds = kTiledKeys | 1;

// dst[j][d] = head slice of rows j0 + j, j < n, of a [S, H*D] slab.
template <typename T, int D>
__device__ void load_rows(T* dst, const T* __restrict__ src, int j0, int n,
                          const Geometry& g) {
  constexpr int ld = slab_ld<T, D>();
  for (int e = threadIdx.x; e < n * D; e += kThreads) {
    const int j = e / D, d = e % D;
    dst[j * ld + d] = src[(size_t)(j0 + j) * g.HD + d];
  }
}

// One online-softmax step over a tile of n keys starting at key j0, one
// warp per row of s (in place): masked, scaled scores; the running max m
// and sum l per row (alpha = exp(m_old - m_new) rescales what came before);
// P_j = exp(x_j - m_new), rounded to T when ROUND. With STORE false only
// the statistics are kept.
template <int ROWS, typename T, bool ROUND, bool STORE>
__device__ void online_softmax_tile(float* s, int lds, int j0, int n,
                                    float* m_run, float* l_run, float* alpha,
                                    const Geometry& g) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  for (int r = warp; r < ROWS; r += kThreads / 32) {
    float* row = s + r * lds;
    float mx = -INFINITY;
    for (int j = lane; j < n; j += 32) {
      const float x = j0 + j < g.seq_len ? row[j] * g.scale : kMaskValue;
      row[j] = x;
      mx = fmaxf(mx, x);
    }
    mx = warp_max(mx);
    const float m_old = m_run[r];
    const float m_new = fmaxf(m_old, mx);
    float sum = 0.f;
    for (int j = lane; j < n; j += 32) {
      const float e = expf(row[j] - m_new);
      sum += e;
      if (STORE) row[j] = ROUND ? to_f32(from_f32<T>(e)) : e;
    }
    sum = warp_sum(sum);
    __syncwarp();
    if (lane == 0) {
      const float a = expf(m_old - m_new);  // 0 at the first tile
      if (alpha != nullptr) alpha[r] = a;
      l_run[r] = l_run[r] * a + sum;
      m_run[r] = m_new;
    }
  }
}

struct TiledLayout {
  size_t kv, tile, s, fwd, bwd;
  template <typename T, int D>
  __host__ __device__ static TiledLayout make() {
    TiledLayout l;
    l.kv = align16(sizeof(T) * kTiledKeys * slab_ld<T, D>());
    l.tile = align16(sizeof(float) * kTiledRows * (D + 1));
    l.s = align16(sizeof(float) * kTiledRows * kTiledLds);
    const size_t stats = sizeof(float) * 3 * kTiledRows;
    // forward: K, V stages; Q tile; scores; accumulator; m, l, alpha
    l.fwd = 2 * l.kv + 2 * l.tile + l.s + stats;
    // backward, both phases: K, V (stages, or 32-key tiles); Q, dO tiles;
    // two score blocks; two accumulators; three row statistics
    l.bwd = 2 * l.kv + 4 * l.tile + 2 * l.s + stats;
    return l;
  }
};

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
bshd_fwd_tiled_kernel(const T* __restrict__ q, const T* __restrict__ k,
                      const T* __restrict__ v, T* __restrict__ o,
                      Geometry g) {
  extern __shared__ __align__(16) unsigned char smem[];
  const TiledLayout L = TiledLayout::make<T, D>();
  unsigned char* p = smem;
  T* ks = reinterpret_cast<T*>(p);          p += L.kv;
  T* vs = reinterpret_cast<T*>(p);          p += L.kv;
  float* qs = reinterpret_cast<float*>(p);  p += L.tile;
  float* acc = reinterpret_cast<float*>(p); p += L.tile;
  float* ss = reinterpret_cast<float*>(p);  p += L.s;
  float* m_run = reinterpret_cast<float*>(p);
  float* l_run = m_run + kTiledRows;
  float* alpha = l_run + kTiledRows;

  const int row0 = blockIdx.x * kTiledRows;
  const size_t base = (size_t)blockIdx.z * g.S * g.HD + (size_t)blockIdx.y * D;
  load_tile<kTiledRows, T, D>(qs, q + base, row0, g);
  for (int e = threadIdx.x; e < kTiledRows * (D + 1); e += kThreads)
    acc[e] = 0.f;
  for (int r = threadIdx.x; r < kTiledRows; r += kThreads) {
    m_run[r] = -INFINITY;
    l_run[r] = 0.f;
  }
  for (int j0 = 0; j0 < g.S; j0 += kTiledKeys) {
    const int n = min(kTiledKeys, g.S - j0);
    load_rows<T, D>(ks, k + base, j0, n, g);
    load_rows<T, D>(vs, v + base, j0, n, g);
    __syncthreads();
    row_dots<kTiledRows, T, D>(qs, ks, ss, kTiledLds, n);
    __syncthreads();
    online_softmax_tile<kTiledRows, T, true, true>(ss, kTiledLds, j0, n,
                                                   m_run, l_run, alpha, g);
    __syncthreads();
    rows_times_slab<kTiledRows, T, D>(ss, kTiledLds, vs, n,
                                      [&](int r, int d, float val) {
      float* a = acc + r * (D + 1) + d;
      *a = *a * alpha[r] + val;
    });
    __syncthreads();
  }
  T* ob = o + base;
  for (int e = threadIdx.x; e < kTiledRows * D; e += kThreads) {
    const int r = e / D, d = e % D, row = row0 + r;
    if (row < g.S)
      ob[(size_t)row * g.HD + d] =
          from_f32<T>(acc[r * (D + 1) + d] / l_run[r]);
  }
}

// Phase A: per 32-row query tile, the softmax statistics, rs and dQ.
// stats: [3][B*H][S] f32 scratch (m, l, rs), read by phase B.
template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
bshd_bwd_tiled_rows_kernel(const T* __restrict__ q, const T* __restrict__ k,
                           const T* __restrict__ v,
                           const T* __restrict__ dout, T* __restrict__ dq,
                           float* __restrict__ stats, Geometry g) {
  extern __shared__ __align__(16) unsigned char smem[];
  const TiledLayout L = TiledLayout::make<T, D>();
  unsigned char* p = smem;
  T* ks = reinterpret_cast<T*>(p);            p += L.kv;
  T* vs = reinterpret_cast<T*>(p);            p += L.kv;
  float* qs = reinterpret_cast<float*>(p);    p += L.tile;
  float* dos = reinterpret_cast<float*>(p);   p += L.tile;
  float* acc_a = reinterpret_cast<float*>(p); p += L.tile;
  float* acc_b = reinterpret_cast<float*>(p); p += L.tile;
  float* ps = reinterpret_cast<float*>(p);    p += L.s;
  float* gs = reinterpret_cast<float*>(p);    p += L.s;
  float* m_run = reinterpret_cast<float*>(p);
  float* l_run = m_run + kTiledRows;
  float* rs = l_run + kTiledRows;

  const int row0 = blockIdx.x * kTiledRows;
  const size_t bh = (size_t)blockIdx.z * gridDim.y + blockIdx.y;
  const size_t plane = (size_t)gridDim.z * gridDim.y * g.S;
  const size_t base = (size_t)blockIdx.z * g.S * g.HD + (size_t)blockIdx.y * D;
  load_tile<kTiledRows, T, D>(qs, q + base, row0, g);
  load_tile<kTiledRows, T, D>(dos, dout + base, row0, g);
  for (int e = threadIdx.x; e < kTiledRows * (D + 1); e += kThreads) {
    acc_a[e] = 0.f;
    acc_b[e] = 0.f;
  }
  for (int r = threadIdx.x; r < kTiledRows; r += kThreads) {
    m_run[r] = -INFINITY;
    l_run[r] = 0.f;
    rs[r] = 0.f;
  }

  // sweep 1: m and l of every row
  for (int j0 = 0; j0 < g.S; j0 += kTiledKeys) {
    const int n = min(kTiledKeys, g.S - j0);
    load_rows<T, D>(ks, k + base, j0, n, g);
    __syncthreads();
    row_dots<kTiledRows, T, D>(qs, ks, ps, kTiledLds, n);
    __syncthreads();
    online_softmax_tile<kTiledRows, T, false, false>(
        ps, kTiledLds, j0, n, m_run, l_run, nullptr, g);
    __syncthreads();
  }

  // sweep 2: P = exp(x - m) / l and G = P * dP per key; rs += rowsum(G),
  // A += G K, B += P K
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  for (int j0 = 0; j0 < g.S; j0 += kTiledKeys) {
    const int n = min(kTiledKeys, g.S - j0);
    load_rows<T, D>(ks, k + base, j0, n, g);
    load_rows<T, D>(vs, v + base, j0, n, g);
    __syncthreads();
    row_dots<kTiledRows, T, D>(qs, ks, ps, kTiledLds, n);
    row_dots<kTiledRows, T, D>(dos, vs, gs, kTiledLds, n);
    __syncthreads();
    for (int r = warp; r < kTiledRows; r += kThreads / 32) {
      float* pr = ps + r * kTiledLds;
      float* gr = gs + r * kTiledLds;
      float part = 0.f;
      for (int j = lane; j < n; j += 32) {
        const float pj = j0 + j < g.seq_len
                             ? expf(pr[j] * g.scale - m_run[r]) / l_run[r]
                             : 0.f;
        const float gj = pj * gr[j];
        pr[j] = pj;
        gr[j] = gj;
        part += gj;
      }
      part = warp_sum(part);
      if (lane == 0) rs[r] += part;
    }
    __syncthreads();
    rows_times_slab<kTiledRows, T, D>(gs, kTiledLds, ks, n,
                                      [&](int r, int d, float val) {
      acc_a[r * (D + 1) + d] += val;
    });
    rows_times_slab<kTiledRows, T, D>(ps, kTiledLds, ks, n,
                                      [&](int r, int d, float val) {
      acc_b[r * (D + 1) + d] += val;
    });
    __syncthreads();
  }

  T* dqb = dq + base;
  for (int e = threadIdx.x; e < kTiledRows * D; e += kThreads) {
    const int r = e / D, d = e % D, row = row0 + r;
    if (row < g.S)
      dqb[(size_t)row * g.HD + d] = from_f32<T>(
          g.scale * (acc_a[r * (D + 1) + d] - rs[r] * acc_b[r * (D + 1) + d]));
  }
  for (int r = threadIdx.x; r < kTiledRows; r += kThreads) {
    const int row = row0 + r;
    if (row < g.S) {
      const size_t i = bh * g.S + row;
      stats[i] = m_run[r];
      stats[plane + i] = l_run[r];
      stats[2 * plane + i] = rs[r];
    }
  }
}

// Phase B: per 32-key tile, dK and dV over all query tiles.
template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
bshd_bwd_tiled_keys_kernel(const T* __restrict__ q, const T* __restrict__ k,
                           const T* __restrict__ v,
                           const T* __restrict__ dout, T* __restrict__ dk,
                           T* __restrict__ dv,
                           const float* __restrict__ stats, Geometry g) {
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr int ldb = kTiledKeyRows + 1;  // row stride of the P, dS blocks
  const TiledLayout L = TiledLayout::make<T, D>();
  unsigned char* p = smem;
  T* ks = reinterpret_cast<T*>(p);             p += L.kv;
  T* vs = reinterpret_cast<T*>(p);             p += L.kv;
  float* qs = reinterpret_cast<float*>(p);     p += L.tile;
  float* dos = reinterpret_cast<float*>(p);    p += L.tile;
  float* acc_dk = reinterpret_cast<float*>(p); p += L.tile;
  float* acc_dv = reinterpret_cast<float*>(p); p += L.tile;
  float* ps = reinterpret_cast<float*>(p);     p += L.s;
  float* dss = reinterpret_cast<float*>(p);    p += L.s;
  float* st_m = reinterpret_cast<float*>(p);
  float* st_l = st_m + kTiledRows;
  float* st_rs = st_l + kTiledRows;

  const int k0 = blockIdx.x * kTiledKeyRows;
  const int nk = min(kTiledKeyRows, g.S - k0);
  const size_t bh = (size_t)blockIdx.z * gridDim.y + blockIdx.y;
  const size_t plane = (size_t)gridDim.z * gridDim.y * g.S;
  const size_t base = (size_t)blockIdx.z * g.S * g.HD + (size_t)blockIdx.y * D;
  load_rows<T, D>(ks, k + base, k0, nk, g);
  load_rows<T, D>(vs, v + base, k0, nk, g);
  for (int e = threadIdx.x; e < kTiledKeyRows * (D + 1); e += kThreads) {
    acc_dk[e] = 0.f;
    acc_dv[e] = 0.f;
  }
  for (int row0 = 0; row0 < g.S; row0 += kTiledRows) {
    load_tile<kTiledRows, T, D>(qs, q + base, row0, g);
    load_tile<kTiledRows, T, D>(dos, dout + base, row0, g);
    for (int r = threadIdx.x; r < kTiledRows; r += kThreads) {
      const int row = row0 + r < g.S ? row0 + r : 0;
      const size_t i = bh * g.S + row;
      st_m[r] = stats[i];
      st_l[r] = stats[plane + i];
      st_rs[r] = stats[2 * plane + i];
    }
    __syncthreads();
    row_dots<kTiledRows, T, D>(qs, ks, ps, ldb, nk);
    row_dots<kTiledRows, T, D>(dos, vs, dss, ldb, nk);
    __syncthreads();
    for (int e = threadIdx.x; e < kTiledRows * nk; e += kThreads) {
      const int r = e / nk, j = e % nk;
      float pv = 0.f, ds = 0.f;
      if (row0 + r < g.S && k0 + j < g.seq_len) {
        pv = expf(ps[r * ldb + j] * g.scale - st_m[r]) / st_l[r];
        ds = pv * (dss[r * ldb + j] - st_rs[r]) * g.scale;
      }
      ps[r * ldb + j] = pv;
      dss[r * ldb + j] = ds;
    }
    __syncthreads();
    accumulate_outer<kTiledRows, D>(ps, ldb, dos, acc_dv, nk);
    accumulate_outer<kTiledRows, D>(dss, ldb, qs, acc_dk, nk);
    __syncthreads();
  }
  for (int e = threadIdx.x; e < nk * D; e += kThreads) {
    const int j = e / D, d = e % D;
    const size_t off = base + (size_t)(k0 + j) * g.HD + d;
    dk[off] = from_f32<T>(acc_dk[j * (D + 1) + d]);
    dv[off] = from_f32<T>(acc_dv[j * (D + 1) + d]);
  }
}

// Routes, in the order they are tried.
enum Route { kRouteTensorCore = 0, kRouteWholeHead = 1, kRouteKeyTiled = 2 };

template <typename T, int D> int fwd_route(int S) {
  if (sizeof(T) == 2 && fwd_tc_fits<D>(S)) return kRouteTensorCore;
  return kRouteKeyTiled;
}

template <typename T, int D> int bwd_route(int S) {
  if (sizeof(T) == 2 && bwd_tc_fits<D>(S)) return kRouteTensorCore;
  if (bwd_smem_bytes<T, D>(S) <= kMaxSmem) return kRouteWholeHead;
  return kRouteKeyTiled;
}

template <typename Kernel> int set_smem(Kernel kernel, size_t smem) {
  return (int)cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
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

template <typename T, int D>
int launch_fwd(const void* q, const void* k, const void* v, void* o, int B,
               int H, const Geometry& g, cudaStream_t stream) {
  if (fwd_route<T, D>(g.S) == kRouteTensorCore)
    return launch_fwd_tc<D>(q, k, v, o, B, H, g, stream);
  return launch_fwd_tiled<T, D>(q, k, v, o, B, H, g, stream);
}

template <typename T, int D>
int launch_bwd(const void* q, const void* k, const void* v, const void* dout,
               void* dq, void* dk, void* dv, void* stats, int B, int H,
               const Geometry& g, cudaStream_t stream) {
  const int route = bwd_route<T, D>(g.S);
  if (route == kRouteTensorCore)
    return launch_bwd_tc<D>(q, k, v, dout, dq, dk, dv, B, H, g, stream);
  if (route == kRouteKeyTiled)
    return launch_bwd_tiled<T, D>(q, k, v, dout, dq, dk, dv, stats, B, H, g,
                                  stream);
  const size_t smem = bwd_smem_bytes<T, D>(g.S);
  auto kernel = bshd_bwd_kernel<T, D>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(H, B);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(dout),
      static_cast<T*>(dq), static_cast<T*>(dk), static_cast<T*>(dv), g);
  return (int)cudaGetLastError();
}

template <typename T>
int fwd_for_type(const void* q, const void* k, const void* v, void* o, int B,
                 int H, int D, const Geometry& g, cudaStream_t st) {
  switch (D) {
    case 16: return launch_fwd<T, 16>(q, k, v, o, B, H, g, st);
    case 32: return launch_fwd<T, 32>(q, k, v, o, B, H, g, st);
    case 64: return launch_fwd<T, 64>(q, k, v, o, B, H, g, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

template <typename T>
int bwd_for_type(const void* q, const void* k, const void* v,
                 const void* dout, void* dq, void* dk, void* dv, void* stats,
                 int B, int H, int D, const Geometry& g, cudaStream_t st) {
  switch (D) {
    case 16:
      return launch_bwd<T, 16>(q, k, v, dout, dq, dk, dv, stats, B, H, g, st);
    case 32:
      return launch_bwd<T, 32>(q, k, v, dout, dq, dk, dv, stats, B, H, g, st);
    case 64:
      return launch_bwd<T, 64>(q, k, v, dout, dq, dk, dv, stats, B, H, g, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

template <typename T> int route_for_type(int backward, int S, int D) {
  switch (D) {
    case 16: return backward ? bwd_route<T, 16>(S) : fwd_route<T, 16>(S);
    case 32: return backward ? bwd_route<T, 32>(S) : fwd_route<T, 32>(S);
    case 64: return backward ? bwd_route<T, 64>(S) : fwd_route<T, 64>(S);
    default: return -1;
  }
}

}  // namespace

extern "C" {

int ttl_bshd_attention_fwd(const void* q, const void* k, const void* v,
                           void* o, int dtype, int B, int S, int H, int D,
                           int seq_len, float scale, void* stream) {
  const Geometry g{S, H * D, seq_len, scale};
  auto st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return fwd_for_type<float>(q, k, v, o, B, H, D, g, st);
  if (dtype == 1)
    return fwd_for_type<__nv_bfloat16>(q, k, v, o, B, H, D, g, st);
  return (int)cudaErrorInvalidValue;
}

// stats: scratch of 3 * B * H * S floats, written and read only by the
// key-tiled route.
int ttl_bshd_attention_bwd(const void* q, const void* k, const void* v,
                           const void* dout, void* dq, void* dk, void* dv,
                           void* stats, int dtype, int B, int S, int H, int D,
                           int seq_len, float scale, void* stream) {
  const Geometry g{S, H * D, seq_len, scale};
  auto st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return bwd_for_type<float>(q, k, v, dout, dq, dk, dv, stats, B, H, D, g,
                               st);
  if (dtype == 1)
    return bwd_for_type<__nv_bfloat16>(q, k, v, dout, dq, dk, dv, stats, B,
                                       H, D, g, st);
  return (int)cudaErrorInvalidValue;
}

// The route a geometry takes: 0 tensor cores, 1 whole-head FMA (backward
// only), 2 key-tiled FMA; -1 for a dtype or head dim the kernels do not take.
int ttl_bshd_attention_route(int backward, int dtype, int S, int D) {
  if (dtype == 0) return route_for_type<float>(backward, S, D);
  if (dtype == 1) return route_for_type<__nv_bfloat16>(backward, S, D);
  return -1;
}

const char* ttl_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
