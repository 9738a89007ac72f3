// Device code shared by the attention kernels of this package: the small
// building blocks (tile loads, row dots, warp reductions) and the key-tiled
// f32 FMA forward and backward, which serve any token count.
//
// Users: attention_bshd.cu (K1/K2, heads as column slices of [B, S, H*D]
// rows) and attention_bhsd.cu (K3/K4, contiguous [B, H, S, D] heads, with a
// causal mask). A head is addressed by a pointer to its row 0 and the row
// stride Geometry::HD, so one body serves both layouts.
//
// Masking, as in the Pallas kernels: a key is kept when kpos < seq_len and,
// with Geometry::causal, kpos <= qpos; masked scores are -1e9 before the
// softmax (their probabilities underflow to exactly 0) and masked dS is 0.
// With the causal mask, key tiles that lie wholly past a query tile's last
// row are skipped: every probability in them is exactly 0.
#pragma once
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <math.h>
#include <stddef.h>

namespace {

constexpr int kThreads = 256;
constexpr int kBwdRows = 16;      // query rows per backward tile
constexpr int kDotCols = 4;       // keys per thread and pass in row_dots
constexpr float kMaskValue = -1e9f;
constexpr size_t kMaxSmem = 232448;  // 227 KB: the most one block may use

struct Geometry {
  int S;         // token count (padded, for bshd): rows of each head
  int HD;        // row stride in elements: H*D for [B, S, H*D], D for [B, H, S, D]
  int seq_len;   // keys at positions >= seq_len are masked
  float scale;   // 1/sqrt(D)
  int causal;    // also mask keys at positions > the query's
};

__device__ __forceinline__ bool key_kept(int key, int row, const Geometry& g) {
  return key < g.seq_len && (!g.causal || key <= row);
}

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

// ---------------------------------------------------------------------------
// Key-tiled attention (f32 FMA, any S). Each body works on one head, given by
// pointers to its row 0, and on one tile of query rows or of keys.

constexpr int kTiledRows = 32;     // query rows per block and per tile
constexpr int kTiledKeys = 64;     // keys per forward / phase A stage
constexpr int kTiledKeyRows = 32;  // keys per phase B block
constexpr int kTiledLds = kTiledKeys | 1;

// dst[j][d] = rows j0 + j, j < n, of a head.
template <typename T, int D>
__device__ void load_rows(T* dst, const T* __restrict__ src, int j0, int n,
                          const Geometry& g) {
  constexpr int ld = slab_ld<T, D>();
  for (int e = threadIdx.x; e < n * D; e += kThreads) {
    const int j = e / D, d = e % D;
    dst[j * ld + d] = src[(size_t)(j0 + j) * g.HD + d];
  }
}

// Keys a tile of query rows starting at row0 has to visit.
__device__ __forceinline__ int keys_end(int row0, const Geometry& g) {
  return g.causal ? min(g.S, row0 + kTiledRows) : g.S;
}

// One online-softmax step over a tile of n keys starting at key j0, for the
// query rows row0 + r, one warp per row of s (in place): masked, scaled
// scores; the running max m and sum l per row (alpha = exp(m_old - m_new)
// rescales what came before); P_j = exp(x_j - m_new), rounded to T when
// ROUND. With STORE false only the statistics are kept.
template <int ROWS, typename T, bool ROUND, bool STORE>
__device__ void online_softmax_tile(float* s, int lds, int row0, int j0, int n,
                                    float* m_run, float* l_run, float* alpha,
                                    const Geometry& g) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  for (int r = warp; r < ROWS; r += kThreads / 32) {
    float* row = s + r * lds;
    float mx = -INFINITY;
    for (int j = lane; j < n; j += 32) {
      const float x =
          key_kept(j0 + j, row0 + r, g) ? row[j] * g.scale : kMaskValue;
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

// Forward of one head for the query rows row0 .. row0 + kTiledRows - 1. K and
// V stream through shared memory kTiledKeys at a time; an online softmax
// keeps a running max and sum per row and rescales the f32 accumulator. The
// probabilities are rounded to T before P.V. Every thread of the block calls
// it; smem holds TiledLayout::fwd bytes. It ends with the block in step only
// as far as its own reads of smem: a caller that reuses smem syncs first.
template <typename T, int D>
__device__ void tiled_fwd_body(const T* __restrict__ q, const T* __restrict__ k,
                               const T* __restrict__ v, T* __restrict__ o,
                               int row0, const Geometry& g,
                               unsigned char* smem) {
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

  load_tile<kTiledRows, T, D>(qs, q, row0, g);
  for (int e = threadIdx.x; e < kTiledRows * (D + 1); e += kThreads)
    acc[e] = 0.f;
  for (int r = threadIdx.x; r < kTiledRows; r += kThreads) {
    m_run[r] = -INFINITY;
    l_run[r] = 0.f;
  }
  const int jend = keys_end(row0, g);
  for (int j0 = 0; j0 < jend; j0 += kTiledKeys) {
    const int n = min(kTiledKeys, jend - j0);
    load_rows<T, D>(ks, k, j0, n, g);
    load_rows<T, D>(vs, v, j0, n, g);
    __syncthreads();
    row_dots<kTiledRows, T, D>(qs, ks, ss, kTiledLds, n);
    __syncthreads();
    online_softmax_tile<kTiledRows, T, true, true>(ss, kTiledLds, row0, j0, n,
                                                   m_run, l_run, alpha, g);
    __syncthreads();
    rows_times_slab<kTiledRows, T, D>(ss, kTiledLds, vs, n,
                                      [&](int r, int d, float val) {
      float* a = acc + r * (D + 1) + d;
      *a = *a * alpha[r] + val;
    });
    __syncthreads();
  }
  for (int e = threadIdx.x; e < kTiledRows * D; e += kThreads) {
    const int r = e / D, d = e % D, row = row0 + r;
    if (row < g.S)
      o[(size_t)row * g.HD + d] = from_f32<T>(acc[r * (D + 1) + d] / l_run[r]);
  }
}

// Backward, phase A, of one head for the query rows row0 .. row0 +
// kTiledRows - 1: a first sweep over key tiles gives each row's m and l; a
// second gives P, rs = rowsum(dP * P) and
// dQ = scale * (sum_j P dP k_j - rs * sum_j P k_j), which is dS K without a
// third sweep. m, l and rs of the head's rows go to st_m, st_l, st_rs ([S]
// each), which phase B reads. smem holds TiledLayout::bwd bytes.
template <typename T, int D>
__device__ void tiled_bwd_rows_body(const T* __restrict__ q,
                                    const T* __restrict__ k,
                                    const T* __restrict__ v,
                                    const T* __restrict__ dout,
                                    T* __restrict__ dq, float* st_m,
                                    float* st_l, float* st_rs, int row0,
                                    const Geometry& g, unsigned char* smem) {
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

  load_tile<kTiledRows, T, D>(qs, q, row0, g);
  load_tile<kTiledRows, T, D>(dos, dout, row0, g);
  for (int e = threadIdx.x; e < kTiledRows * (D + 1); e += kThreads) {
    acc_a[e] = 0.f;
    acc_b[e] = 0.f;
  }
  for (int r = threadIdx.x; r < kTiledRows; r += kThreads) {
    m_run[r] = -INFINITY;
    l_run[r] = 0.f;
    rs[r] = 0.f;
  }
  const int jend = keys_end(row0, g);

  // sweep 1: m and l of every row
  for (int j0 = 0; j0 < jend; j0 += kTiledKeys) {
    const int n = min(kTiledKeys, jend - j0);
    load_rows<T, D>(ks, k, j0, n, g);
    __syncthreads();
    row_dots<kTiledRows, T, D>(qs, ks, ps, kTiledLds, n);
    __syncthreads();
    online_softmax_tile<kTiledRows, T, false, false>(
        ps, kTiledLds, row0, j0, n, m_run, l_run, nullptr, g);
    __syncthreads();
  }

  // sweep 2: P = exp(x - m) / l and G = P * dP per key; rs += rowsum(G),
  // A += G K, B += P K
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  for (int j0 = 0; j0 < jend; j0 += kTiledKeys) {
    const int n = min(kTiledKeys, jend - j0);
    load_rows<T, D>(ks, k, j0, n, g);
    load_rows<T, D>(vs, v, j0, n, g);
    __syncthreads();
    row_dots<kTiledRows, T, D>(qs, ks, ps, kTiledLds, n);
    row_dots<kTiledRows, T, D>(dos, vs, gs, kTiledLds, n);
    __syncthreads();
    for (int r = warp; r < kTiledRows; r += kThreads / 32) {
      float* pr = ps + r * kTiledLds;
      float* gr = gs + r * kTiledLds;
      float part = 0.f;
      for (int j = lane; j < n; j += 32) {
        const float pj = key_kept(j0 + j, row0 + r, g)
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

  for (int e = threadIdx.x; e < kTiledRows * D; e += kThreads) {
    const int r = e / D, d = e % D, row = row0 + r;
    if (row < g.S)
      dq[(size_t)row * g.HD + d] = from_f32<T>(
          g.scale * (acc_a[r * (D + 1) + d] - rs[r] * acc_b[r * (D + 1) + d]));
  }
  for (int r = threadIdx.x; r < kTiledRows; r += kThreads) {
    const int row = row0 + r;
    if (row < g.S) {
      st_m[row] = m_run[r];
      st_l[row] = l_run[r];
      st_rs[row] = rs[r];
    }
  }
}

// Backward, phase B, of one head for the keys k0 .. k0 + kTiledKeyRows - 1,
// over all query tiles (with the causal mask, from the key tile's own on):
// P and dS from the statistics of phase A, dV += P^T dO and dK += dS^T Q.
// smem holds TiledLayout::bwd bytes.
template <typename T, int D>
__device__ void tiled_bwd_keys_body(const T* __restrict__ q,
                                    const T* __restrict__ k,
                                    const T* __restrict__ v,
                                    const T* __restrict__ dout,
                                    T* __restrict__ dk, T* __restrict__ dv,
                                    const float* st_m_g, const float* st_l_g,
                                    const float* st_rs_g, int k0,
                                    const Geometry& g, unsigned char* smem) {
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

  const int nk = min(kTiledKeyRows, g.S - k0);
  load_rows<T, D>(ks, k, k0, nk, g);
  load_rows<T, D>(vs, v, k0, nk, g);
  for (int e = threadIdx.x; e < kTiledKeyRows * (D + 1); e += kThreads) {
    acc_dk[e] = 0.f;
    acc_dv[e] = 0.f;
  }
  const int first = g.causal ? (k0 / kTiledRows) * kTiledRows : 0;
  for (int row0 = first; row0 < g.S; row0 += kTiledRows) {
    load_tile<kTiledRows, T, D>(qs, q, row0, g);
    load_tile<kTiledRows, T, D>(dos, dout, row0, g);
    for (int r = threadIdx.x; r < kTiledRows; r += kThreads) {
      const int row = row0 + r < g.S ? row0 + r : 0;
      st_m[r] = st_m_g[row];
      st_l[r] = st_l_g[row];
      st_rs[r] = st_rs_g[row];
    }
    __syncthreads();
    row_dots<kTiledRows, T, D>(qs, ks, ps, ldb, nk);
    row_dots<kTiledRows, T, D>(dos, vs, dss, ldb, nk);
    __syncthreads();
    for (int e = threadIdx.x; e < kTiledRows * nk; e += kThreads) {
      const int r = e / nk, j = e % nk;
      float pv = 0.f, ds = 0.f;
      if (row0 + r < g.S && key_kept(k0 + j, row0 + r, g)) {
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
    const size_t off = (size_t)(k0 + j) * g.HD + d;
    dk[off] = from_f32<T>(acc_dk[j * (D + 1) + d]);
    dv[off] = from_f32<T>(acc_dv[j * (D + 1) + d]);
  }
}

template <typename Kernel> int set_smem(Kernel kernel, size_t smem) {
  return (int)cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

}  // namespace
