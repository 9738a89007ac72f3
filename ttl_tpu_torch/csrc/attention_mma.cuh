// Tensor-core attention for bf16 heads on Hopper (sm_90a): the device code
// behind the bf16 routes of attention_bshd.cu (K1/K2) and attention_bhsd.cu
// (K3/K4), forward and backward.
//
// Every product runs on mma.sync.m16n8k16 (bf16 operands, f32 accumulators),
// every tile reaches shared memory through cp.async in 16-byte requests, and
// scores and probabilities live in registers only: the accumulator layout of
// Q.K^T is the A-operand layout of the product that follows (mma_sm90.cuh).
//
// Addressing, as in attention_tiled.cuh: a head is a pointer to its row 0 and
// the row stride Geometry::HD, with Geometry::seq_len the key limit and
// Geometry::causal the mask, so contiguous [B, H, S, D] heads and column
// slices of [B, S, H*D] rows are served alike (HeadLayout gives a head's
// offset). Head bases and row strides are multiples of 16 bytes.
//
// The three kernels share one shape. A block of W warps owns a tile of
// 16 * W rows of one head, 16 rows a warp; the tile goes once to shared
// memory and from there into ldmatrix fragments that stay in registers. The
// other side streams past in stages of KT rows through a two-stage cp.async
// ring: the copy of stage i + 1 is under way while stage i is multiplied,
// one barrier a stage. Rows of 2 * D bytes are padded by 16 bytes, which
// puts the eight rows of an ldmatrix block on different banks. A block walks
// `nh` heads (1 for the per_head grid, H for the heads grid) as one flat
// sequence of stages, so the ring also runs from one head into the next.
// Rows past S are staged as zeros and never stored; keys past S score -inf.
//
//   forward   tile: query rows; stream: K, V. Online softmax against the
//             running max m: S = Q.K^T in accumulators, masked and scaled,
//             alpha = exp(m_old - m_new) rescales O and l, P = exp(x - m_new)
//             is rounded to bf16 in registers and multiplied into V
//             (ldmatrix.trans); O / l is stored once. Across stages the
//             rounding is against the running max (the Pallas kernel rounds
//             exp(x - m) / l against the final one): one rounding of each P
//             either way, within the forward's bound. A head that fits one
//             stage has its final m and l in registers before the product,
//             so there P = exp(x - m) / l is rounded as the Pallas kernel
//             and the plain version round it.
//   backward, rows kernel   tile: query rows (Q, dO); stream: K, V. One
//             sweep: e = exp(x - m) against the running max, dP = dO.V^T,
//             A += (e * dP) K and B += e K, l += rowsum(e),
//             r += rowsum(e * dP), all rescaled by alpha; at the end
//             rs = r / l = rowsum(P * dP) and
//             dQ = scale * (A - rs * B) / l, which is dS K. dS does not
//             change when dP and rs move by the same constant, so the sweep
//             works on dP - c with c the row's dP at key 0: the two terms
//             of dQ then cancel less, and exactly where a row has one key.
//             m, l and rs (+ c) of every row go to the statistics buffer.
//   backward, keys kernel   tile: keys (K, V); stream: Q, dO and the rows'
//             statistics. Transposed blocks S^T = K.Q^T and dP^T = V.dO^T
//             land in accumulators, P^T = exp(x - m) / l and
//             dS^T = P^T (dP^T - rs) scale are formed there and are the A
//             operands of dV += P^T dO and dK += dS^T Q.
// So Q.K^T and dO.V^T are each computed twice in the backward. The f32
// factors (e, e * dP, P, dS) enter the tensor cores as two bf16 terms,
// x = hi + lo with hi = bf16(x) and lo = bf16(x - hi): about 16 bits of x,
// f32-grade products, as the bshd backward does. Masked scores are -1e9
// (their probabilities underflow to exactly 0) and masked dS is 0. With the
// causal mask, stages and 16-row blocks that lie wholly on the masked side
// are skipped.
//
// Tile heights per geometry (MmaShort, MmaLong, MmaWide, MmaLongBwd,
// MmaD128; the rule is mma_attention_fwd / _bwd at the end): S <= 32 takes
// W = 2 warps and stages of 32 rows, so that the text towers' short heads
// are not paid a 64-row tile half empty. Longer heads take stages of 64
// rows in the forward, with W = 8 (128 query rows a block) where 128-row
// tiles cover S with no more padding than 64-row ones (an even number of
// 64-row tiles: 197, 208, 577, 592 tokens), else W = 4 (64, 257, 272); and
// W = 4 with stages of 32 rows in the backward, whose kernels hold two
// accumulator tiles and two score blocks a lane: at 64 rows a stage they
// need 200 to 212 registers a lane and two blocks fit an SM.
//
// Head dim 128 (AIMv2's) doubles every fragment and accumulator tile of a
// lane: an O tile is 64 registers, a resident A operand 32. The forward
// still holds Q's fragments, on its own rule (MmaD128, mma_attention_fwd):
// W = 4 and stages of 32 keys at every S past 32, 12 % faster at AIMv2-L/14's
// [512, 256, 8 x 128] than stages of 64 (whose 32 score registers a lane
// took it to 180) and than W = 8 (tools/torch_attention_tiles.py, PERF.md).
// The backward's kernels would hold two A operands and two accumulator
// tiles, 192 registers before the scores: at D = 128 they read the resident
// tile's fragments from shared memory at each k step instead
// (mma_frags_held), one ldmatrix more a product, with stages of 32 rows as
// at 64.
#pragma once
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <math.h>
#include <stddef.h>

#include "attention_tiled.cuh"
#include "mma_sm90.cuh"

namespace {

using bf16 = __nv_bfloat16;

// Where head `bh` (batch element bh / H, head bh % H) starts, in elements.
struct HeadLayout {
  int H;
  size_t batch_stride, head_stride;
  __device__ __forceinline__ size_t offset(int bh) const {
    return (size_t)(bh / H) * batch_stride + (size_t)(bh % H) * head_stride;
  }
};

__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}

__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

// (x0, x1) as two packed bf16 pairs with hi + lo = x to about 16 bits
__device__ __forceinline__ void split_pack(float x0, float x1, unsigned& hi,
                                           unsigned& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x0, x1);
  const float2 hf = __bfloat1622float2(h);
  hi = *reinterpret_cast<const unsigned*>(&h);
  lo = pack_bf16x2(x0 - hf.x, x1 - hf.y);
}

// dst[r][0..D) (row stride D + 8) = rows row0 + r, r < ROWS, of a head;
// zeros where row0 + r >= limit. Every thread of the block's NT calls it.
template <int D, int ROWS, int NT>
__device__ __forceinline__ void stage_tile(bf16* dst,
                                           const bf16* __restrict__ src,
                                           int row0, int limit, int stride) {
  constexpr int kChunks = D / 8;
  for (int e = threadIdx.x; e < ROWS * kChunks; e += NT) {
    const int r = e / kChunks, c = (e % kChunks) * 8;
    bf16* d = dst + r * (D + 8) + c;
    if (row0 + r < limit)
      cp_async16(d, src + (size_t)(row0 + r) * stride + c);
    else
      *reinterpret_cast<uint4*>(d) = make_uint4(0, 0, 0, 0);
  }
}

// Whether the backward's kernels hold their resident tiles' A fragments in
// registers for a whole head (D <= 64), or read them from the staged tile at
// each k step (D = 128, see the top).
__host__ __device__ constexpr bool mma_frags_held(int D) { return D <= 64; }

// The A fragments of the warp's 16 rows of a staged tile (tile_w: its row 0).
template <int D>
__device__ __forceinline__ void load_a_frags(unsigned (&a)[D / 16][4],
                                             const bf16* tile_w, int lane) {
  const unsigned base =
      smem_addr(tile_w + (lane % 16) * (D + 8) + (lane / 16) * 8);
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) ldmatrix_x4(a[kk], base + 2u * kk * 16);
}

// acc0, acc1 += a (16 x D) * rows^T, for the 16 staged rows at `rows`:
// acc0 their first 8, acc1 the other 8. rows is [.][D + 8].
template <int D>
__device__ __forceinline__ void mma_a_rows_t(float (&acc0)[4],
                                             float (&acc1)[4],
                                             const unsigned (&a)[D / 16][4],
                                             const bf16* rows, int lane) {
  const unsigned base = smem_addr(
      rows + ((lane % 8) + (lane / 16) * 8) * (D + 8) + ((lane / 8) % 2) * 8);
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    unsigned b[4];
    ldmatrix_x4(b, base + 2u * kk * 16);
    mma_bf16(acc0, a[kk], b[0], b[1]);
    mma_bf16(acc1, a[kk], b[2], b[3]);
  }
}

// mma_a_rows_t with a's fragments read from the warp's 16 staged rows at
// tile_w at each k step, where they are not held in registers
template <int D>
__device__ __forceinline__ void mma_staged_rows_t(float (&acc0)[4],
                                                  float (&acc1)[4],
                                                  const bf16* tile_w,
                                                  const bf16* rows, int lane) {
  const unsigned a_base =
      smem_addr(tile_w + (lane % 16) * (D + 8) + (lane / 16) * 8);
  const unsigned base = smem_addr(
      rows + ((lane % 8) + (lane / 16) * 8) * (D + 8) + ((lane / 8) % 2) * 8);
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    unsigned a[4], b[4];
    ldmatrix_x4(a, a_base + 2u * kk * 16);
    ldmatrix_x4(b, base + 2u * kk * 16);
    mma_bf16(acc0, a, b[0], b[1]);
    mma_bf16(acc1, a, b[2], b[3]);
  }
}

// acc (16 x D) += (hi [+ lo]) (16 x 16) * rows (16 x D), the 16 staged rows
// at `rows` as the B operand through ldmatrix.trans.
template <int D, bool SPLIT>
__device__ __forceinline__ void mma_p_rows(float (&acc)[D / 8][4],
                                           const unsigned (&hi)[4],
                                           const unsigned (&lo)[4],
                                           const bf16* rows, int lane) {
  const unsigned base =
      smem_addr(rows + (lane % 16) * (D + 8) + (lane / 16) * 8);
#pragma unroll
  for (int dd = 0; dd < D / 16; ++dd) {
    unsigned b[4];
    ldmatrix_x4_trans(b, base + 2u * dd * 16);
    mma_bf16(acc[2 * dd], hi, b[0], b[1]);
    mma_bf16(acc[2 * dd + 1], hi, b[2], b[3]);
    if (SPLIT) {
      mma_bf16(acc[2 * dd], lo, b[0], b[1]);
      mma_bf16(acc[2 * dd + 1], lo, b[2], b[3]);
    }
  }
}

// The warp's 16 x D accumulator tile, rows g and g + 8 scaled by f_lo and
// f_hi, rounded to bf16 into the warp's 16 rows of a staged tile that it no
// longer reads (tile_w), and from there to rows row0_w.. of `out`, those
// below `limit`, 16 bytes a lane.
template <int D>
__device__ __forceinline__ void store_tile(bf16* tile_w,
                                           const float (&acc)[D / 8][4],
                                           float f_lo, float f_hi,
                                           bf16* __restrict__ out, int stride,
                                           int row0_w, int limit, int lane) {
  constexpr int LD = D + 8, kChunks = D / 8;
  const int g = lane / 4, t = lane % 4;
#pragma unroll
  for (int j = 0; j < D / 8; ++j) {
    *reinterpret_cast<unsigned*>(tile_w + g * LD + 8 * j + 2 * t) =
        pack_bf16x2(acc[j][0] * f_lo, acc[j][1] * f_lo);
    *reinterpret_cast<unsigned*>(tile_w + (g + 8) * LD + 8 * j + 2 * t) =
        pack_bf16x2(acc[j][2] * f_hi, acc[j][3] * f_hi);
  }
  __syncwarp();
  for (int e = lane; e < 16 * kChunks; e += 32) {
    const int r = e / kChunks, c = (e % kChunks) * 8;
    if (row0_w + r < limit)
      *reinterpret_cast<uint4*>(out + (size_t)(row0_w + r) * stride + c) =
          *reinterpret_cast<const uint4*>(tile_w + r * LD + c);
  }
  __syncwarp();
}

// Masked, scaled score of (row, key): -inf past S (no such key), -1e9 where
// the mask drops the key.
__device__ __forceinline__ float masked_score(float s, int row, int key,
                                              const Geometry& g) {
  if (key >= g.S) return -INFINITY;
  return key_kept(key, row, g) ? s * g.scale : kMaskValue;
}

// Keys the query rows row0 .. row0 + rows - 1 have to visit.
__device__ __forceinline__ int mma_keys_end(int row0, int rows,
                                            const Geometry& g) {
  return g.causal ? min(g.S, row0 + rows) : g.S;
}

// Shared memory of a block: `tiles` resident tiles ([16 * W][D + 8] each) in
// as many copies as heads can be in flight (mma_tile_copies), `streams`
// rings of NS stages ([KT][D + 8] each), and for the keys kernel the ring of
// the rows' statistics.
template <int D, int W, int KT, int NS>
constexpr size_t mma_smem_bytes(int tiles, int copies, int streams,
                                bool stats) {
  return sizeof(bf16) * (D + 8) *
             ((size_t)tiles * copies * 16 * W + (size_t)streams * NS * KT) +
         (stats ? sizeof(float) * NS * 3 * KT : 0);
}

// Copies of the resident tile: the first stage of a head is requested up to
// NS - 1 stages ahead, so up to NS heads hold a tile at once.
__host__ __device__ constexpr int mma_tile_copies(int nh, int NS) {
  return nh < NS ? nh : NS;
}

// --------------------------------------------------------------- forward
// grid (head groups, query tiles): block x walks heads x * nh .. + nh - 1.

template <int D, int W, int KT, int NS>
__global__ void __launch_bounds__(W * 32)
mma_fwd_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
               const bf16* __restrict__ v, bf16* __restrict__ o,
               HeadLayout hl, int nh, Geometry g) {
  constexpr int M = 16 * W, NT = 32 * W, LD = D + 8;
  extern __shared__ __align__(16) unsigned char smem[];
  const int copies = mma_tile_copies(nh, NS);
  bf16* qs = reinterpret_cast<bf16*>(smem);  // [copies][M][LD], by head
  bf16* ks = qs + copies * M * LD;           // [NS][KT][LD], the ring
  bf16* vs = ks + NS * KT * LD;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int gq = lane / 4, t = lane % 4;
  const int row0 = blockIdx.y * M, row0_w = row0 + warp * 16;
  const int nst = (mma_keys_end(row0, M, g) + KT - 1) / KT;
  const int kend_w = mma_keys_end(row0_w, 16, g);  // this warp's last key + 1
  const bool active = row0_w < g.S;
  const int total = nh * nst, head0 = blockIdx.x * nh;

  auto stage = [&](int i) {
    if (i < total) {
      const int h = i / nst, s = i % nst;
      const size_t off = hl.offset(head0 + h);
      if (s == 0)
        stage_tile<D, M, NT>(qs + (h % copies) * M * LD, q + off, row0, g.S, g.HD);
      stage_tile<D, KT, NT>(ks + (i % NS) * KT * LD, k + off, s * KT, g.S,
                            g.HD);
      stage_tile<D, KT, NT>(vs + (i % NS) * KT * LD, v + off, s * KT, g.S,
                            g.HD);
    }
    cp_async_commit();
  };

  unsigned qa[D / 16][4];
  float acc[D / 8][4];
  float m_run[2], l_run[2];  // rows gq and gq + 8; l is this lane's share

  for (int i = 0; i < NS - 1; ++i) stage(i);
  for (int i = 0; i < total; ++i) {
    cp_async_wait<NS - 2>();
    __syncthreads();  // stage i is in; every warp is done with stage i - 1
    stage(i + NS - 1);  // into the slot that stage i - 1 left
    const int h = i / nst, s = i % nst;
    if (!active) continue;
    bf16* q_w = qs + (h % copies) * M * LD + warp * 16 * LD;
    if (s == 0) {
      load_a_frags<D>(qa, q_w, lane);
#pragma unroll
      for (int j = 0; j < D / 8; ++j)
#pragma unroll
        for (int c = 0; c < 4; ++c) acc[j][c] = 0.f;
      m_run[0] = m_run[1] = -INFINITY;
      l_run[0] = l_run[1] = 0.f;
    }
    const bf16* k_st = ks + (i % NS) * KT * LD;
    const bf16* v_st = vs + (i % NS) * KT * LD;
    const int key0 = s * KT;
    if (key0 < kend_w) {
      float sc[KT / 8][4];
#pragma unroll
      for (int j = 0; j < KT / 8; ++j)
#pragma unroll
        for (int c = 0; c < 4; ++c) sc[j][c] = 0.f;
#pragma unroll
      for (int b = 0; b < KT / 16; ++b)
        if (key0 + b * 16 < kend_w)
          mma_a_rows_t<D>(sc[2 * b], sc[2 * b + 1], qa, k_st + b * 16 * LD,
                          lane);
      float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
      for (int j = 0; j < KT / 8; ++j)
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const int key = key0 + 8 * j + 2 * t + (c & 1);
          const int row = row0_w + gq + (c / 2) * 8;
          sc[j][c] = masked_score(sc[j][c], row, key, g);
          mx[c / 2] = fmaxf(mx[c / 2], sc[j][c]);
        }
      float alpha[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const float m_new = fmaxf(m_run[r], quad_max(mx[r]));
        alpha[r] = __expf(m_run[r] - m_new);  // 0 at the first stage
        m_run[r] = m_new;
        l_run[r] *= alpha[r];
      }
#pragma unroll
      for (int j = 0; j < D / 8; ++j) {
        acc[j][0] *= alpha[0];
        acc[j][1] *= alpha[0];
        acc[j][2] *= alpha[1];
        acc[j][3] *= alpha[1];
      }
      // one stage a head: m is final, so is l once the exponentials are
      // summed, and P is normalised before it is rounded
      float norm[2] = {1.f, 1.f};
      if (nst == 1) {
#pragma unroll
        for (int j = 0; j < KT / 8; ++j)
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            sc[j][c] = __expf(sc[j][c] - m_run[c / 2]);
            l_run[c / 2] += sc[j][c];
          }
        norm[0] = 1.f / quad_sum(l_run[0]);
        norm[1] = 1.f / quad_sum(l_run[1]);
      }
#pragma unroll
      for (int b = 0; b < KT / 16; ++b) {
        if (key0 + b * 16 < kend_w) {
          unsigned pa[4];
#pragma unroll
          for (int jj = 0; jj < 2; ++jj) {
            const int j = 2 * b + jj;
            float p[4];
#pragma unroll
            for (int c = 0; c < 4; ++c) {
              if (nst == 1) {
                p[c] = sc[j][c] * norm[c / 2];
              } else {
                p[c] = __expf(sc[j][c] - m_run[c / 2]);
                l_run[c / 2] += p[c];
              }
            }
            pa[2 * jj] = pack_bf16x2(p[0], p[1]);
            pa[2 * jj + 1] = pack_bf16x2(p[2], p[3]);
          }
          mma_p_rows<D, false>(acc, pa, pa, v_st + b * 16 * LD, lane);
        }
      }
    }
    if (s == nst - 1) {
      const float f0 = nst == 1 ? 1.f : 1.f / quad_sum(l_run[0]);
      const float f1 = nst == 1 ? 1.f : 1.f / quad_sum(l_run[1]);
      store_tile<D>(q_w, acc, f0, f1, o + hl.offset(head0 + h), g.HD, row0_w,
                    g.S, lane);
    }
  }
}

// ----------------------------------------------- backward, the rows kernel
// grid (head groups, query tiles). stats: [3][heads in all][S] f32 (m, l,
// rs), `plane` the size of one of the three.

template <int D, int W, int KT, int NS>
__global__ void __launch_bounds__(W * 32)
mma_bwd_rows_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                    const bf16* __restrict__ v, const bf16* __restrict__ dout,
                    bf16* __restrict__ dq, float* __restrict__ stats,
                    size_t plane, HeadLayout hl, int nh, Geometry g) {
  constexpr int M = 16 * W, NT = 32 * W, LD = D + 8;
  extern __shared__ __align__(16) unsigned char smem[];
  const int copies = mma_tile_copies(nh, NS);
  bf16* qs = reinterpret_cast<bf16*>(smem);  // [copies][M][LD], by head
  bf16* dos = qs + copies * M * LD;
  bf16* ks = dos + copies * M * LD;          // [NS][KT][LD], the ring
  bf16* vs = ks + NS * KT * LD;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int gq = lane / 4, t = lane % 4;
  const int row0 = blockIdx.y * M, row0_w = row0 + warp * 16;
  const int nst = (mma_keys_end(row0, M, g) + KT - 1) / KT;
  const int kend_w = mma_keys_end(row0_w, 16, g);
  const bool active = row0_w < g.S;
  const int total = nh * nst, head0 = blockIdx.x * nh;

  auto stage = [&](int i) {
    if (i < total) {
      const int h = i / nst, s = i % nst;
      const size_t off = hl.offset(head0 + h);
      if (s == 0) {
        stage_tile<D, M, NT>(qs + (h % copies) * M * LD, q + off, row0, g.S, g.HD);
        stage_tile<D, M, NT>(dos + (h % copies) * M * LD, dout + off, row0, g.S,
                             g.HD);
      }
      stage_tile<D, KT, NT>(ks + (i % NS) * KT * LD, k + off, s * KT, g.S,
                            g.HD);
      stage_tile<D, KT, NT>(vs + (i % NS) * KT * LD, v + off, s * KT, g.S,
                            g.HD);
    }
    cp_async_commit();
  };

  constexpr bool kHeld = mma_frags_held(D);
  unsigned qa[kHeld ? D / 16 : 1][4], da[kHeld ? D / 16 : 1][4];
  float acc_a[D / 8][4], acc_b[D / 8][4];  // sum e dP K and sum e K
  float m_run[2], l_run[2], r_run[2];      // l, r: this lane's share
  float shift[2];                          // the rows' dP at key 0

  for (int i = 0; i < NS - 1; ++i) stage(i);
  for (int i = 0; i < total; ++i) {
    cp_async_wait<NS - 2>();
    __syncthreads();
    stage(i + NS - 1);
    const int h = i / nst, s = i % nst;
    if (!active) continue;
    bf16* q_w = qs + (h % copies) * M * LD + warp * 16 * LD;
    const bf16* do_w = dos + (h % copies) * M * LD + warp * 16 * LD;
    if (s == 0) {
      if constexpr (kHeld) {
        load_a_frags<D>(qa, q_w, lane);
        load_a_frags<D>(da, do_w, lane);
      }
#pragma unroll
      for (int j = 0; j < D / 8; ++j)
#pragma unroll
        for (int c = 0; c < 4; ++c) acc_a[j][c] = acc_b[j][c] = 0.f;
      m_run[0] = m_run[1] = -INFINITY;
      l_run[0] = l_run[1] = r_run[0] = r_run[1] = 0.f;
    }
    const bf16* k_st = ks + (i % NS) * KT * LD;
    const bf16* v_st = vs + (i % NS) * KT * LD;
    const int key0 = s * KT;
    if (key0 < kend_w) {
      float sc[KT / 8][4];
#pragma unroll
      for (int j = 0; j < KT / 8; ++j)
#pragma unroll
        for (int c = 0; c < 4; ++c) sc[j][c] = 0.f;
#pragma unroll
      for (int b = 0; b < KT / 16; ++b)
        if (key0 + b * 16 < kend_w) {
          if constexpr (kHeld)
            mma_a_rows_t<D>(sc[2 * b], sc[2 * b + 1], qa, k_st + b * 16 * LD,
                            lane);
          else
            mma_staged_rows_t<D>(sc[2 * b], sc[2 * b + 1], q_w,
                                 k_st + b * 16 * LD, lane);
        }
      float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
      for (int j = 0; j < KT / 8; ++j)
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const int key = key0 + 8 * j + 2 * t + (c & 1);
          const int row = row0_w + gq + (c / 2) * 8;
          sc[j][c] = masked_score(sc[j][c], row, key, g);
          mx[c / 2] = fmaxf(mx[c / 2], sc[j][c]);
        }
      float alpha[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const float m_new = fmaxf(m_run[r], quad_max(mx[r]));
        alpha[r] = __expf(m_run[r] - m_new);
        m_run[r] = m_new;
        l_run[r] *= alpha[r];
        r_run[r] *= alpha[r];
      }
#pragma unroll
      for (int j = 0; j < D / 8; ++j)
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          acc_a[j][c] *= alpha[c / 2];
          acc_b[j][c] *= alpha[c / 2];
        }
#pragma unroll
      for (int b = 0; b < KT / 16; ++b) {
        if (key0 + b * 16 < kend_w) {
          float dp[2][4];
#pragma unroll
          for (int jj = 0; jj < 2; ++jj)
#pragma unroll
            for (int c = 0; c < 4; ++c) dp[jj][c] = 0.f;
          if constexpr (kHeld)
            mma_a_rows_t<D>(dp[0], dp[1], da, v_st + b * 16 * LD, lane);
          else
            mma_staged_rows_t<D>(dp[0], dp[1], do_w, v_st + b * 16 * LD,
                                 lane);
          if (s == 0 && b == 0) {
            // key 0 sits in lane 4 * gq of each quad: (gq, 0) and (gq + 8, 0)
            shift[0] = __shfl_sync(0xffffffffu, dp[0][0], lane & ~3);
            shift[1] = __shfl_sync(0xffffffffu, dp[0][2], lane & ~3);
          }
          unsigned e_hi[4], e_lo[4], g_hi[4], g_lo[4];
#pragma unroll
          for (int jj = 0; jj < 2; ++jj) {
            const int j = 2 * b + jj;
            float e[4], ge[4];
#pragma unroll
            for (int c = 0; c < 4; ++c) {
              e[c] = __expf(sc[j][c] - m_run[c / 2]);
              ge[c] = e[c] * (dp[jj][c] - shift[c / 2]);
              l_run[c / 2] += e[c];
              r_run[c / 2] += ge[c];
            }
            split_pack(e[0], e[1], e_hi[2 * jj], e_lo[2 * jj]);
            split_pack(e[2], e[3], e_hi[2 * jj + 1], e_lo[2 * jj + 1]);
            split_pack(ge[0], ge[1], g_hi[2 * jj], g_lo[2 * jj]);
            split_pack(ge[2], ge[3], g_hi[2 * jj + 1], g_lo[2 * jj + 1]);
          }
          mma_p_rows<D, true>(acc_a, g_hi, g_lo, k_st + b * 16 * LD, lane);
          mma_p_rows<D, true>(acc_b, e_hi, e_lo, k_st + b * 16 * LD, lane);
        }
      }
    }
    if (s == nst - 1) {
      float l[2], rs[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        l[r] = quad_sum(l_run[r]);
        rs[r] = quad_sum(r_run[r]) / l[r];  // of the shifted dP
      }
#pragma unroll
      for (int j = 0; j < D / 8; ++j)
#pragma unroll
        for (int c = 0; c < 4; ++c)
          acc_a[j][c] -= rs[c / 2] * acc_b[j][c];
      store_tile<D>(q_w, acc_a, g.scale / l[0], g.scale / l[1],
                    dq + hl.offset(head0 + h), g.HD, row0_w, g.S, lane);
      if (t == 0) {
        float* st = stats + (size_t)(head0 + h) * g.S;
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const int row = row0_w + gq + 8 * r;
          if (row < g.S) {
            st[row] = m_run[r];
            st[plane + row] = l[r];
            st[2 * plane + row] = rs[r] + shift[r];
          }
        }
      }
    }
  }
}

// ----------------------------------------------- backward, the keys kernel
// grid (head groups, key tiles).

template <int D, int W, int KT, int NS>
__global__ void __launch_bounds__(W * 32)
mma_bwd_keys_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                    const bf16* __restrict__ v, const bf16* __restrict__ dout,
                    bf16* __restrict__ dk, bf16* __restrict__ dv,
                    const float* __restrict__ stats, size_t plane,
                    HeadLayout hl, int nh, Geometry g) {
  constexpr int M = 16 * W, NT = 32 * W, LD = D + 8;
  extern __shared__ __align__(16) unsigned char smem[];
  const int copies = mma_tile_copies(nh, NS);
  bf16* kt = reinterpret_cast<bf16*>(smem);  // [copies][M][LD], by head
  bf16* vt = kt + copies * M * LD;
  bf16* qs = vt + copies * M * LD;           // [NS][KT][LD], the ring
  bf16* dos = qs + NS * KT * LD;
  float* sts = reinterpret_cast<float*>(dos + NS * KT * LD);  // [NS][3][KT]
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int gq = lane / 4, t = lane % 4;
  const int key0 = blockIdx.y * M, key0_w = key0 + warp * 16;
  // with the causal mask, query rows before the tile's first key see none
  // of its keys
  const int s_first = g.causal ? key0 / KT : 0;
  const int nst = (g.S + KT - 1) / KT - s_first;
  const bool active = key0_w < g.S;
  const int total = nh * nst, head0 = blockIdx.x * nh;

  auto stage = [&](int i) {
    if (i < total) {
      const int h = i / nst, s = s_first + i % nst;
      const size_t off = hl.offset(head0 + h);
      if (i % nst == 0) {
        stage_tile<D, M, NT>(kt + (h % copies) * M * LD, k + off, key0, g.S, g.HD);
        stage_tile<D, M, NT>(vt + (h % copies) * M * LD, v + off, key0, g.S, g.HD);
      }
      stage_tile<D, KT, NT>(qs + (i % NS) * KT * LD, q + off, s * KT, g.S,
                            g.HD);
      stage_tile<D, KT, NT>(dos + (i % NS) * KT * LD, dout + off, s * KT, g.S,
                            g.HD);
      // the rows' m, l, rs; rows past S get a harmless (0, 1, 0)
      const float* st = stats + (size_t)(head0 + h) * g.S;
      for (int e = threadIdx.x; e < 3 * KT; e += NT) {
        const int which = e / KT, row = s * KT + e % KT;
        float* d = sts + (i % NS) * 3 * KT + e;
        if (row < g.S)
          cp_async4(d, st + which * plane + row);
        else
          *d = which == 1 ? 1.f : 0.f;
      }
    }
    cp_async_commit();
  };

  constexpr bool kHeld = mma_frags_held(D);
  unsigned ka[kHeld ? D / 16 : 1][4], va[kHeld ? D / 16 : 1][4];
  float acc_dk[D / 8][4], acc_dv[D / 8][4];

  for (int i = 0; i < NS - 1; ++i) stage(i);
  for (int i = 0; i < total; ++i) {
    cp_async_wait<NS - 2>();
    __syncthreads();
    stage(i + NS - 1);
    const int h = i / nst, s = s_first + i % nst;
    if (!active) continue;
    bf16* k_w = kt + (h % copies) * M * LD + warp * 16 * LD;
    bf16* v_w = vt + (h % copies) * M * LD + warp * 16 * LD;
    if (i % nst == 0) {
      if constexpr (kHeld) {
        load_a_frags<D>(ka, k_w, lane);
        load_a_frags<D>(va, v_w, lane);
      }
#pragma unroll
      for (int j = 0; j < D / 8; ++j)
#pragma unroll
        for (int c = 0; c < 4; ++c) acc_dk[j][c] = acc_dv[j][c] = 0.f;
    }
    const bf16* q_st = qs + (i % NS) * KT * LD;
    const bf16* do_st = dos + (i % NS) * KT * LD;
    const float* st_m = sts + (i % NS) * 3 * KT;
    const float* st_l = st_m + KT;
    const float* st_rs = st_l + KT;
#pragma unroll
    for (int b = 0; b < KT / 16; ++b) {
      const int rb = s * KT + b * 16;  // first query row of the block
      if (rb >= g.S || (g.causal && rb + 15 < key0_w)) continue;
      float sc[2][4], dp[2][4];
#pragma unroll
      for (int jj = 0; jj < 2; ++jj)
#pragma unroll
        for (int c = 0; c < 4; ++c) sc[jj][c] = dp[jj][c] = 0.f;
      if constexpr (kHeld) {
        mma_a_rows_t<D>(sc[0], sc[1], ka, q_st + b * 16 * LD, lane);
        mma_a_rows_t<D>(dp[0], dp[1], va, do_st + b * 16 * LD, lane);
      } else {
        mma_staged_rows_t<D>(sc[0], sc[1], k_w, q_st + b * 16 * LD, lane);
        mma_staged_rows_t<D>(dp[0], dp[1], v_w, do_st + b * 16 * LD, lane);
      }
      unsigned p_hi[4], p_lo[4], s_hi[4], s_lo[4];
#pragma unroll
      for (int jj = 0; jj < 2; ++jj) {
        const int col = b * 16 + 8 * jj + 2 * t;  // row of the stage
        const float2 m2 = *reinterpret_cast<const float2*>(st_m + col);
        const float2 l2 = *reinterpret_cast<const float2*>(st_l + col);
        const float2 r2 = *reinterpret_cast<const float2*>(st_rs + col);
        const float mq[2] = {m2.x, m2.y}, rq[2] = {r2.x, r2.y};
        const float il[2] = {1.f / l2.x, 1.f / l2.y};
        float p[4], ds[4];
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const int key = key0_w + gq + (c / 2) * 8;
          const int row = s * KT + col + (c & 1);
          const bool kept = row < g.S && key < g.S && key_kept(key, row, g);
          p[c] = kept ? __expf(sc[jj][c] * g.scale - mq[c & 1]) * il[c & 1]
                      : 0.f;
          ds[c] = p[c] * (dp[jj][c] - rq[c & 1]) * g.scale;
        }
        split_pack(p[0], p[1], p_hi[2 * jj], p_lo[2 * jj]);
        split_pack(p[2], p[3], p_hi[2 * jj + 1], p_lo[2 * jj + 1]);
        split_pack(ds[0], ds[1], s_hi[2 * jj], s_lo[2 * jj]);
        split_pack(ds[2], ds[3], s_hi[2 * jj + 1], s_lo[2 * jj + 1]);
      }
      mma_p_rows<D, true>(acc_dv, p_hi, p_lo, do_st + b * 16 * LD, lane);
      mma_p_rows<D, true>(acc_dk, s_hi, s_lo, q_st + b * 16 * LD, lane);
    }
    if (i % nst == nst - 1) {
      const size_t off = hl.offset(head0 + h);
      store_tile<D>(k_w, acc_dk, 1.f, 1.f, dk + off, g.HD, key0_w, g.S, lane);
      store_tile<D>(v_w, acc_dv, 1.f, 1.f, dv + off, g.HD, key0_w, g.S, lane);
    }
  }
}

// ------------------------------------------------------------------ launches

// Tile heights per geometry: warps a block (16 rows each), rows a stage and
// stages in the ring.
struct MmaShort { static constexpr int kW = 2, kKT = 32, kNS = 2; };  // S <= 32
struct MmaLong { static constexpr int kW = 4, kKT = 64, kNS = 2; };
struct MmaWide { static constexpr int kW = 8, kKT = 64, kNS = 2; };
struct MmaLongBwd { static constexpr int kW = 4, kKT = 32, kNS = 2; };
struct MmaD128 { static constexpr int kW = 4, kKT = 32, kNS = 2; };  // fwd
constexpr int kMmaShortMax = 32;

// The forward's 128-row tiles pad S no more than 64-row ones do.
constexpr bool mma_wide_fwd(int S) {
  return S > kMmaShortMax && (S + 63) / 64 % 2 == 0;
}

template <int D, typename C>
int mma_launch_fwd(const void* q, const void* k, const void* v, void* o,
                   int groups, int nh, const HeadLayout& hl,
                   const Geometry& g, cudaStream_t st) {
  constexpr int W = C::kW, KT = C::kKT, NS = C::kNS;
  const size_t smem = mma_smem_bytes<D, W, KT, NS>(
      1, mma_tile_copies(nh, NS), 2, false);
  auto kernel = mma_fwd_kernel<D, W, KT, NS>;
  if (int err = set_smem(kernel, smem)) return err;
  const dim3 grid(groups, (g.S + 16 * W - 1) / (16 * W));
  kernel<<<grid, W * 32, smem, st>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<bf16*>(o), hl, nh, g);
  return (int)cudaGetLastError();
}

template <int D, typename C>
int mma_launch_bwd(const void* q, const void* k, const void* v,
                   const void* dout, void* dq, void* dk, void* dv,
                   void* stats, size_t plane, int groups, int nh,
                   const HeadLayout& hl, const Geometry& g, cudaStream_t st) {
  constexpr int W = C::kW, KT = C::kKT, NS = C::kNS;
  auto rows_kernel = mma_bwd_rows_kernel<D, W, KT, NS>;
  auto keys_kernel = mma_bwd_keys_kernel<D, W, KT, NS>;
  const int copies = mma_tile_copies(nh, NS);
  const size_t rows_smem = mma_smem_bytes<D, W, KT, NS>(2, copies, 2, false);
  const size_t keys_smem = mma_smem_bytes<D, W, KT, NS>(2, copies, 2, true);
  if (int err = set_smem(rows_kernel, rows_smem)) return err;
  if (int err = set_smem(keys_kernel, keys_smem)) return err;
  const dim3 grid(groups, (g.S + 16 * W - 1) / (16 * W));
  auto qq = static_cast<const bf16*>(q);
  auto kk = static_cast<const bf16*>(k);
  auto vv = static_cast<const bf16*>(v);
  auto dd = static_cast<const bf16*>(dout);
  rows_kernel<<<grid, W * 32, rows_smem, st>>>(
      qq, kk, vv, dd, static_cast<bf16*>(dq), static_cast<float*>(stats),
      plane, hl, nh, g);
  if (cudaError_t err = cudaGetLastError()) return (int)err;
  keys_kernel<<<grid, W * 32, keys_smem, st>>>(
      qq, kk, vv, dd, static_cast<bf16*>(dk), static_cast<bf16*>(dv),
      static_cast<const float*>(stats), plane, hl, nh, g);
  return (int)cudaGetLastError();
}

// The launchers' rule, shared by both layouts: `groups` blocks of `nh`
// heads each, laid out by `hl`; tile heights from S. stats: 3 planes of
// `plane` f32 (m, l, rs of every row of every head) between the backward's
// two kernels.
template <int D>
int mma_attention_fwd(const void* q, const void* k, const void* v, void* o,
                      int groups, int nh, const HeadLayout& hl,
                      const Geometry& g, cudaStream_t st) {
  if (g.S <= kMmaShortMax)
    return mma_launch_fwd<D, MmaShort>(q, k, v, o, groups, nh, hl, g, st);
  if constexpr (D == 128) {
    return mma_launch_fwd<D, MmaD128>(q, k, v, o, groups, nh, hl, g, st);
  } else {
    if (mma_wide_fwd(g.S))
      return mma_launch_fwd<D, MmaWide>(q, k, v, o, groups, nh, hl, g, st);
    return mma_launch_fwd<D, MmaLong>(q, k, v, o, groups, nh, hl, g, st);
  }
}

template <int D>
int mma_attention_bwd(const void* q, const void* k, const void* v,
                      const void* dout, void* dq, void* dk, void* dv,
                      void* stats, size_t plane, int groups, int nh,
                      const HeadLayout& hl, const Geometry& g,
                      cudaStream_t st) {
  if (g.S <= kMmaShortMax)
    return mma_launch_bwd<D, MmaShort>(q, k, v, dout, dq, dk, dv, stats,
                                       plane, groups, nh, hl, g, st);
  return mma_launch_bwd<D, MmaLongBwd>(q, k, v, dout, dq, dk, dv, stats,
                                       plane, groups, nh, hl, g, st);
}

}  // namespace
