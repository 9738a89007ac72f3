// The tensor-core attention bodies of ttl_tpu_torch (csrc/attention_mma.cuh)
// at head dim 64 under other tile heights than the launcher's: warps a block
// (16 rows each), rows a stage and stages in the cp.async ring, on K3's and
// K4's [B, H, S, D] grids and on K1/K2's [B, S, H*D] rows; and at head dim
// 128 (ttl_tiles_run_d128) on K1/K2's rows. Built and driven by
// tools/torch_attention_tiles.py.
#include "../ttl_tpu_torch/csrc/attention_mma.cuh"

namespace {

template <int W_, int KT_, int NS_> struct Tiles {
  static constexpr int kW = W_, kKT = KT_, kNS = NS_;
};

// layout 0: [B, H, S, D], a block per head (K3); 1: the same, a block per
// batch element walking its heads (K4); 2: [B, S, H*D] rows, keys past
// seq_len masked (K1/K2).
template <typename C, int D = 64>
int run(int bwd, int layout, const void* q, const void* k, const void* v,
        const void* dout, void* o, void* dq, void* dk, void* dv, void* stats,
        int B, int H, int S, int seq_len, int causal, float scale,
        cudaStream_t st) {
  const bool rows = layout == 2;
  const Geometry g{S, rows ? H * D : D, seq_len, scale, causal};
  const HeadLayout hl = rows ? HeadLayout{H, (size_t)S * H * D, (size_t)D}
                             : HeadLayout{H, (size_t)H * S * D, (size_t)S * D};
  const int groups = layout == 1 ? B : B * H, nh = layout == 1 ? H : 1;
  if (!bwd) return mma_launch_fwd<D, C>(q, k, v, o, groups, nh, hl, g, st);
  return mma_launch_bwd<D, C>(q, k, v, dout, dq, dk, dv, stats,
                              (size_t)B * H * S, groups, nh, hl, g, st);
}

}  // namespace

// cfg = 100 * warps + rows a stage + stages (for example 4 * 100 + 64 + 2);
// 1 for one that was not built.
extern "C" int ttl_tiles_run(int cfg, int bwd, int layout, const void* q,
                             const void* k, const void* v, const void* dout,
                             void* o, void* dq, void* dk, void* dv,
                             void* stats, int B, int H, int S, int seq_len,
                             int causal, float scale, void* stream) {
  auto st = static_cast<cudaStream_t>(stream);
#define TILES(W, KT, NS)                                                    \
  case 100 * W + KT + NS:                                                   \
    return run<Tiles<W, KT, NS>>(bwd, layout, q, k, v, dout, o, dq, dk, dv, \
                                 stats, B, H, S, seq_len, causal, scale, st);
  switch (cfg) {
    TILES(1, 32, 2) TILES(1, 32, 3)
    TILES(2, 32, 2) TILES(2, 32, 3) TILES(2, 32, 4) TILES(2, 64, 2)
    TILES(2, 64, 3)
    TILES(4, 32, 2) TILES(4, 32, 3) TILES(4, 64, 2) TILES(4, 64, 3)
    TILES(4, 64, 4)
    TILES(8, 32, 2) TILES(8, 32, 3) TILES(8, 64, 2) TILES(8, 64, 3)
  }
#undef TILES
  return 1;
}

// The same at head dim 128, K1/K2's rows (layout 2) and the heights below.
extern "C" int ttl_tiles_run_d128(int cfg, int bwd, const void* q,
                                  const void* k, const void* v,
                                  const void* dout, void* o, void* dq,
                                  void* dk, void* dv, void* stats, int B,
                                  int H, int S, int seq_len, float scale,
                                  void* stream) {
  auto st = static_cast<cudaStream_t>(stream);
#define TILES(W, KT, NS)                                                     \
  case 100 * W + KT + NS:                                                    \
    return run<Tiles<W, KT, NS>, 128>(bwd, 2, q, k, v, dout, o, dq, dk, dv,  \
                                      stats, B, H, S, seq_len, 0, scale, st);
  switch (cfg) {
    TILES(2, 32, 2) TILES(4, 16, 2) TILES(4, 32, 2) TILES(4, 32, 3)
    TILES(4, 64, 2) TILES(8, 32, 2) TILES(8, 64, 2)
  }
#undef TILES
  return 1;
}
