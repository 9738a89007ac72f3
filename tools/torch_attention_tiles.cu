// The tensor-core attention bodies of ttl_tpu_torch (csrc/attention_mma.cuh)
// at head dim 64 under other tile heights than the launcher's: warps a block
// (16 rows each), rows a stage and stages in the cp.async ring. Built and
// driven by tools/torch_attention_tiles.py.
#include "../ttl_tpu_torch/csrc/attention_mma.cuh"

namespace {

template <int W_, int KT_, int NS_> struct Tiles {
  static constexpr int kW = W_, kKT = KT_, kNS = NS_;
};

template <typename C>
int run(int bwd, int heads, const void* q, const void* k, const void* v,
        const void* dout, void* o, void* dq, void* dk, void* dv, void* stats,
        int B, int H, int S, int causal, float scale, cudaStream_t st) {
  constexpr int D = 64;
  const Geometry g{S, D, S, scale, causal};
  const HeadLayout hl{H, (size_t)H * S * D, (size_t)S * D};
  const int groups = heads ? B : B * H, nh = heads ? H : 1;
  if (!bwd) return mma_launch_fwd<D, C>(q, k, v, o, groups, nh, hl, g, st);
  return mma_launch_bwd<D, C>(q, k, v, dout, dq, dk, dv, stats,
                              (size_t)B * H * S, groups, nh, hl, g, st);
}

}  // namespace

// cfg = 100 * warps + rows a stage + stages (for example 4 * 100 + 64 + 2);
// 1 for one that was not built.
extern "C" int ttl_tiles_run(int cfg, int bwd, int heads, const void* q,
                             const void* k, const void* v, const void* dout,
                             void* o, void* dq, void* dk, void* dv,
                             void* stats, int B, int H, int S, int causal,
                             float scale, void* stream) {
  auto st = static_cast<cudaStream_t>(stream);
#define TILES(W, KT, NS)                                                   \
  case 100 * W + KT + NS:                                                  \
    return run<Tiles<W, KT, NS>>(bwd, heads, q, k, v, dout, o, dq, dk, dv, \
                                 stats, B, H, S, causal, scale, st);
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
