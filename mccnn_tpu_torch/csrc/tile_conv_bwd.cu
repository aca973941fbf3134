// K6: the Monte-Carlo convolution over Hilbert tile pairs, backward, over
// unpacked sample rows. The kernel, its design and what bounds it are in
// tile_conv_bwd.cuh (its body in list_bwd.cuh); K6p, the same kernel over
// packed minor records, is built in tile_conv_packed.cu.

#include "tile_conv_bwd.cuh"

// The partial rows and passes of K6's blocks for B clouds of n_tiles source
// tiles: what 0 gives the rows of [dW1; db1] partials (the caller sizes them
// as that many times 4 * H floats), 1 those of [dW2; db2] (times (H+1) * C,
// depthwise), 2 the passes over a block's channels (above 1, a depthwise
// site needs the scratch xs); 0 if the shape is refused.
extern "C" int tile_conv_bwd_blocks(int B, int n_tiles, int C, int KU, int what) {
  if (B < 1 || n_tiles < 1 || C < 1 || KU < 1 || C > dense_pairs::kMaxC ||
      KU > dense_pairs::kMaxC)
    return 0;
  const dense_pairs::Plan p = k6::tile_bwd_plan(B, n_tiles, C, KU);
  const int groups = B * n_tiles * p.tiles;
  return what == 0 ? groups * p.slices : what == 1 ? groups : p.passes;
}

// out: d_f~ (B, NP, C) when depthwise, else X (B, NP, H+1, KU). u: t (B, NS,
// KU). dg: dG (B, NS, H+1, C) for the full conv (unread when depthwise). xs:
// (B, NP, H+1, C) scratch where a depthwise site takes several passes, else
// unread. w1part / w2part: tile_conv_bwd_blocks(..., 0 / 1) rows of
// [dW1; db1] / [dW2; db2] (depthwise only) partials.
extern "C" int tile_conv_bwd_launch(const void* smp, const void* svalid, const void* src,
                                    const void* pvalid, const void* wf, const void* u,
                                    const void* dg, const void* j_ids, const void* run,
                                    const void* w1, const void* b1, const void* w2,
                                    const void* b2, int B, int NS, int NP, int C, int KU, int H,
                                    int S, int G, int n_tiles, int sentinel, int Tm, float r2,
                                    float radius, int depthwise, void* out, void* xs,
                                    void* w1part, void* w2part, void* stream) {
  const k6::TileBwdArgs a{
      static_cast<const float*>(smp), static_cast<const uint8_t*>(svalid),
      static_cast<const float*>(u), nullptr, static_cast<const float*>(src),
      static_cast<const uint8_t*>(pvalid), static_cast<const float*>(wf),
      static_cast<const float*>(dg), static_cast<const int*>(j_ids),
      static_cast<const int*>(run), static_cast<const float*>(w1),
      static_cast<const float*>(b1), static_cast<const float*>(w2),
      static_cast<const float*>(b2), NS, NP, C, KU, S, G, n_tiles, sentinel, r2, radius,
      depthwise, static_cast<float*>(out), static_cast<float*>(xs),
      static_cast<float*>(w1part), static_cast<float*>(w2part)};
  return k6::tile_bwd_dispatch<false>(a, B, H, Tm, static_cast<cudaStream_t>(stream));
}
