// K6: the Monte-Carlo convolution over Hilbert tile pairs, backward, over
// unpacked sample rows. The kernel, its design and what bounds it are in
// tile_conv_bwd.cuh; K6p, the same kernel over packed minor records, is built
// in tile_conv_packed.cu.

#include "tile_conv_bwd.cuh"

// out: d_f~ (B, NP, C) when depthwise, else X (B, NP, H+1, KU). u: t (B, NS,
// KU). dg: dG (B, NS, H+1, C) for the full conv (unread when depthwise).
// w1part: (B * n_tiles * ceil(max(C, KU) / CB), 4, H) partials of [dW1; db1];
// w2part: (B * n_tiles, H+1, C) partials of [dW2; db2] (depthwise only).
extern "C" int tile_conv_bwd_launch(const void* smp, const void* svalid, const void* src,
                                    const void* pvalid, const void* wf, const void* u,
                                    const void* dg, const void* j_ids, const void* run,
                                    const void* w1, const void* b1, const void* w2,
                                    const void* b2, int B, int NS, int NP, int C, int KU,
                                    int CB, int H, int S, int G, int n_tiles, int sentinel,
                                    int Tm, float r2, float radius, int depthwise, void* out,
                                    void* w1part, void* w2part, void* stream) {
  const k6::TileBwdArgs a{
      static_cast<const float*>(smp), static_cast<const uint8_t*>(svalid),
      static_cast<const float*>(u), nullptr, static_cast<const float*>(src),
      static_cast<const uint8_t*>(pvalid), static_cast<const float*>(wf),
      static_cast<const float*>(dg), static_cast<const int*>(j_ids),
      static_cast<const int*>(run), static_cast<const float*>(w1),
      static_cast<const float*>(b1), static_cast<const float*>(w2),
      static_cast<const float*>(b2), NS, NP, C, KU, CB, S, G, n_tiles, sentinel, r2, radius,
      depthwise, static_cast<float*>(out), static_cast<float*>(w1part),
      static_cast<float*>(w2part)};
  return k6::tile_bwd_dispatch<false>(a, B, H, Tm, static_cast<cudaStream_t>(stream));
}
