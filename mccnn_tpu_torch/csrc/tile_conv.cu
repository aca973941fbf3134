// K5: the Monte-Carlo convolution over Hilbert tile pairs, forward, over
// unpacked source rows. The kernel, its design and what bounds it are in
// tile_conv.cuh; K5p, the same kernel over packed minor records, is built in
// tile_conv_packed.cu.

#include "tile_conv.cuh"

// out: (B, NS, C) when depthwise, else G (B, NS, H+1, C); cnt (B, NS).
extern "C" int tile_conv_launch(const void* smp, const void* svalid, const void* src,
                                const void* pvalid, const void* wf, const void* j_ids,
                                const void* run, const void* w1, const void* b1,
                                const void* w2, const void* b2, int NP, int B, int NS, int C,
                                int H, int S, int G, int n_tiles, int sentinel, int Tm,
                                float r2, float radius, int mean, int depthwise, void* out,
                                void* cnt, void* stream) {
  const k5::TileConvArgs a{
      static_cast<const float*>(smp), static_cast<const uint8_t*>(svalid),
      static_cast<const float*>(src), static_cast<const uint8_t*>(pvalid),
      static_cast<const float*>(wf), nullptr, static_cast<const int*>(j_ids),
      static_cast<const int*>(run), static_cast<const float*>(w1),
      static_cast<const float*>(b1), static_cast<const float*>(w2),
      static_cast<const float*>(b2), NS, NP, C, S, G, n_tiles, sentinel, r2, radius, mean,
      depthwise, static_cast<float*>(out), static_cast<float*>(cnt)};
  return k5::tile_conv_dispatch<false>(a, B, H, Tm, static_cast<cudaStream_t>(stream));
}
