// The K5p probes: the K5 probes (tile_conv_probe.cu, tile_conv.cuh) over the
// packed source records of K5p, as the TPU kernel's MCCNN_TILE_PROBE strips
// its packed-record mode too (the probe branches of
// mccnn_tpu/ops/pallas/tile_conv.py::_fwd_kernel, :575-608, follow the
// unpacking at :553-557). Built apart so that nvcc compiles the instances in
// parallel with the others.

#include "tile_conv.cuh"

// probe: 1 noop, 2 planes, 3 mm; the other arguments as tile_conv_packed_launch.
extern "C" int tile_conv_packed_probe_launch(int probe, const void* smp, const void* svalid,
                                             const void* rec, const void* j_ids, const void* run,
                                             const void* w1, const void* b1, const void* w2,
                                             const void* b2, int B, int NS, int C, int H, int S,
                                             int G, int n_tiles, int sentinel, int Tm, float r2,
                                             float radius, int mean, int depthwise, void* out,
                                             void* cnt, void* stream) {
  const k5::TileConvArgs a{
      static_cast<const float*>(smp), static_cast<const uint8_t*>(svalid), nullptr, nullptr,
      nullptr, static_cast<const float*>(rec), static_cast<const int*>(j_ids),
      static_cast<const int*>(run), static_cast<const float*>(w1),
      static_cast<const float*>(b1), static_cast<const float*>(w2),
      static_cast<const float*>(b2), NS, 0, C, S, G, n_tiles, sentinel, r2, radius, mean,
      depthwise, static_cast<float*>(out), static_cast<float*>(cnt)};
  return k5::tile_conv_probe_dispatch<true>(a, B, H, Tm, probe,
                                            static_cast<cudaStream_t>(stream));
}
