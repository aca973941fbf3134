// The K6 and K6p bwd_noop probes: K6 (tile_conv_bwd.cuh) over unpacked or
// packed sample rows, stripped as the TPU kernel's MCCNN_TILE_PROBE=bwd_noop
// strips mccnn_tpu/ops/pallas/tile_conv.py::_bwd_kernel (:718-726): the
// staging, the d2 sweep that builds K6's in-radius lists (counting only), and
// zeros out. What is left of K6's time against it is the lists' entries
// (offsets, a_h) and the contraction. K6v1 has no probe, as
// _bwd_kernel_v1 (:825) has none. Built apart so that nvcc compiles the
// instances in parallel with K6's.

#include "tile_conv_bwd.cuh"

// The arguments of tile_conv_bwd_launch (tile_conv_bwd.cu).
extern "C" int tile_conv_bwd_noop_launch(const void* smp, const void* svalid, const void* src,
                                         const void* pvalid, const void* wf, const void* u,
                                         const void* dg, const void* j_ids, const void* run,
                                         const void* w1, const void* b1, const void* w2,
                                         const void* b2, int B, int NS, int NP, int C, int KU,
                                         int H, int S, int G, int n_tiles, int sentinel, int Tm,
                                         float r2, float radius, int depthwise, void* out,
                                         void* xs, void* w1part, void* w2part, void* stream) {
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
  return k6::tile_bwd_dispatch<false, true>(a, B, H, Tm, static_cast<cudaStream_t>(stream));
}

// The arguments of tile_conv_bwd_packed_launch (tile_conv_packed.cu).
extern "C" int tile_conv_bwd_packed_noop_launch(
    const void* rec, const void* src, const void* pvalid, const void* wf, const void* dg,
    const void* j_ids, const void* run, const void* w1, const void* b1, const void* w2,
    const void* b2, int B, int NS, int NP, int C, int KU, int H, int S, int G, int n_tiles,
    int sentinel, int Tm, float r2, float radius, int depthwise, void* out, void* xs,
    void* w1part, void* w2part, void* stream) {
  const k6::TileBwdArgs a{
      nullptr, nullptr, nullptr, static_cast<const float*>(rec),
      static_cast<const float*>(src), static_cast<const uint8_t*>(pvalid),
      static_cast<const float*>(wf), static_cast<const float*>(dg),
      static_cast<const int*>(j_ids), static_cast<const int*>(run),
      static_cast<const float*>(w1), static_cast<const float*>(b1),
      static_cast<const float*>(w2), static_cast<const float*>(b2), NS, NP, C, KU, S, G,
      n_tiles, sentinel, r2, radius, depthwise, static_cast<float*>(out),
      static_cast<float*>(xs), static_cast<float*>(w1part), static_cast<float*>(w2part)};
  return k6::tile_bwd_dispatch<true, true>(a, B, H, Tm, static_cast<cudaStream_t>(stream));
}
