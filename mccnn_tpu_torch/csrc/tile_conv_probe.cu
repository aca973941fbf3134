// The K5 probes over unpacked source rows: K5 (tile_conv.cuh) stripped to its
// parts as the TPU kernel's MCCNN_TILE_PROBE = noop | planes | mm strips
// mccnn_tpu/ops/pallas/tile_conv.py::_fwd_kernel (:575-608, read at :1366).
// What each probe keeps and writes is in tile_conv.cuh; the probes run under
// the same layouts and step lists as K5, at every minor size. They are the
// port's roofline instruments (mccnn_tpu_torch/tools/tile_roofline.py): what
// a probe costs against K5 splits K5's time into loads and distances, plane
// arithmetic and the contraction. Built apart from tile_conv.cu so that nvcc
// compiles the instances in parallel with K5's.

#include "tile_conv.cuh"

// probe: 1 noop, 2 planes, 3 mm; out: (B, NS) for noop and planes, else as
// tile_conv_launch; the other arguments as tile_conv_launch.
extern "C" int tile_conv_probe_launch(int probe, const void* smp, const void* svalid,
                                      const void* src, const void* pvalid, const void* wf,
                                      const void* j_ids, const void* run, const void* w1,
                                      const void* b1, const void* w2, const void* b2, int NP,
                                      int B, int NS, int C, int H, int S, int G, int n_tiles,
                                      int sentinel, int Tm, float r2, float radius, int mean,
                                      int depthwise, void* out, void* cnt, void* stream) {
  const k5::TileConvArgs a{
      static_cast<const float*>(smp), static_cast<const uint8_t*>(svalid),
      static_cast<const float*>(src), static_cast<const uint8_t*>(pvalid),
      static_cast<const float*>(wf), nullptr, static_cast<const int*>(j_ids),
      static_cast<const int*>(run), static_cast<const float*>(w1),
      static_cast<const float*>(b1), static_cast<const float*>(w2),
      static_cast<const float*>(b2), NS, NP, C, S, G, n_tiles, sentinel, r2, radius, mean,
      depthwise, static_cast<float*>(out), static_cast<float*>(cnt)};
  return k5::tile_conv_probe_dispatch<false>(a, B, H, Tm, probe,
                                             static_cast<cudaStream_t>(stream));
}
