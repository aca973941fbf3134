// K5p and K6p: K5 and K6 over packed minor records.
//
// Replace the packed-record mode of mccnn_tpu/ops/pallas/tile_conv.py's
// _fwd_kernel (:525; spec.pack, :553-557) and _bwd_kernel (:658; spec.pack,
// :701-704), which MCCNN_TILE_PACK=1 selects when MCCNN_TILE_BWD_V1 is not 1
// and Tm is even (:1354-1368); the TPU builds the records with _pack_minor
// (:487). The kernels are K5's and K6's templates (tile_conv.cuh,
// tile_conv_bwd.cuh) with kPacked set: each candidate minor is one contiguous
// record of Tm rows (x, y, z, validity) and then its Tm rows of payload, f~
// forward and the cotangent t backward, fp32 (the TPU record bit-casts a bf16
// payload into f32 rows). The wrapper (ops/cuda/tile_conv.py
// pack_minor_records) builds the records; the kernels stage the values K5 and
// K6 stage from them and sum in the same order, so K5p and K6p are bit-equal
// to K5 and K6. What bounds them on the H100 is what bounds K5 and K6
// (tile_conv.cuh, tile_conv_bwd.cuh).

#include "tile_conv.cuh"
#include "tile_conv_bwd.cuh"

// rec: (B, sentinel, Tm * (4 + C)) source records; the rest as tile_conv_launch.
extern "C" int tile_conv_packed_launch(const void* smp, const void* svalid, const void* rec,
                                       const void* j_ids, const void* run, const void* w1,
                                       const void* b1, const void* w2, const void* b2, int B,
                                       int NS, int C, int H, int S, int G, int n_tiles,
                                       int sentinel, int Tm, float r2, float radius, int mean,
                                       int depthwise, void* out, void* cnt, void* stream) {
  const k5::TileConvArgs a{
      static_cast<const float*>(smp), static_cast<const uint8_t*>(svalid), nullptr, nullptr,
      nullptr, static_cast<const float*>(rec), static_cast<const int*>(j_ids),
      static_cast<const int*>(run), static_cast<const float*>(w1),
      static_cast<const float*>(b1), static_cast<const float*>(w2),
      static_cast<const float*>(b2), NS, 0, C, S, G, n_tiles, sentinel, r2, radius, mean,
      depthwise, static_cast<float*>(out), static_cast<float*>(cnt)};
  return k5::tile_conv_dispatch<true>(a, B, H, Tm, static_cast<cudaStream_t>(stream));
}

// rec: (B, sentinel, Tm * (4 + KU)) sample records (positions, validity, t);
// the rest as tile_conv_bwd_launch.
extern "C" int tile_conv_bwd_packed_launch(const void* rec, const void* src, const void* pvalid,
                                           const void* wf, const void* dg, const void* j_ids,
                                           const void* run, const void* w1, const void* b1,
                                           const void* w2, const void* b2, int B, int NS,
                                           int NP, int C, int KU, int H, int S, int G,
                                           int n_tiles, int sentinel, int Tm, float r2,
                                           float radius, int depthwise, void* out, void* xs,
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
  return k6::tile_bwd_dispatch<true>(a, B, H, Tm, static_cast<cudaStream_t>(stream));
}
