// K1v1: the dense Monte-Carlo convolution, forward, in one launch.
//
// Replaces mccnn_tpu/ops/pallas/dense_conv.py::_fwd_kernel (with its h-loop
// _hloop), the per-h variant that MCCNN_DENSE_V1=1 selects (reached through
// _fwd_call, dense_conv.py:578-604). It computes K1's function
// (dense_conv.cu): for every sample i and every valid source j with
// d2(i, j) <= r2,
//
//   out[i] = s_i * sum_j [ sum_h a_h(i,j) (f~_j . W2[h]) + f~_j . b2 ],
//   a_h(i,j) = relu(((p_j - x_i) / r) . W1[:, h] + b1[h]),
//
// with s_i = 1/count in mean mode (1 otherwise) and 0 for a masked sample.
// The TPU kernel loops over h inside a grid step that holds every source:
// acc += (a_h^T f~) w2_h. Here, as there, the tile's G = a^T f~ never
// reaches device memory: a block forms it for a tile of samples and folds it
// into (W2, b2) itself (dense_conv_v1.cuh).
//
// What bounds it on the H100: only the in-radius pairs of valid points carry
// work (8 pre-activations and (H+1) FMAs a channel); every other pair needs
// one d2 test, and the block builds its samples' in-radius lists with warp
// ballots (dense_pairs.cuh) so that nothing else touches them. Then the fold:
// (H+1) C CO FMAs a sample, each Wcat value read from L2 once per 8 samples
// of a tile, or once per cluster of up to 8 clouds where a cloud is one tile
// (the global sites). One block folds every column of its tile, so no pair
// is tested twice at any CO. fp32
// throughout, sums in a fixed order, no atomics: two calls give
// bit-identical outputs; G and the count are K1's, bit for bit.
//
// Limits: H == 8 and C <= 1024, as K1.

#include "dense_conv_v1.cuh"

// out (B, M, CO | C) and cnt (B, M); CO == 0 selects the depthwise conv.
extern "C" int mcconv_v1_fwd_launch(const void* smp, const void* smask, const void* src,
                                    const void* srcmask, const void* wf, const void* w1,
                                    const void* b1, const void* w2, const void* b2, int B,
                                    int M, int N, int C, int CO, int H, int mean, float r2,
                                    float radius, void* out, void* cnt, void* stream) {
  if (H != dense_v1::kHidden || C < 1 || C > dense_v1::kMaxC || M < 1 || N < 1 || B < 1 ||
      CO < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  return dense_v1::launch_tile<dense_v1::kFoldOut>(smp, smask, src, srcmask, wf, w1, b1, w2, b2,
                                                   nullptr, B, M, N, C, CO, mean, r2, radius,
                                                   out, cnt, nullptr, stream);
}
