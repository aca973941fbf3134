// K2v1: the dense Monte-Carlo convolution, backward, without the forward's G.
//
// Replaces mccnn_tpu/ops/pallas/dense_conv.py::_bwd_kernel, the per-h variant
// of the fused backward that MCCNN_DENSE_V1=1 selects (reached through
// _bwd_call, dense_conv.py:607-647, from _core_bwd :758-769, which gives it
// the forward's inputs and count but no G). It computes K2's function
// (dense_conv_bwd.cu): given t = s * dout,
//
//   t_h[i, c]  = t[i, c] W2[h, c]  (depthwise)  |  sum_o t[i, o] W2[h, c, o]  (full)
//   d_f~[j, c] = sum_i sum_{h<=H} a_h(i,j) t_h[i, c]          (t_H uses b2)
//   dpre_h(i,j) = [pre_h > 0] [in radius] sum_c t_h[i, c] f~[j, c]
//   dW1[k, h]  = sum dpre_h(i,j) (p_j - x_i)_k / r,   db1[h] = sum dpre_h
//   [dW2; db2][h, c, o] = sum_i G[i, h, c] t[i, o],   G[i, h] = sum_j a_h(i,j) f~_j.
//
// The TPU kernel walks source tiles on a sequential grid, forms every t_h
// and the a_h plane of all pairs again at each step and adds [dW2; db2] into
// outputs that stay in VMEM. On the H100 blocks run in no order, and a
// per-block partial of (H+1) C CO floats is megabytes at a wide full site.
// So K2v1 is one sample pass and K2's passes over rows and pairs:
//
//   1. G's rows again, from sample-owner in-radius lists: the tile kernel of
//      K1v1 (dense_conv_v1.cuh) in its kGRows mode, one writer a row, in the
//      order K1v1 folds them. The rows go to a transient (B, M, H+1, C)
//      buffer (0.3 MB at a global site at B = 32, where a source-side
//      X = a^T t would be 47 MB); the same blocks write t = s * dout.
//   2. t_h once a call: K2's dG GEMM at a full site; at a depthwise site K2's
//      pair kernel forms t * [w2; b2] where it reads a row.
//   3. [dW2; db2] = G^T t through K2's row-split GEMM, its chunks' partials
//      summed in chunk order; G's buffer is freed after it.
//   4. d_f~, dW1 and db1 from source-owner lists: K2's pair kernel and its
//      reduction of per-block partials in block order.
//
// The wrapper (ops/cuda/dense_conv.py::dense_mc_conv_v1_backward_cuda)
// launches 2-4 through K2's entry points. So a pair out of radius, or with a
// masked point, costs one d2 test in each pass, and only listed pairs form
// planes. G is K1's, bit for bit, so K2v1's gradients are K2's on K1's G. No
// float atomics: two calls give bit-identical gradients.
//
// Limits: H == 8 and C <= 1024, as K2.

#include "dense_conv_v1.cuh"

// G (B, M, H+1, C): the rows K1v1 forms for the samples, every row written;
// t (B, M, CO | C) = s * dout with s from cnt (1/max(cnt, 1) with mean, 1
// without, 0 for a masked sample). CO == 0: depthwise.
extern "C" int mcconv_v1_g_launch(const void* smp, const void* smask, const void* src,
                                  const void* srcmask, const void* wf, const void* w1,
                                  const void* b1, const void* dout, const void* cnt, int B,
                                  int M, int N, int C, int CO, int H, int mean, float r2,
                                  float radius, void* G, void* t, void* stream) {
  if (H != dense_v1::kHidden || C < 1 || C > dense_v1::kMaxC || M < 1 || N < 1 || B < 1 ||
      CO < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  return dense_v1::launch_tile<dense_v1::kGRows>(
      smp, smask, src, srcmask, wf, w1, b1, nullptr, nullptr, dout, B, M, N, C, CO, mean, r2,
      radius, t, const_cast<void*>(cnt), G, stream);
}
