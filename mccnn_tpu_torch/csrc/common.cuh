// Shared device helpers for the mccnn_tpu_torch kernels.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

// |p|^2 as ((x*x + y*y) + z*z), one rounding per op: the intrinsics keep nvcc
// from contracting a multiply and an add into an FMA, so the value is the
// one the plain PyTorch version computes with separate elementwise ops.
__device__ __forceinline__ float sq_norm_rn(float x, float y, float z) {
  return __fadd_rn(__fadd_rn(__fmul_rn(x, x), __fmul_rn(y, y)), __fmul_rn(z, z));
}

// d2 = (sq_a + sq_b) - 2 * ((xa*xb + ya*yb) + za*zb), evaluated in exactly
// the order of mccnn_tpu_torch/core/grid.py::pair_d2, so that `d2 <= r2`
// gives the same bit in a kernel and in the plain version.
__device__ __forceinline__ float pair_d2_rn(float ax, float ay, float az, float asq,
                                            float bx, float by, float bz, float bsq) {
  float dot = __fadd_rn(__fadd_rn(__fmul_rn(ax, bx), __fmul_rn(ay, by)), __fmul_rn(az, bz));
  return __fsub_rn(__fadd_rn(asq, bsq), __fmul_rn(2.0f, dot));
}

// The kernel MLP's first layer at one (sample q, source p) pair, as the dense
// forward (K1), the dense backward (K2) and the tile forward (K5) all form it:
// the offset o = (p - q) / r per axis, then
// pre_h = ((o_x w1[0][h] + o_y w1[1][h]) + o_z w1[2][h]) + b1[h],
// with every rounding written out so the three kernels agree bit for bit on
// the a_h = relu(pre_h) plane (``w1`` is (3, H) row-major, ``b1`` (H,)).
__device__ __forceinline__ float mc_offset(float p, float q, float radius) {
  return __fdiv_rn(__fsub_rn(p, q), radius);
}

__device__ __forceinline__ float mc_preact(float ox, float oy, float oz,
                                           const float* w1, const float* b1, int H,
                                           int h) {
  return __fadd_rn(__fmaf_rn(oz, w1[2 * H + h], __fmaf_rn(oy, w1[H + h], __fmul_rn(ox, w1[h]))),
                   b1[h]);
}

#define MCCNN_LAUNCH_RETURN() return static_cast<int>(cudaGetLastError())
