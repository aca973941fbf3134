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

#define MCCNN_LAUNCH_RETURN() return static_cast<int>(cudaGetLastError())
