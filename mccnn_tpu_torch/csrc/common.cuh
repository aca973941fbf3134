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

// (p . W1[:, h]) / r, one rounding per op: the projections cw (sources) and
// sw (samples) of the factored pre-activation (cw_h(j) - sw_h(i)) + b1_h that
// K1p and the K5 `planes` probe form, as dense_conv._factored_preact's plain
// twin rounds them.
__device__ __forceinline__ float mc_w1_proj(float x, float y, float z, const float* w1, int H,
                                            int h, float radius) {
  return __fdiv_rn(
      __fadd_rn(__fadd_rn(__fmul_rn(x, w1[h]), __fmul_rn(y, w1[H + h])), __fmul_rn(z, w1[2 * H + h])),
      radius);
}

// Cell-bucket layouts (mccnn_tpu_torch/core/buckets.py): (R+2)^3 padded cells,
// z fastest, `cap` slots a cell, the kept points of a cell in its first
// count[cell] slots. A bucket kernel's block takes real cell `cell` (of R^3);
// this is its padded id.
__device__ __forceinline__ int bucket_padded_cell(int cell, int R) {
  const int Rp = R + 2;
  const int cx = cell / (R * R), cy = (cell / R) % R, cz = cell % R;
  return ((cx + 1) * Rp + (cy + 1)) * Rp + (cz + 1);
}

// The real cell (of R^3) that K9a / K10a give block `x` of their grid: brick
// `ids[x / (4 * bz * nsc)]` of the cloud's list, its cell `(x / nsc) % (4 * bz)`
// and slot chunk `x % nsc` (into *chunk). A brick is 2 x 2 x bz cells; bricks
// are numbered x-major with z fastest, and so are the cells of a brick, as
// mccnn_tpu/ops/pallas/mcconv_kernel.py::_block_perm orders them.
__device__ __forceinline__ int bucket_brick_cell(const int* __restrict__ ids, int x, int nsc,
                                                 int R, int bz, int* chunk) {
  const int per = 4 * bz * nsc;
  const int brick = ids[x / per], local = (x % per) / nsc;
  *chunk = x % nsc;
  const int nbx = R / 2, nbz = R / bz;
  const int bx = brick / (nbx * nbz), by = (brick / nbz) % nbx, bk = brick % nbz;
  const int dx = local / (2 * bz), dy = (local / bz) % 2, dz = local % bz;
  return ((2 * bx + dx) * R + (2 * by + dy)) * R + bz * bk + dz;
}

// The 27 window cells of padded cell `pid` (z fastest) into wcell, and the
// prefix sums of their kept counts into wstart[0..27]; returns the window's
// kept total. Every thread of the block calls it (two barriers).
__device__ __forceinline__ int bucket_window_prefix(const int* __restrict__ count, int pid,
                                                    int Rp, int* wcell, int* wstart) {
  if (threadIdx.x < 27) {
    const int k = threadIdx.x;
    const int dx = k / 9 - 1, dy = (k / 3) % 3 - 1, dz = k % 3 - 1;
    wcell[k] = pid + (dx * Rp + dy) * Rp + dz;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    int acc = 0;
    for (int k = 0; k < 27; ++k) {
      wstart[k] = acc;
      acc += count[wcell[k]];
    }
    wstart[27] = acc;
  }
  __syncthreads();
  return wstart[27];
}

// The slot (within one cloud's layout) of the window's j-th kept point, in
// window order: cell by cell, each cell's kept slots in order.
__device__ __forceinline__ size_t bucket_window_slot(const int* wcell, const int* wstart, int j,
                                                     int cap) {
  int k = 0;
  while (wstart[k + 1] <= j) ++k;
  return (size_t)wcell[k] * cap + (j - wstart[k]);
}

#define MCCNN_LAUNCH_RETURN() return static_cast<int>(cudaGetLastError())
