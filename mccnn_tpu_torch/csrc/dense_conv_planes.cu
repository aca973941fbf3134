// K1p: the dense Monte-Carlo convolution, forward, with its pair planes' pre-
// activations formed on the tensor cores.
//
// Replaces mccnn_tpu/ops/pallas/dense_conv.py::_plane_fill_mxu (:314), which
// MCCNN_DENSE_PLANES=mxu (:357) puts in place of _plane_fill inside the v2
// forward _fwd_kernel_b (:409, called at :656). The TPU variant forms each
// pre-activation plane by a K = 2 matmul, [cw_h | 1] @ [1 ; -sw_h], instead of
// a broadcast subtract, and keeps the penalty, the ReLU and the cast on the
// vector unit; its docstring (:320-329) records that it bought nothing there.
// This kernel asks the same question of the H100 about the K1 that runs.
//
// It computes K1's function (G[b,i,h,c] = sum_j a_h(i,j) f~[b,j,c] and the
// in-radius count, then K1's projection kernel) with the pre-activations in
// the reference's factored form
//
//   pre_h(i, j) = (cw_h(j) - sw_h(i)) + b1_h,  cw = (p_j . W1) / r,  sw = (x_i . W1) / r.
//
// It is K1's pair kernel (csrc/dense_conv_pair.cuh) with one step changed:
//   1. mcconv_planes_pieces_kernel forms cw_h of every source and -sw_h of
//      every sample once (`mc_w1_proj`), split exactly into three TF32 pieces
//      each (11 significant bits a piece: three hold fp32's 24);
//   2. the pair kernel sweeps the sources into in-radius lists, as K1 does:
//      a pair out of radius or with a masked point costs one d2 test at
//      most, a group of 32 invalid sources none;
//   3. each complete list's entries get their pre-activations on the tensor
//      cores, 16 listed sources an MMA (`PlanesForm`: mma.sync m16n8k8 TF32,
//      the pieces in A and B, b1_h in the accumulator; every product is a
//      piece times 1, so exact), then the ReLU;
//   4. the contraction into G runs over the listed pairs only, each G value
//      one FMA chain in increasing j, with K1's passes and channel splits.
// So no pair outside the lists gets a plane value, G keeps the FMA chains of
// the all-pairs K1p (which added exact zeros for the pairs now skipped), and
// the count is K1's. No atomics: two calls are bit-identical.
//
// Why the MMA takes the listed entries (and not the planes of whole groups
// of 32 sources that hold a hit): a warp holds one sample's complete list at
// a time, so 16 entries fill the MMA's rows with no shared-memory plane tile
// (the block keeps K1's shared memory, two blocks an SM), and at the sparse
// sites (0.51M of 33.5M pairs in radius at the zoo's stem) a hit group's
// plane would form ~60 values for each one used. The cost is the MMA's
// columns: all 8 repeat the one sample. Why the pieces come from one kernel
// before the pair kernel: formed in each block instead, for each staged
// source (in shared memory), they cost every sample tile of a cloud the
// same 8 divisions and splits a source again, and K1p took 1.45x K1 at the
// zoo's stem on the H100 (0.2614 against 0.1797 ms at B = 32).
//
// What bounds it on the H100: as K1, the d2 sweep over every pair and the
// contraction's (H+1) FMAs a listed pair and channel on the CUDA cores; the
// MMAs are a small part. Limits: H == 8, C <= 1024.

#include "dense_conv_pair.cuh"

namespace {

__device__ __forceinline__ uint32_t to_tf32(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(x));
  return r;
}

// x = hi + mid + lo exactly, each piece a TF32 value: x - hi and its residual
// are exact in fp32, and the third piece has at most 3 significant bits.
__device__ __forceinline__ void split_tf32(float x, uint32_t* out) {
  const uint32_t hi = to_tf32(x);
  const float r1 = __fsub_rn(x, __uint_as_float(hi));
  const uint32_t mid = to_tf32(r1);
  out[0] = hi;
  out[1] = mid;
  out[2] = to_tf32(__fsub_rn(r1, __uint_as_float(mid)));
}

// The TF32 pieces of (x, y, z) . W1[:, h] / r (`mc_w1_proj`) at dst[k * H],
// each negated where `neg` (the sign bit: exact).
__device__ __forceinline__ void w1_pieces(float x, float y, float z, const float* w1, int h,
                                          float radius, bool neg, uint32_t* dst) {
  uint32_t pc[3];
  split_tf32(mc_w1_proj(x, y, z, w1, kHidden, h, radius), pc);
#pragma unroll
  for (int k = 0; k < 3; ++k) dst[k * kHidden] = neg ? pc[k] ^ 0x80000000u : pc[k];
}

// pieces[p][k][h]: the TF32 pieces of cw_h for the nsrc sources, then of
// -sw_h for the samples (the sign bit of each piece flipped: exact).
__global__ void mcconv_planes_pieces_kernel(const float* __restrict__ smp,
                                            const float* __restrict__ src,
                                            const float* __restrict__ w1, int nsrc, int npts,
                                            float radius, uint32_t* __restrict__ pieces) {
  const size_t t = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= (size_t)npts * kHidden) return;
  const size_t p = t / kHidden;
  const bool is_src = p < (size_t)nsrc;
  const float* q = is_src ? src + 3 * p : smp + 3 * (p - nsrc);
  w1_pieces(q[0], q[1], q[2], w1, (int)(t % kHidden), radius, !is_src,
            pieces + p * kPieceWords + t % kHidden);
}

}  // namespace

// The arguments of mcconv_pair_launch (csrc/dense_conv.cu) and a scratch of
// B * (N + M) * 3 * H 32-bit words, 16-byte aligned, for the pieces: G (B, M,
// H+1, C) and cnt (B, M) for K1's projection kernel.
extern "C" int mcconv_planes_pair_launch(const void* smp, const void* smask, const void* src,
                                         const void* srcmask, const void* wf, const void* w1,
                                         const void* b1, int B, int M, int N, int C, int H,
                                         float r2, float radius, void* G, void* cnt,
                                         void* pieces, void* stream) {
  if (H != kHidden || C < 1 || C > kMaxC || M < 1 || N < 1 || B < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  auto* pc = static_cast<uint32_t*>(pieces);
  const int npts = B * (N + M);
  mcconv_planes_pieces_kernel<<<div_up(npts * kHidden, 256), 256, 0, st>>>(
      static_cast<const float*>(smp), static_cast<const float*>(src),
      static_cast<const float*>(w1), B * N, npts, radius, pc);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  return launch_pair_kernel<true>(smp, smask, src, srcmask, wf, w1, b1, pc, B, M, N, C, r2,
                                  radius, G, cnt, st);
}
