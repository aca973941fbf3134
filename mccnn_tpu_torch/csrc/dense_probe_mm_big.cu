// T1 mm_big: the dense conv's (H+1) contractions as bf16 tensor-core GEMMs.
//
// Replaces the Pallas body k_mm_big of tools/exp_dense_breakdown.py (:200,
// run by `call_big` :186, one grid step a cloud): with the plane stand-in
// a(i, j) = bf16(x_j) of every sample i and source j,
//
//   out[b, i, c] = sum_{h=0..H} w2[h % H, c] * g_h[b, i, c],
//   g_h[b, i, c] = sum_j a(i, j) * fz[b, j, c],
//
// the fold in h order in fp32 (one rounding per multiply and add, as the
// plain version `dense_probe_reference("mm_big", ...)` forms it). The TPU
// body's operands are bf16 with fp32 accumulation (preferred_element_type
// float32, :208-209), which is what the H100's bf16 tensor cores compute.
//
// It stays an instrument of the contraction, so nothing of the plane's
// rank-1 structure is used: the plane is materialised in shared memory for
// every (sample tile, source tile), as the TPU body's hoisted broadcast;
// each of the H+1 products is a real (M x N) @ (N x C) contraction over
// every source; no product is reused for another h. (One sum over j a cloud
// would reach the function's bound, a few microseconds, and measure
// nothing.) mm_only (csrc/dense_probe_staged.cu) is the same contraction on
// the same schedule in fp32 FMAs on the CUDA cores, and noop that schedule's
// loads alone, so mm_big - noop and mm_only - noop are the contraction on the
// tensor cores and on the CUDA cores.
//
// Design. The block tile, the steps and their stages are
// dense_probe_stage.cuh's: 128 samples x 64 channels of one cloud (128
// blocks at B = 8, N = 1024, C = 128, where the TPU's one grid step a cloud
// gave 8), 128 sources a step, fz resident up to N = 1024. Its eight warps
// each hold a 32 x 32 part: two tile accumulators in fp32 registers, g_h and
// the running output. For h = 0..H in turn it runs g_h's whole K loop, then
// folds g_h * w2[h % H] into the running sum and starts h + 1, so the fold
// keeps its order. The threads fill a step's plane tile (128 samples x 128
// sources) from the staged x one step ahead, into one of two plane stages.
// The warps read plane and fz with ldmatrix (rows XOR-swizzled by 16-byte
// chunk: no bank conflicts, no padding) and run mma.sync m16n8k16 bf16 with
// fp32 accumulators. Edge tiles (N or C not a multiple of the tile, C = 1)
// are zero-filled in shared memory; rows and channels past the ends are not
// stored. No atomics: two calls are bit-identical.
//
// Why this shape: with fz copied again for every h, the copies and the
// plane fills cost about as much as the MMAs, and the loop's barriers a
// fifth more; steps of 64 or 32 sources pay those barriers two and four
// times over, and tiles of four 64 x 32 warps, or 64 x 64 tiles two blocks
// an SM, were slower. wgmma (m64n64k16 from shared memory, two warpgroups)
// gave the same outputs bit for bit and was no faster: the tensor cores are
// not what bounds this kernel, the copies and plane fills around them are.
//
// What bounds it on the H100: its work is the (H+1) * 2 * M * N * C
// tensor-core operations (19.3 GFLOP at B = 8, N = M = 1024, C = 128: 0.0195
// ms at the 989 TFLOP/s bf16 peak), but the plane, re-formed in shared memory
// for every (h, step) as an instrument must, and the shared-memory traffic
// of the operands hold it above that. Limits: H == 8 (the caller's),
// 1 <= C <= 1024.

#include <cuda_bf16.h>

#include "common.cuh"
#include "dense_probe_stage.cuh"

namespace {

using namespace t1_stage;

// The block's tile (dense_probe_stage.cuh): 128 samples x 64 channels, eight
// warps of 32 x 32 (4 along samples, 2 along channels); 128 sources a step.
constexpr int kMT = 2, kNT = 4;  // a warp's 16-row and 8-column MMA tiles
constexpr int kPlanes = 2;       // plane stages
constexpr size_t kPlaneBytes = (size_t)kBM * kBK * 2;
constexpr size_t kSmem = kPlanes * kPlaneBytes + kStepsBytes;

__device__ __forceinline__ void ldmatrix_x4(uint32_t* r, const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t* r, const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

__device__ __forceinline__ void mma_bf16(float* d, const uint32_t* a, const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// The plane of a step from its staged x: a(i, j) = bf16(x_j) in every row,
// as the TPU body's broadcast. A thread converts the 8 sources of its column
// chunk once and stores them in each of its rows.
__device__ __forceinline__ void fill_plane(unsigned char* plane, const unsigned char* st) {
  const int q = threadIdx.x % (kBK / 8);
  const float4* xs = reinterpret_cast<const float4*>(step_x(st));
  const float4 lo = xs[2 * q], hi = xs[2 * q + 1];
  __align__(16) const __nv_bfloat16 v[8] = {
      __float2bfloat16_rn(lo.x), __float2bfloat16_rn(lo.y), __float2bfloat16_rn(lo.z),
      __float2bfloat16_rn(lo.w), __float2bfloat16_rn(hi.x), __float2bfloat16_rn(hi.y),
      __float2bfloat16_rn(hi.z), __float2bfloat16_rn(hi.w)};
  const uint4 pk = *reinterpret_cast<const uint4*>(v);
  uint4* as = reinterpret_cast<uint4*>(plane);
#pragma unroll
  for (int row = threadIdx.x / (kBK / 8); row < kBM; row += kThreads / (kBK / 8))
    as[row * (kBK / 8) + swz(row, q)] = pk;
}

template <bool kVec>
__global__ void __launch_bounds__(kThreads)
    mm_big_kernel(const float* __restrict__ pts, const __nv_bfloat16* __restrict__ fz,
                  const float* __restrict__ w2, int N, int C, int H, float* __restrict__ out) {
  extern __shared__ __align__(128) unsigned char smem[];
  unsigned char* planes = smem;
  unsigned char* steps = smem + kPlanes * kPlaneBytes;
  const int c0 = blockIdx.x * kBN, i0 = blockIdx.y * kBM, b = blockIdx.z;
  const float* X = pts + (size_t)b * N * 3;
  const __nv_bfloat16* F = fz + (size_t)b * N * C;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int wm = (warp % 4) * kMT * 16, wn = (warp / 4) * kNT * 8;  // this warp's part
  const int grp = lane / 4, tig = lane % 4;
  const int lq = lane / 8, lr = lane % 8;  // ldmatrix: this lane's matrix and row

  float g[kMT][kNT][4], run[kMT][kNT][4];
#pragma unroll
  for (int m = 0; m < kMT; ++m)
#pragma unroll
    for (int n = 0; n < kNT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) g[m][n][e] = run[m][n][e] = 0.f;

  // The steps of dense_probe_stage.cuh's Schedule in order; the plane of
  // step it + 1 is filled while step it computes.
  // w2[h % H] at this thread's channels, loaded when h starts
  float w[kNT][2];
  auto load_w = [&](int h) {
    const float* wrow = w2 + (size_t)(h % H) * C;
#pragma unroll
    for (int n = 0; n < kNT; ++n) {
      const int c = c0 + wn + 8 * n + 2 * tig;
      w[n][0] = c < C ? __ldg(wrow + c) : 0.f;
      w[n][1] = c + 1 < C ? __ldg(wrow + c + 1) : 0.f;
    }
  };
  load_w(0);

  Schedule sch(N, H);
  const int ksteps = sch.ksteps, total = sch.total;
  sch.start<kVec>(steps, X, F, N, C, c0);
  sch.wait(0);
  __syncthreads();
  fill_plane(planes, sch.stage(steps, 0));
  for (int it = 0; it < total; ++it) {
    sch.wait(it + 1);  // step it + 1's copies are in
    __syncthreads();  // step it's plane is filled; the stage step it - 1 used is free
    sch.advance<kVec>(steps, it, X, F, N, C, c0);
    if (it + 1 < total)
      fill_plane(planes + ((it + 1) % kPlanes) * kPlaneBytes, sch.stage(steps, it + 1));
    const uint4* as = reinterpret_cast<const uint4*>(planes + (it % kPlanes) * kPlaneBytes);
    const uint4* fs = reinterpret_cast<const uint4*>(sch.stage(steps, it));
#pragma unroll
    for (int kk = 0; kk < kBK; kk += 16) {
      uint32_t a[kMT][4], bq[kNT / 2][4];
#pragma unroll
      for (int m = 0; m < kMT; ++m) {
        const int row = wm + 16 * m + (lq % 2) * 8 + lr;
        ldmatrix_x4(a[m], as + row * (kBK / 8) + swz(row, kk / 8 + lq / 2));
      }
#pragma unroll
      for (int p = 0; p < kNT / 2; ++p) {  // channels wn + 16 p .. + 16: two n-tiles
        const int row = kk + (lq % 2) * 8 + lr;
        ldmatrix_x4_trans(bq[p], fs + row * (kBN / 8) + swz(row, (wn + 16 * p) / 8 + lq / 2));
      }
#pragma unroll
      for (int m = 0; m < kMT; ++m)
#pragma unroll
        for (int n = 0; n < kNT; ++n) mma_bf16(g[m][n], a[m], &bq[n / 2][2 * (n % 2)]);
    }
    if (it % ksteps == ksteps - 1) {  // g_h is complete: fold it in h order
#pragma unroll
      for (int n = 0; n < kNT; ++n)
#pragma unroll
        for (int m = 0; m < kMT; ++m)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            run[m][n][e] = __fadd_rn(run[m][n][e], __fmul_rn(g[m][n][e], w[n][e % 2]));
            g[m][n][e] = 0.f;
          }
      if (it + 1 < total) load_w(it / ksteps + 1);
    }
  }
#pragma unroll
  for (int m = 0; m < kMT; ++m)
#pragma unroll
    for (int n = 0; n < kNT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = i0 + wm + 16 * m + grp + 8 * (e / 2), c = c0 + wn + 8 * n + 2 * tig + e % 2;
        if (i < N && c < C) out[((size_t)b * N + i) * C + c] = run[m][n][e];
      }
}

}  // namespace

// pts (B, N, 3) fp32, fz (B, N, C) bf16, w2 (H, C) fp32; out (B, N, C) fp32.
// dense_probe_launch (csrc/dense_probe.cu) dispatches variant 5 here.
int dense_probe_mm_big_launch(const float* pts, const __nv_bfloat16* fz, const float* w2, int B,
                              int N, int C, int H, float* out, cudaStream_t stream) {
  const dim3 grid((C + kBN - 1) / kBN, (N + kBM - 1) / kBM, B);
  const auto kernel = C % 8 == 0 ? mm_big_kernel<true> : mm_big_kernel<false>;
  const cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kSmem);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<grid, kThreads, kSmem, stream>>>(pts, fz, w2, N, C, H, out);
  MCCNN_LAUNCH_RETURN();
}
