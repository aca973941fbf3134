// T1 noop and mm_only on mm_big's staged schedule (dense_probe_stage.cuh).
//
// Replace the Pallas bodies k_noop (:182) and k_mm_only (:96) of
// tools/exp_dense_breakdown.py, run by its `call` (:84-94), which fetches
// each cloud's positions and fz into VMEM before the body runs:
//
//   noop:    out[b, i, c] = w2[0, 0];
//   mm_only: out[b, i, c] = sum_{h=0..H} w2[h % H, c] * g_h[b, i, c],
//            g_h[b, i, c] = sum_j a(i, j) * fz[b, j, c],
//
// with the plane stand-in a(i, j) = bf16(x_j) of every sample i and source
// j, and the fold in h order in fp32 (one rounding per multiply and add), as
// the plain versions `dense_probe_reference("noop" / "mm_only", ...)` form
// them.
//
// Both walk mm_big's schedule: a block owns a 128-sample x 64-channel tile of
// one cloud, and its fz arrives by cp.async in steps of 128 sources, resident
// up to N = 1024. So mm_big - noop, mm_only - noop and noop are the tensor-
// core contraction, the CUDA-core contraction and the loads of one schedule.
//
// noop is that schedule with no work on top: the same grid, the same copies
// of fz and x a step, each waited on and followed by the barrier, as mm_only
// waits on them; then w2[0, 0] is written to the block's tile with 16-byte
// stores. At B = 8, N = M = 1024, C = 128 its 128 blocks stage 8 steps of
// 16,896 bytes each: 17,301,504 bytes from L2 (16 MiB of fz, 512 KiB of x),
// and write 4,194,304 bytes of output.
//
// mm_only stays the CUDA-core instrument of the contraction: no tensor-core
// instruction, and, as in mm_big, nothing of the plane's rank-1 structure:
// for every (h, step) the plane is formed in shared memory from the staged
// x, and each of the H+1 products runs over every (sample, source) pair, no
// product reused for another h. h is the outer loop: a block runs g_h's
// whole source loop over the staged steps, folds g_h * w2[h % H] into its
// running tile and starts h + 1. Each thread owns 8 samples x 4 channels
// (warps 4 along samples x 2 along channels, each 32 x 32; lanes 4 x 8 in
// it) in fp32 registers, g_h and the running output. bf16 is widened once
// per plane tile: the plane is formed in fp32 and the tile's fz rows are
// widened into an fp32 copy, 64 sources at a time (a whole step's fp32
// plane and fz beside the eight resident stages pass the 227 KB of shared
// memory). Per source a thread then makes two 16-byte plane loads and one
// 16-byte fz load for its 32 FFMAs. Each output's g_h is one FFMA a source
// in increasing j from 0 (the products of bf16 values are exact in fp32)
// and the fold __fmul_rn / __fadd_rn in h order, so the output is bit-equal
// to the all-pairs mm_only of csrc/dense_probe.cu's K1 schedule before it.
// Widening in registers instead (a bf16 plane tile of a whole step and fz
// read from its stage, one 16-byte and one 8-byte load and 12 shifts or
// masks a source) was slower on the H100 (PERF.md, T1 mm_only): the
// widening costs more issue slots than the copies cost shared-memory stores.
//
// Why this shape: the plane fills and the barriers around them are the
// largest cost beside the FFMAs, so each thread's fill loads are issued
// before its stores (a fill loop strided by the thread index paid their
// latencies one after the other). Filling the next tile into a second
// buffer, by all threads or by four producer warps beside four consumer
// warps of 8 x 8 outputs, halves the tile and pays its barriers twice, and
// was slower; 8 x 8 outputs on 128 threads and loads prefetched a source
// ahead were no faster.
//
// What bounds it on the H100: mm_only's walked work is (H+1) * 2 * M * N * C
// fp32 operations, 19.33 GFLOP at the tool's shape, 0.2885 ms at the 67
// TFLOP/s fp32 peak (128 blocks fill 128 of the 132 SMs): the FFMA issue
// slots, with the plane fills and barriers beside them. noop is bound by
// its copies from L2 and the launch. Limits: H == 8 (the caller's), 1 <= C
// <= 1024.

#include <cuda_bf16.h>

#include <climits>

#include "common.cuh"
#include "dense_probe_stage.cuh"

namespace {

using namespace t1_stage;

// mm_only's plane tile: the plane in fp32 and the tile's fz rows as an fp32
// copy, 64 sources (what shared memory holds beside the eight resident
// stages).
constexpr int kSub = 64, kTiles = kBK / kSub;                   // tiles a step
constexpr size_t kPlaneBytes = (size_t)kSub * kBM * 4;          // [kSub][kBM]
constexpr size_t kFzBytes = (size_t)kSub * kBN * 4;             // [kSub][kBN]
constexpr size_t kMmOnlySmem = kStepsBytes + kPlaneBytes + kFzBytes;

__device__ __forceinline__ float bf16_round(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

__device__ __forceinline__ float bf16_lo(uint32_t u) { return __uint_as_float(u << 16); }
__device__ __forceinline__ float bf16_hi(uint32_t u) { return __uint_as_float(u & 0xffff0000u); }

__device__ __forceinline__ void widen8(float* a, uint4 v) {
  a[0] = bf16_lo(v.x), a[1] = bf16_hi(v.x), a[2] = bf16_lo(v.y), a[3] = bf16_hi(v.y);
  a[4] = bf16_lo(v.z), a[5] = bf16_hi(v.z), a[6] = bf16_lo(v.w), a[7] = bf16_hi(v.w);
}

// Plane tile `sub` of stage `st`: a(i, j) = bf16(x_j) in every sample's
// column of source row j, and its fz rows widened to fp32.
// Each thread's share in fixed counts, all its loads issued before its
// stores (a loop strided by the thread index pays their latencies in turn).
__device__ __forceinline__ void fill(float* plane, float* fz32, const unsigned char* st,
                                     int sub) {
  const float* xs = step_x(st) + sub * kSub;
  constexpr int kStores = kSub * kBM / 4 / kThreads;  // a thread's 16-byte plane stores
  float a[kStores];
#pragma unroll
  for (int m = 0; m < kStores; ++m)
    a[m] = bf16_round(xs[(threadIdx.x + m * kThreads) / (kBM / 4)]);
#pragma unroll
  for (int m = 0; m < kStores; ++m)
    reinterpret_cast<float4*>(plane)[threadIdx.x + m * kThreads] =
        make_float4(a[m], a[m], a[m], a[m]);
  constexpr int kChunks = kSub * (kBN / 8) / kThreads;  // a thread's 8-channel chunks
  const uint4* fs = reinterpret_cast<const uint4*>(st);
  float4* f32 = reinterpret_cast<float4*>(fz32);
  uint4 v[kChunks];
#pragma unroll
  for (int m = 0; m < kChunks; ++m) {
    const int k = threadIdx.x + m * kThreads, row = sub * kSub + k / (kBN / 8);
    v[m] = fs[row * (kBN / 8) + swz(row, k % (kBN / 8))];
  }
#pragma unroll
  for (int m = 0; m < kChunks; ++m) {
    const int k = threadIdx.x + m * kThreads;
    float w[8];
    widen8(w, v[m]);
    f32[2 * k] = make_float4(w[0], w[1], w[2], w[3]);
    f32[2 * k + 1] = make_float4(w[4], w[5], w[6], w[7]);
  }
}

// g[s][c] += a(ms + s, j) * fz(j, ns + c) over the plane tile's nj sources,
// in increasing j, one FFMA each: per source this thread's 8 plane values
// and 4 fz values as 16-byte loads. kFull: nj is the whole tile.
template <bool kFull>
__device__ __forceinline__ void contract(float (&g)[8][4], const float* plane, const float* fz32,
                                         int nj, int ms, int ns) {
  const int n = kFull ? kSub : nj;
  for (int j8 = 0; j8 < n; j8 += 8) {
#pragma unroll
    for (int u = 0; u < 8; ++u) {
      const int j = j8 + u;
      if (!kFull && j >= n) break;
      const float4* pl = reinterpret_cast<const float4*>(plane + j * kBM + ms);
      const float4 lo = pl[0], hi = pl[1];
      const float a[8] = {lo.x, lo.y, lo.z, lo.w, hi.x, hi.y, hi.z, hi.w};
      const float4 v = *reinterpret_cast<const float4*>(fz32 + j * kBN + ns);
      const float f[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
      for (int s = 0; s < 8; ++s)
#pragma unroll
        for (int c = 0; c < 4; ++c) g[s][c] = __fmaf_rn(a[s], f[c], g[s][c]);
    }
  }
}

// four outputs at (row, c .. c + 3), 16 bytes where C % 4 == 0
__device__ __forceinline__ void store4(float* __restrict__ row, const float* v, int C, int c) {
  if (C % 4 == 0 && c < C) {
    *reinterpret_cast<float4*>(row + c) = make_float4(v[0], v[1], v[2], v[3]);
  } else {
#pragma unroll
    for (int e = 0; e < 4; ++e)
      if (c + e < C) row[c + e] = v[e];
  }
}

template <bool kVec>
__global__ void __launch_bounds__(kThreads)
    noop_kernel(const float* __restrict__ pts, const __nv_bfloat16* __restrict__ fz,
                const float* __restrict__ w2, int N, int C, int H, float* __restrict__ out) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int c0 = blockIdx.x * kBN, i0 = blockIdx.y * kBM, b = blockIdx.z;
  const float* X = pts + (size_t)b * N * 3;
  const __nv_bfloat16* F = fz + (size_t)b * N * C;
  Schedule sch(N, H);
  sch.start<kVec>(smem, X, F, N, C, c0);
  // every copy mm_only makes: each step once where resident, (H+1) times in the ring
  for (int it = 0; it < sch.copies(); ++it) {
    sch.wait(it);
    __syncthreads();
    sch.advance<kVec>(smem, it, X, F, N, C, c0);
  }
  const float v[4] = {__ldg(w2), __ldg(w2), __ldg(w2), __ldg(w2)};
  for (int k = threadIdx.x; k < kBM * (kBN / 4); k += kThreads) {
    const int i = i0 + k / (kBN / 4), c = c0 + 4 * (k % (kBN / 4));
    if (i < N) store4(out + ((size_t)b * N + i) * C, v, C, c);
  }
}

template <bool kVec>
__global__ void __launch_bounds__(kThreads)
    mm_only_kernel(const float* __restrict__ pts, const __nv_bfloat16* __restrict__ fz,
                   const float* __restrict__ w2, int N, int C, int H, float* __restrict__ out) {
  extern __shared__ __align__(128) unsigned char smem[];
  unsigned char* steps = smem;
  float* plane = reinterpret_cast<float*>(smem + kStepsBytes);
  float* fz32 = reinterpret_cast<float*>(smem + kStepsBytes + kPlaneBytes);
  const int c0 = blockIdx.x * kBN, i0 = blockIdx.y * kBM, b = blockIdx.z;
  const float* X = pts + (size_t)b * N * 3;
  const __nv_bfloat16* F = fz + (size_t)b * N * C;
  // warps of 32 samples x 32 channels, 4 along the samples; lanes 4 x 8 in it
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int ms = (warp % 4) * 32 + (lane / 8) * 8;  // this thread's samples, in the tile
  const int ns = (warp / 4) * 32 + (lane % 8) * 4;  // and channels

  float g[8][4], run[8][4], w[4];
#pragma unroll
  for (int s = 0; s < 8; ++s)
#pragma unroll
    for (int c = 0; c < 4; ++c) g[s][c] = run[s][c] = 0.f;
  auto load_w = [&](int h) {  // w2[h % H] at this thread's channels
#pragma unroll
    for (int c = 0; c < 4; ++c)
      w[c] = c0 + ns + c < C ? __ldg(w2 + (size_t)(h % H) * C + c0 + ns + c) : 0.f;
  };
  load_w(0);

  Schedule sch(N, H);
  sch.start<kVec>(steps, X, F, N, C, c0);
  for (int it = 0; it < sch.total; ++it) {
    sch.wait(it);
    __syncthreads();  // step it is in; step it - 1's plane and stage are consumed
    sch.advance<kVec>(steps, it, X, F, N, C, c0);
    const unsigned char* st = sch.stage(steps, it);
    const int j0 = (it % sch.ksteps) * kBK;
    for (int sub = 0; sub < kTiles; ++sub) {
      const int nj = min(kSub, N - j0 - sub * kSub);
      if (nj <= 0) break;
      if (sub > 0) __syncthreads();  // the previous plane tile is consumed
      fill(plane, fz32, st, sub);
      __syncthreads();
      if (nj == kSub)
        contract<true>(g, plane, fz32, nj, ms, ns);
      else
        contract<false>(g, plane, fz32, nj, ms, ns);
    }
    if (it % sch.ksteps == sch.ksteps - 1) {  // g_h is complete: fold it in h order
#pragma unroll
      for (int s = 0; s < 8; ++s)
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          run[s][c] = __fadd_rn(run[s][c], __fmul_rn(g[s][c], w[c]));
          g[s][c] = 0.f;
        }
      if (it + 1 < sch.total) load_w(it / sch.ksteps + 1);
    }
  }
#pragma unroll
  for (int s = 0; s < 8; ++s)
    if (i0 + ms + s < N) store4(out + ((size_t)b * N + i0 + ms + s) * C, run[s], C, c0 + ns);
}

dim3 grid_of(int B, int N, int C) { return dim3((C + kBN - 1) / kBN, (N + kBM - 1) / kBM, B); }

template <typename Kernel>
int launch(Kernel kernel, size_t smem, const float* pts, const __nv_bfloat16* fz,
           const float* w2, int B, int N, int C, int H, float* out, cudaStream_t stream) {
  const cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<grid_of(B, N, C), kThreads, smem, stream>>>(pts, fz, w2, N, C, H, out);
  MCCNN_LAUNCH_RETURN();
}

}  // namespace

// pts (B, N, 3) fp32, fz (B, N, C) bf16, w2 (H, C) fp32; out (B, N, C) fp32.
// dense_probe_launch (csrc/dense_probe.cu) dispatches variant 4 here.
int dense_probe_noop_launch(const float* pts, const __nv_bfloat16* fz, const float* w2, int B,
                            int N, int C, int H, float* out, cudaStream_t stream) {
  const auto kernel = C % 8 == 0 ? noop_kernel<true> : noop_kernel<false>;
  return launch(kernel, kStepsBytes, pts, fz, w2, B, N, C, H, out, stream);
}

// As noop: variant 0.
int dense_probe_mm_only_launch(const float* pts, const __nv_bfloat16* fz, const float* w2, int B,
                               int N, int C, int H, float* out, cudaStream_t stream) {
  const auto kernel = C % 8 == 0 ? mm_only_kernel<true> : mm_only_kernel<false>;
  return launch(kernel, kMmOnlySmem, pts, fz, w2, B, N, C, H, out, stream);
}

// The bytes of fz and x that noop, mm_only and mm_big copy from L2 into
// shared memory in one call at (B, N, C, H): every block's step copies, -1
// past INT_MAX.
extern "C" int dense_probe_staged_bytes(int B, int N, int C, int H) {
  const dim3 g = grid_of(B, N, C);
  const long long bytes =
      (long long)g.x * g.y * g.z * Schedule(N, H).copies() * (long long)kStepBytes;
  return bytes > INT_MAX ? -1 : static_cast<int>(bytes);
}
