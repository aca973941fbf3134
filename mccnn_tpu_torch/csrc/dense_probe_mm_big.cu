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
// nothing.) mm_only (csrc/dense_probe.cu) is the same contraction on K1's
// CUDA-core schedule: a thread walks its (sample, channel) outputs over every
// source in fp32 FMAs. mm_big is the same contraction as tensor-core GEMM
// tiles over the whole card, so the gap between the two is what a
// tensor-core contraction would buy K1.
//
// Design. A block owns a 128-sample x 64-channel output tile of one cloud
// (grid: channel tiles x sample tiles x clouds; 128 blocks at B = 8, N = 1024,
// C = 128, where the TPU's one grid step a cloud gave 8). Its eight warps
// each hold a 32 x 32 part: two tile accumulators in fp32 registers, g_h and
// the running output. For h = 0..H in turn it runs g_h's whole K loop
// (sources in steps of 128), then folds g_h * w2[h % H] into the running sum
// and starts h + 1, so the fold keeps its order. A step's fz tile (128
// sources x 64 channels) and x come by cp.async (16 bytes a copy of fz where
// C % 8 == 0, plain loads otherwise) into a step stage; the threads fill the
// step's plane tile (128 samples x 128 sources) from the staged x one step
// ahead, into one of two plane stages. The warps read plane and fz with
// ldmatrix (rows XOR-swizzled by 16-byte chunk: no bank conflicts, no
// padding) and run mma.sync m16n8k16 bf16 with fp32 accumulators. Up to
// N = 1024 (8 steps) every step keeps its own stage, so fz crosses from L2
// once a block and not once an h; beyond, the 8 stages are a ring, each
// step copied 7 steps ahead. Edge tiles (N or C not a multiple of the tile,
// C = 1) are zero-filled in shared memory; rows and channels past the ends
// are not stored. No atomics: two calls are bit-identical.
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

namespace {

// The block's tile: 128 samples x 64 channels, eight warps of 32 x 32 (4
// along samples, 2 along channels); 128 sources a step.
constexpr int kBM = 128, kBN = 64, kBK = 128, kThreads = 256;
constexpr int kMT = 2, kNT = 4;  // a warp's 16-row and 8-column MMA tiles
constexpr int kPlanes = 2;       // plane stages
constexpr int kMaxSteps = 8;     // fz stages: every step of N <= 1024, else a ring
constexpr size_t kPlaneBytes = (size_t)kBM * kBK * 2;
constexpr size_t kStepBytes = (size_t)kBK * kBN * 2 + kBK * 4;  // fz tile, then x
constexpr size_t kSmem = kPlanes * kPlaneBytes + kMaxSteps * kStepBytes;

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 (4) bytes global -> shared, the bytes past `src_bytes` zero-filled.
__device__ __forceinline__ void cp_async16(void* dst, const void* src, int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)), "l"(src),
               "r"(src_bytes));
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src, int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_addr(dst)), "l"(src),
               "r"(src_bytes));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

// Wait until at most n (0..7) of this thread's copy groups are pending.
__device__ __forceinline__ void cp_async_wait(int n) {
  switch (n < 0 ? 0 : n > 7 ? 7 : n) {
    case 0: asm volatile("cp.async.wait_group 0;\n" ::); break;
    case 1: asm volatile("cp.async.wait_group 1;\n" ::); break;
    case 2: asm volatile("cp.async.wait_group 2;\n" ::); break;
    case 3: asm volatile("cp.async.wait_group 3;\n" ::); break;
    case 4: asm volatile("cp.async.wait_group 4;\n" ::); break;
    case 5: asm volatile("cp.async.wait_group 5;\n" ::); break;
    case 6: asm volatile("cp.async.wait_group 6;\n" ::); break;
    default: asm volatile("cp.async.wait_group 7;\n" ::); break;
  }
}

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

// Rows of 16-byte chunks, chunk q of row r stored at q ^ (r % 8): ldmatrix
// reads 8 rows of one chunk from 8 different bank groups.
__device__ __forceinline__ int swz(int r, int q) { return q ^ (r & 7); }

// The copies of source step j0 into step stage `st`: its fz tile (BK rows of
// BN channels, 8 channels a copy where kVec, C % 8 == 0; plain loads
// otherwise) and its x, zero past N and C.
template <bool kVec>
__device__ __forceinline__ void copy_step(unsigned char* st, const float* __restrict__ X,
                                          const __nv_bfloat16* __restrict__ F, int N, int C,
                                          int c0, int j0) {
  uint4* fs = reinterpret_cast<uint4*>(st);
  for (int k = threadIdx.x; k < kBK * (kBN / 8); k += kThreads) {
    const int row = k / (kBN / 8), q = k % (kBN / 8);
    const int j = j0 + row, c = c0 + 8 * q;
    uint4* dst = fs + row * (kBN / 8) + swz(row, q);
    if constexpr (kVec) {
      const bool in = j < N && c < C;  // C % 8 == 0: a copy is all in or all out
      cp_async16(dst, in ? F + (size_t)j * C + c : F, in ? 16 : 0);
    } else {
      __align__(16) __nv_bfloat16 v[8];
#pragma unroll
      for (int e = 0; e < 8; ++e)
        v[e] = (j < N && c + e < C) ? F[(size_t)j * C + c + e] : __float2bfloat16_rn(0.f);
      *dst = *reinterpret_cast<const uint4*>(v);
    }
  }
  float* xs = reinterpret_cast<float*>(st + (size_t)kBK * kBN * 2);
  for (int k = threadIdx.x; k < kBK; k += kThreads) {
    const bool in = j0 + k < N;
    cp_async4(xs + k, in ? X + 3 * (size_t)(j0 + k) : X, in ? 4 : 0);
  }
}

// The plane of a step from its staged x: a(i, j) = bf16(x_j) in every row,
// as the TPU body's broadcast. A thread converts the 8 sources of its column
// chunk once and stores them in each of its rows.
__device__ __forceinline__ void fill_plane(unsigned char* plane, const unsigned char* st) {
  const int q = threadIdx.x % (kBK / 8);
  const float4* xs = reinterpret_cast<const float4*>(st + (size_t)kBK * kBN * 2);
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

  // Steps it = 0 .. total - 1 run in order: h = it / ksteps, sources
  // (it % ksteps) * BK ... Where every step fits (ksteps <= kMaxSteps), step
  // s stays in stage s and is copied once, during h = 0; otherwise the
  // stages are a ring, step it in stage it % R, copied R - 1 steps ahead.
  // The plane of step it + 1 is filled while step it computes.
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

  const int ksteps = (N + kBK - 1) / kBK, total = (H + 1) * ksteps;
  const bool resident = ksteps <= kMaxSteps;
  const int R = resident ? ksteps : kMaxSteps, ahead = resident ? ksteps : R - 1;
  auto stage = [&](int it) { return steps + (resident ? it % ksteps : it % R) * kStepBytes; };
  int issued = 0;  // copy groups committed
  for (; issued < ahead && issued < total; ++issued) {
    copy_step<kVec>(stage(issued), X, F, N, C, c0, (issued % ksteps) * kBK);
    cp_async_commit();
  }
  cp_async_wait(issued - 1);  // step 0's copies
  __syncthreads();
  fill_plane(planes, stage(0));
  for (int it = 0; it < total; ++it) {
    const int need = resident ? min(it + 1, ksteps - 1) : min(it + 1, total - 1);
    cp_async_wait(issued - 1 - need);  // step it + 1's copies are in
    __syncthreads();  // step it's plane is filled; the stage step it - 1 used is free
    if (!resident && it + ahead < total) {
      copy_step<kVec>(stage(it + ahead), X, F, N, C, c0, ((it + ahead) % ksteps) * kBK);
      cp_async_commit();
      ++issued;
    }
    if (it + 1 < total) fill_plane(planes + ((it + 1) % kPlanes) * kPlaneBytes, stage(it + 1));
    const uint4* as = reinterpret_cast<const uint4*>(planes + (it % kPlanes) * kPlaneBytes);
    const uint4* fs = reinterpret_cast<const uint4*>(stage(it));
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
