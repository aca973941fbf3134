// The staged source schedule of T1's contraction instruments: mm_big
// (csrc/dense_probe_mm_big.cu, tensor cores), mm_only and noop
// (csrc/dense_probe_staged.cu, CUDA cores and the loads alone).
//
// A block owns a kBM-sample x kBN-channel output tile of one cloud (grid:
// channel tiles x sample tiles x clouds; 128 blocks at B = 8, N = M = 1024,
// C = 128). It walks the steps it = 0 .. total - 1, total = (H + 1) *
// ksteps: h = it / ksteps, sources (it % ksteps) * kBK .. + kBK. A step's fz
// tile (kBK sources x kBN channels, bf16, rows of 16-byte chunks with chunk q
// of row r stored at q ^ (r % 8)) and its sources' x come by cp.async into
// a step stage (16 bytes a copy of fz where C % 8 == 0, plain loads
// otherwise; zero past N and C). Up to N = 1024 (kMaxSteps steps) step s
// stays in stage s and is copied once, during h = 0, so a block reads its
// fz from L2 once a call; beyond, the stages are a ring, step it in stage it
// % kMaxSteps, copied kMaxSteps - 1 steps ahead into the stage that step it
// - 1 has finished with.
#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

namespace t1_stage {

constexpr int kBM = 128, kBN = 64, kBK = 128, kThreads = 256;
constexpr int kMaxSteps = 8;  // stages: every step of N <= 1024, else a ring
constexpr size_t kStepBytes = (size_t)kBK * kBN * 2 + kBK * 4;  // fz tile, then x
constexpr size_t kStepsBytes = kMaxSteps * kStepBytes;

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

// Rows of 16-byte chunks, chunk q of row r stored at q ^ (r % 8): ldmatrix
// reads 8 rows of one chunk from 8 different bank groups.
__device__ __forceinline__ int swz(int r, int q) { return q ^ (r & 7); }

// The staged x of a step's kBK sources.
__device__ __forceinline__ const float* step_x(const unsigned char* st) {
  return reinterpret_cast<const float*>(st + (size_t)kBK * kBN * 2);
}

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

// A block's walk over the steps and their stages (`steps`: kMaxSteps stages
// of kStepBytes). Each thread keeps its own count of committed copy groups,
// one group a step.
struct Schedule {
  int ksteps, total, R, ahead, issued;
  bool resident;

  __host__ __device__ __forceinline__ Schedule(int N, int H)
      : ksteps((N + kBK - 1) / kBK), total((H + 1) * ksteps), issued(0) {
    resident = ksteps <= kMaxSteps;
    R = resident ? ksteps : kMaxSteps;
    ahead = resident ? ksteps : R - 1;
  }

  // The step copies of the walk: each step once where resident, every step
  // of every h in the ring.
  __host__ __device__ __forceinline__ int copies() const { return resident ? ksteps : total; }

  __device__ __forceinline__ unsigned char* stage(unsigned char* steps, int it) const {
    return steps + (it % R) * kStepBytes;
  }

  // Commits the copies of the steps before `upto` that are not yet issued.
  template <bool kVec>
  __device__ __forceinline__ void issue(unsigned char* steps, int upto, const float* X,
                                        const __nv_bfloat16* F, int N, int C, int c0) {
    for (; issued < upto && issued < total; ++issued) {
      copy_step<kVec>(stage(steps, issued), X, F, N, C, c0, (issued % ksteps) * kBK);
      cp_async_commit();
    }
  }

  // Before the walk: every step where they are resident, else the first R - 1.
  template <bool kVec>
  __device__ __forceinline__ void start(unsigned char* steps, const float* X,
                                        const __nv_bfloat16* F, int N, int C, int c0) {
    issue<kVec>(steps, ahead, X, F, N, C, c0);
  }

  // At step it, after the barrier that frees step it - 1's stage: in the
  // ring, the copies of step it + R - 1 into it.
  template <bool kVec>
  __device__ __forceinline__ void advance(unsigned char* steps, int it, const float* X,
                                          const __nv_bfloat16* F, int N, int C, int c0) {
    if (!resident) issue<kVec>(steps, it + ahead + 1, X, F, N, C, c0);
  }

  // Until this thread's copies of step it have landed.
  __device__ __forceinline__ void wait(int it) const {
    cp_async_wait(issued - 1 - (resident ? min(it, ksteps - 1) : min(it, total - 1)));
  }
};

}  // namespace t1_stage
