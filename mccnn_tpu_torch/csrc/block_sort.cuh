// A stable LSD radix sort of one block's keys in shared memory: K4's culled
// layout (density_kernel.cu) sorts a cloud by the Hilbert index of its
// cells, K3 (poisson_kernel.cu) by its sampler cells.
//
// Keys are unsigned, sorted kDigitBits at a time from the lowest digit, each
// carried with a 16-bit item id. Warp w owns the items [w * per, (w + 1) *
// per) (per a multiple of 32). A pass counts each warp's digits with shared
// atomics (counters digit-major, one per (digit, warp)), takes one exclusive
// scan over them, and scatters: a warp ranks its lanes' equal digits with
// __match_any_sync in lane order, so equal keys keep their items' order, and
// the order is the same on every call.

#pragma once

#include "common.cuh"

namespace block_sort {

constexpr int kDigitBits = 8;
constexpr int kDigits = 1 << kDigitBits;
constexpr unsigned kFull = 0xffffffffu;

// The counters' ints for a block of `threads` (a multiple of 32).
__host__ __device__ constexpr int counter_ints(int threads) { return kDigits * (threads / 32); }

// Block-wide exclusive scan of one value a thread (blockDim a multiple of 32,
// at most 1024); `partial` holds 32 ints. Every thread calls it.
__device__ __forceinline__ int exclusive_scan(int v, int* partial) {
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5, nw = blockDim.x >> 5;
  int incl = v;
  for (int o = 1; o < 32; o <<= 1) {
    const int u = __shfl_up_sync(kFull, incl, o);
    if (lane >= o) incl += u;
  }
  if (lane == 31) partial[w] = incl;
  __syncthreads();
  if (w == 0) {
    const int mine = lane < nw ? partial[lane] : 0;
    int s = mine;
    for (int o = 1; o < 32; o <<= 1) {
      const int u = __shfl_up_sync(kFull, s, o);
      if (lane >= o) s += u;
    }
    if (lane < nw) partial[lane] = s - mine;  // exclusive over the warps
  }
  __syncthreads();
  const int out = partial[w] + incl - v;
  __syncthreads();  // partial may be reused
  return out;
}

// Sorts keys[0][0..n) with their ids idx[0][0..n) by the low `passes` digits;
// the result is in keys[passes & 1] and idx[passes & 1]. `cnt` holds
// counter_ints(blockDim.x) ints, `partial` 32. Every thread calls it after a
// barrier that completes the inputs; it ends with a barrier.
__device__ __forceinline__ void radix_sort(unsigned* keys[2], unsigned short* idx[2], int n,
                                           int passes, int* cnt, int* partial) {
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5, nw = blockDim.x >> 5;
  const int per = (n + 32 * nw - 1) / (32 * nw) * 32;
  for (int pass = 0; pass < passes; ++pass) {
    const unsigned* kin = keys[pass & 1];
    const unsigned short* iin = idx[pass & 1];
    unsigned* kout = keys[(pass + 1) & 1];
    unsigned short* iout = idx[(pass + 1) & 1];
    const int shift = pass * kDigitBits;
    for (int d = threadIdx.x; d < kDigits * nw; d += blockDim.x) cnt[d] = 0;
    __syncthreads();
    for (int r = 0; r < per / 32; ++r) {
      const int i = w * per + r * 32 + lane;
      if (i < n) atomicAdd(&cnt[((kin[i] >> shift) & (kDigits - 1)) * nw + w], 1);
    }
    __syncthreads();
    // exclusive prefix over (digit, warp), digit-major: kDigits / 32 a thread
    constexpr int kPerThread = kDigits / 32;
    int local[kPerThread], sum = 0;
#pragma unroll
    for (int k = 0; k < kPerThread; ++k) {
      local[k] = cnt[threadIdx.x * kPerThread + k];
      sum += local[k];
    }
    int run = exclusive_scan(sum, partial);
#pragma unroll
    for (int k = 0; k < kPerThread; ++k) {
      cnt[threadIdx.x * kPerThread + k] = run;
      run += local[k];
    }
    __syncthreads();
    for (int r = 0; r < per / 32; ++r) {
      const int i = w * per + r * 32 + lane;
      const bool active = i < n;
      const unsigned key = active ? kin[i] : 0u;
      const int digit = active ? (int)((key >> shift) & (kDigits - 1)) : kDigits + lane;
      const unsigned peers = __match_any_sync(kFull, digit);
      const int rank = __popc(peers & ((1u << lane) - 1u));
      int* slot = &cnt[(active ? digit : 0) * nw + w];
      if (active) {
        const int dst = *slot + rank;
        kout[dst] = key;
        iout[dst] = iin[i];
      }
      __syncwarp();
      if (active && rank == 0) *slot += __popc(peers);
      __syncwarp();
    }
    __syncthreads();
  }
}

}  // namespace block_sort
