// K3: the 27-colour maximal Poisson-disk sweep, one cloud per block.
//
// Replaces mccnn_tpu/ops/pallas/poisson_kernel.py::_sweep_kernel (the default
// v1, reached through poisson_sweep_pallas from core/sampling.py::poisson_disk).
// Semantics are those of core/sampling.py::_poisson_dense: for colour
// c = 0..26, a point is a candidate if it is valid, uncovered, of colour c, and
// no valid uncovered point of its cell has a lower index; every candidate is
// selected, and every point within r of a candidate becomes covered.
//
// What bounds it on the H100: latency, not bytes. The 27 colour steps depend
// on each other, so a cloud is one chain of barrier-separated phases on one
// SM. The parent body linked each point to the previous valid point of its
// cell by scanning back over every lower index, and then, a colour at a
// time, tested every point against the colour and every uncovered point
// against every candidate. Its split on the card (tools.poisson_split, the
// share of a block's span; an H100 80GB HBM3 at 700 W):
//   N = 1024, r = 0.1 (MCClassS, B = 32)     links 0.63, colours 0.36
//   N = 1944, r = 0.15 (ScanNet, B = 8)      links 0.64, colours 0.36
//   N = 4096, r = 0.1 (--points 4096)        links 0.86, colours 0.14
//   N = 224-496, r = 0.4                     links 0.19-0.37, colours 0.62-0.80
//   N = 1024, r = 0.025 (ShapeNet)           links 0.41, colours 0.59 (coverage 0.51)
// and the cheapest colour step took 870-1650 cycles, three barriers and a
// pass over every point.
//
// This body sorts the cloud once, in shared memory, by (colour, cell,
// index): a stable LSD radix sort (block_sort.cuh, K4's) of the valid
// points' keys colour * cells + cell, the invalid ones after them. Then a
// colour's points are one contiguous range and each of its cells one run in
// index order, so a colour step
//   * lists candidates from the run starts of its range: a run's candidate
//     is its first uncovered point (the walk stops there), appended to a
//     shared list as float4 (x, y, z, |p|^2);
//   * tests coverage only for the uncovered points of the later colours' ranges:
//     nothing reads the coverage of a colour whose step is done, and the last
//     colour needs none. A point tests the step's candidates (the list's
//     order does not matter: coverage is an OR) with pair_d2_rn, the
//     plain version's expression, so the selection is the plain version's
//     bit for bit;
//   * takes two barriers: the candidate counter alternates between two
//     slots, the idle one reset during the coverage phase.
// Rows are written back through the sort's ids. B clouds run as B blocks,
// min(1024, N rounded up to 32) threads each.
//
// Limit: N <= 4096 (39 bytes a point and the sort's counters in shared
// memory: 156 KB at 4096 points), the reference's dense sampler bound
// (core/sampling.py DENSE_SAMPLER_MAX_N). The TPU kernel's MAX_N = 1024 was
// a VMEM bound for its (N, N) planes; this kernel holds no N x N plane.

#include "block_sort.cuh"
#include "common.cuh"

namespace {

constexpr int kPoissonMaxN = 4096;
constexpr int kMaxThreads = 1024;
constexpr int kPer = kPoissonMaxN / kMaxThreads;  // points a thread, at most
constexpr int kColours = 27;
constexpr int kStamps = 64;  // clock64 stamps a block of the probe build

// The probe build (kProbe), launched only by tools.poisson_split, stamps the
// ends of the phases: just before the barrier that closes a phase, lane 0 of
// every warp takes clock64 and the block keeps the largest (the last warp's
// arrival, when the barrier opens). [0] the start, [1] the cloud loaded, [2]
// the cloud sorted and laid out, [3 + 2c] colour c's candidates listed,
// [4 + 2c] colour c's coverage done. The stamps lie after the main build's
// shared memory (stamp_offset), which the probe's launch extends.
template <bool kProbe>
__device__ __forceinline__ void arrive(unsigned long long* st, int k) {
  if (kProbe && (threadIdx.x & 31) == 0) atomicMax(&st[k], (unsigned long long)clock64());
}

// Shared memory of a cloud of N points and a block of `threads`: the sorted
// rows (float4), a region that holds the sort's keys and counters and then
// the candidates (float4), the sort's ids (2 x ushort), and the covered,
// selected and run-start bytes.
__host__ __device__ constexpr size_t region_bytes(int N, int threads) {
  return 16 * (size_t)N > 8 * (size_t)N + 4 * (size_t)block_sort::counter_ints(threads)
             ? 16 * (size_t)N
             : 8 * (size_t)N + 4 * (size_t)block_sort::counter_ints(threads);
}

__host__ __device__ constexpr size_t smem_bytes(int N, int threads) {
  return 16 * (size_t)N + region_bytes(N, threads) + 4 * (size_t)N + 3 * (size_t)N;
}

__host__ __device__ constexpr size_t stamp_offset(int N, int threads) {
  return (smem_bytes(N, threads) + 7) / 8 * 8;
}

template <bool kProbe>
__global__ void __launch_bounds__(kMaxThreads)
poisson_sweep_kernel(const float* __restrict__ pts, const uint8_t* __restrict__ mask,
                     const int* __restrict__ cids, const int* __restrict__ colors, int N,
                     float r2, uint8_t* __restrict__ sel_out, long long* __restrict__ stamps) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int T = blockDim.x;
  float4* spos = reinterpret_cast<float4*>(smem);  // sorted rows: x, y, z, |p|^2
  unsigned char* region = smem + 16 * (size_t)N;
  float4* cand = reinterpret_cast<float4*>(region);  // a colour's candidates
  unsigned* keys[2] = {reinterpret_cast<unsigned*>(region),
                       reinterpret_cast<unsigned*>(region) + N};
  int* cnt = reinterpret_cast<int*>(region + 8 * (size_t)N);
  unsigned short* idx[2] = {reinterpret_cast<unsigned short*>(region + region_bytes(N, T)),
                            reinterpret_cast<unsigned short*>(region + region_bytes(N, T)) + N};
  uint8_t* covered = reinterpret_cast<uint8_t*>(idx[1] + N);
  uint8_t* selected = covered + N;
  uint8_t* first = selected + N;  // a sorted row starts its cell's run
  __shared__ int start[kColours + 1];  // valid points of each colour, then their starts
  __shared__ int ncand[2];             // colour c appends to ncand[c & 1]
  __shared__ int maxcid, partial[32];
  unsigned long long* st =
      kProbe ? reinterpret_cast<unsigned long long*>(smem + stamp_offset(N, T)) : nullptr;

  const int b = blockIdx.x;
  const size_t base = (size_t)b * N;
  if (threadIdx.x <= kColours) start[threadIdx.x] = 0;
  if (threadIdx.x == 0) {
    maxcid = -1;
    ncand[0] = ncand[1] = 0;
  }
  if constexpr (kProbe)
    for (int k = threadIdx.x; k < kStamps; k += T) st[k] = 0;
  __syncthreads();
  if (kProbe && threadIdx.x == 0) st[0] = clock64();

  // The load: each point's cell, colour and validity; the largest valid cell
  // id and the colours' counts.
  int cid[kPer], col[kPer];
  bool ok[kPer];
  int top = -1;
#pragma unroll
  for (int i = 0; i < kPer; ++i) {
    const int p = threadIdx.x + i * T;
    ok[i] = p < N && mask[base + p];
    cid[i] = ok[i] ? cids[base + p] : 0;
    col[i] = ok[i] ? colors[base + p] : 0;
    if (ok[i]) {
      top = max(top, cid[i]);
      atomicAdd(&start[col[i]], 1);
    }
  }
  top = __reduce_max_sync(0xffffffffu, top);
  if ((threadIdx.x & 31) == 0) atomicMax(&maxcid, top);
  arrive<kProbe>(st, 1);
  __syncthreads();

  // Keys: (colour, cell) for a valid point, one value after them all for the
  // rest; the stable sort keeps index order within a cell.
  const unsigned cells = (unsigned)(maxcid + 1);
  const unsigned after = kColours * cells;
  const int passes = max(1, (32 - __clz(after) + block_sort::kDigitBits - 1) /
                                block_sort::kDigitBits);
#pragma unroll
  for (int i = 0; i < kPer; ++i) {
    const int p = threadIdx.x + i * T;
    if (p < N) {
      keys[0][p] = ok[i] ? (unsigned)col[i] * cells + (unsigned)cid[i] : after;
      idx[0][p] = (unsigned short)p;
    }
  }
  if (threadIdx.x == 0) {  // the colours' exclusive starts
    int acc = 0;
    for (int c = 0; c <= kColours; ++c) {
      const int n = c < kColours ? start[c] : 0;
      start[c] = acc;
      acc += n;
    }
  }
  __syncthreads();
  block_sort::radix_sort(keys, idx, N, passes, cnt, partial);
  const unsigned* skey = keys[passes & 1];
  const unsigned short* sid = idx[passes & 1];
  for (int k = threadIdx.x; k < N; k += T) {
    const int i = sid[k];
    const float x = pts[3 * (base + i)], y = pts[3 * (base + i) + 1],
                z = pts[3 * (base + i) + 2];
    spos[k] = make_float4(x, y, z, sq_norm_rn(x, y, z));
    first[k] = k == 0 || skey[k - 1] != skey[k];
    covered[k] = 0;
    selected[k] = 0;
  }
  arrive<kProbe>(st, 2);
  __syncthreads();  // the keys are consumed: their room holds the candidates

  const int nvalid = start[kColours];
  for (int c = 0; c < kColours; ++c) {
    // Candidates: in each run of colour c's range, its first uncovered point.
    const int s0 = start[c], s1 = start[c + 1];
    for (int k = s0 + threadIdx.x; k < s1; k += T) {
      if (!first[k]) continue;
      int q = k;
      while (covered[q]) {
        if (++q == s1 || first[q]) {
          q = -1;
          break;
        }
      }
      if (q >= 0) {
        selected[q] = 1;
        cand[atomicAdd(&ncand[c & 1], 1)] = spos[q];
      }
    }
    arrive<kProbe>(st, 3 + 2 * c);
    __syncthreads();
    // Coverage of the later colours' points (no later step reads an earlier
    // colour's coverage); the other counter is reset for the next colour.
    const int n = ncand[c & 1];
    if (threadIdx.x == 0) ncand[(c + 1) & 1] = 0;
    if (n > 0) {
      for (int k = s1 + threadIdx.x; k < nvalid; k += T) {
        if (covered[k]) continue;
        const float4 p = spos[k];
        for (int j = 0; j < n; ++j) {
          const float4 q = cand[j];
          if (pair_d2_rn(p.x, p.y, p.z, p.w, q.x, q.y, q.z, q.w) <= r2) {
            covered[k] = 1;
            break;
          }
        }
      }
    }
    arrive<kProbe>(st, 4 + 2 * c);
    __syncthreads();
  }
  for (int k = threadIdx.x; k < N; k += T) sel_out[base + sid[k]] = selected[k];
  if constexpr (kProbe)
    for (int k = threadIdx.x; k < kStamps; k += T) stamps[(size_t)b * kStamps + k] = st[k];
}

template <bool kProbe>
int sweep_launch(const void* pts, const void* mask, const void* cids, const void* colors, int B,
                 int N, float r2, void* sel_out, void* stamps, void* stream) {
  if (N > kPoissonMaxN || N <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const int threads = N < kMaxThreads ? ((N + 31) / 32) * 32 : kMaxThreads;
  const size_t smem =
      kProbe ? stamp_offset(N, threads) + 8 * kStamps : smem_bytes(N, threads);
  cudaError_t err = cudaFuncSetAttribute(
      poisson_sweep_kernel<kProbe>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  poisson_sweep_kernel<kProbe><<<B, threads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(pts), static_cast<const uint8_t*>(mask),
      static_cast<const int*>(cids), static_cast<const int*>(colors), N, r2,
      static_cast<uint8_t*>(sel_out), static_cast<long long*>(stamps));
  MCCNN_LAUNCH_RETURN();
}

}  // namespace

extern "C" int poisson_sweep_launch(const void* pts, const void* mask,
                                    const void* cids, const void* colors, int B,
                                    int N, float r2, void* sel_out, void* stream) {
  return sweep_launch<false>(pts, mask, cids, colors, B, N, r2, sel_out, nullptr, stream);
}

// K3's probe build: the same sweep, with kStamps clock64 stamps a block.
extern "C" int poisson_sweep_probe_launch(const void* pts, const void* mask,
                                          const void* cids, const void* colors, int B,
                                          int N, float r2, void* sel_out, void* stamps,
                                          void* stream) {
  return sweep_launch<true>(pts, mask, cids, colors, B, N, r2, sel_out, stamps, stream);
}
