// K3: the 27-colour maximal Poisson-disk sweep, one cloud per block.
//
// Replaces mccnn_tpu/ops/pallas/poisson_kernel.py::_sweep_kernel (the default
// v1, reached through poisson_sweep_pallas from core/sampling.py::poisson_disk).
// Semantics are those of core/sampling.py::_poisson_dense: for colour
// c = 0..26, a point is a candidate if it is valid, uncovered, of colour c, and
// no valid uncovered point of its cell has a lower index; every candidate is
// selected, and every point within r of a candidate becomes covered.
//
// What bounds it on the H100: latency, not throughput. The 27 colour steps
// depend on each other, so a cloud is one chain of barrier-separated phases on
// one SM, and the work inside a phase is small. The design keeps the whole
// cloud in shared memory (positions, |p|^2, cell ids, colours, flags, a
// same-cell link and a candidate list: 32 bytes a point), one thread per point
// (strided when N > 1024), and cuts each phase to the work it needs:
//   * once, before the sweep, each valid point links to the previous valid
//     point of its cell, so "no uncovered lower-index point in my cell" walks
//     that short chain instead of scanning all lower indices;
//   * the candidates of a colour step are appended to a shared list (the order
//     of the list does not matter: coverage is an OR), so the coverage test of
//     an uncovered point visits only that step's candidates, not all N points.
// B clouds run as B blocks.
//
// Limit: N <= 4096 (128 KB of shared memory), the reference's dense
// sampler bound (core/sampling.py DENSE_SAMPLER_MAX_N). The TPU kernel's
// MAX_N = 1024 was a VMEM bound for its (N, N) planes; this kernel holds no
// N x N plane.

#include "common.cuh"

namespace {

constexpr int kPoissonMaxN = 4096;

__global__ void poisson_sweep_kernel(const float* __restrict__ pts,
                                     const uint8_t* __restrict__ mask,
                                     const int* __restrict__ cids,
                                     const int* __restrict__ colors, int N,
                                     float r2, uint8_t* __restrict__ sel_out) {
  extern __shared__ unsigned char smem[];
  float* sx = reinterpret_cast<float*>(smem);
  float* sy = sx + N;
  float* sz = sy + N;
  float* ssq = sz + N;
  int* scid = reinterpret_cast<int*>(ssq + N);
  int* prev = scid + N;   // previous valid point of the same cell, or -1
  int* clist = prev + N;  // this colour step's candidates
  uint8_t* scol = reinterpret_cast<uint8_t*>(clist + N);
  uint8_t* valid = scol + N;
  uint8_t* covered = valid + N;
  uint8_t* selected = covered + N;
  __shared__ int ncand;

  const int b = blockIdx.x;
  const float* P = pts + (size_t)b * N * 3;
  for (int p = threadIdx.x; p < N; p += blockDim.x) {
    float x = P[3 * p], y = P[3 * p + 1], z = P[3 * p + 2];
    sx[p] = x;
    sy[p] = y;
    sz[p] = z;
    ssq[p] = sq_norm_rn(x, y, z);
    scid[p] = cids[(size_t)b * N + p];
    scol[p] = static_cast<uint8_t>(colors[(size_t)b * N + p]);
    valid[p] = mask[(size_t)b * N + p];
    covered[p] = 0;
    selected[p] = 0;
  }
  __syncthreads();
  for (int p = threadIdx.x; p < N; p += blockDim.x) {
    int q = p - 1;
    if (valid[p])
      while (q >= 0 && !(valid[q] && scid[q] == scid[p])) --q;
    prev[p] = q;
  }

  for (int c = 0; c < 27; ++c) {
    __syncthreads();  // previous step's coverage (and the links) complete
    if (threadIdx.x == 0) ncand = 0;
    __syncthreads();
    // Phase A: candidates of colour c (reads covered, appends to clist).
    for (int p = threadIdx.x; p < N; p += blockDim.x) {
      if (!valid[p] || covered[p] || scol[p] != c) continue;
      bool blocked = false;
      for (int q = prev[p]; q >= 0; q = prev[q]) {
        if (!covered[q]) {
          blocked = true;
          break;
        }
      }
      if (!blocked) {
        selected[p] = 1;
        clist[atomicAdd(&ncand, 1)] = p;
      }
    }
    __syncthreads();
    // Phase B: coverage (reads clist, writes only the thread's own covered[p]).
    const int n = ncand;
    for (int p = threadIdx.x; p < N; p += blockDim.x) {
      if (covered[p]) continue;
      const float px = sx[p], py = sy[p], pz = sz[p], psq = ssq[p];
      for (int k = 0; k < n; ++k) {
        const int q = clist[k];
        if (pair_d2_rn(px, py, pz, psq, sx[q], sy[q], sz[q], ssq[q]) <= r2) {
          covered[p] = 1;
          break;
        }
      }
    }
  }
  __syncthreads();
  for (int p = threadIdx.x; p < N; p += blockDim.x)
    sel_out[(size_t)b * N + p] = selected[p] & valid[p];
}

}  // namespace

extern "C" int poisson_sweep_launch(const void* pts, const void* mask,
                                    const void* cids, const void* colors, int B,
                                    int N, float r2, void* sel_out, void* stream) {
  if (N > kPoissonMaxN || N <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = (size_t)N * (4 * sizeof(float) + 3 * sizeof(int) + 4);
  cudaError_t err = cudaFuncSetAttribute(
      poisson_sweep_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  int threads = N < 1024 ? ((N + 31) / 32) * 32 : 1024;
  poisson_sweep_kernel<<<B, threads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(pts), static_cast<const uint8_t*>(mask),
      static_cast<const int*>(cids), static_cast<const int*>(colors), N, r2,
      static_cast<uint8_t*>(sel_out));
  MCCNN_LAUNCH_RETURN();
}
