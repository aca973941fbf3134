// K3v2: the 27-colour Poisson-disk sweep as two binary matrix-vector
// products a colour step, one cloud per block.
//
// Replaces mccnn_tpu/ops/pallas/poisson_kernel.py::_sweep_kernel_v2 (selected
// by MCCNN_POISSON_SWEEP=v2). The TPU variant builds the adjacency and the
// same-cell-predecessor planes once per cloud and runs each colour step as
// two MXU matvecs on 0/1 vectors: blocked = pred^T unc, new_cov = adj cand.
// Here both planes are bit matrices, built once per cloud:
//   * adj[j] bit i: d2(j, i) <= r2 and i valid (N x ceil(N/32) words, in
//     shared memory: 128 KB at N = 1024);
//   * pred[j] bit i: i is a valid point of j's cell with i < j (the same
//     size, in device memory, where it stays in L2).
// The state vectors (uncovered, candidates) are bit vectors in shared memory,
// formed by warp ballots; a colour step is then, for the thread of point j,
// popcount(pred[j] AND unc) (blocked when > 0) and popcount(adj[j] AND cand)
// (newly covered when > 0): a binary matvec over 32-bit words. Words are
// stored word-major (word w of row j at w * N + j), so a warp reads 32
// consecutive rows of one word: no bank conflicts, coalesced loads.
//
// d2 is core/grid.py::pair_d2's expression with one rounding per op
// (common.cuh), so the selection is K3's and the plain version's bit for bit.
// Limit: N <= 1024 (one thread a point).

#include "common.cuh"

namespace {

constexpr int kV2MaxN = 1024;

__global__ void poisson_sweep_v2_kernel(const float* __restrict__ pts,
                                        const uint8_t* __restrict__ mask,
                                        const int* __restrict__ cids,
                                        const int* __restrict__ colors, int N, int NW,
                                        float r2, uint32_t* __restrict__ pred_bits,
                                        uint8_t* __restrict__ sel_out) {
  extern __shared__ uint32_t smem_v2[];
  uint32_t* adj = smem_v2;  // NW * N words, word-major
  float* sx = reinterpret_cast<float*>(adj + (size_t)NW * N);
  float* sy = sx + N;
  float* sz = sy + N;
  float* ssq = sz + N;
  int* scid = reinterpret_cast<int*>(ssq + N);  // -1 for invalid points
  uint32_t* unc = reinterpret_cast<uint32_t*>(scid + N);  // NW words
  uint32_t* cand = unc + NW;                              // NW words

  const int b = blockIdx.x;
  const int j = threadIdx.x;  // blockDim.x == 32 * NW >= N
  const int lane = j & 31, word = j >> 5;
  const bool live = j < N;
  bool valid = false;
  int color = -1;
  if (live) {
    const float* P = pts + ((size_t)b * N + j) * 3;
    const float x = P[0], y = P[1], z = P[2];
    sx[j] = x;
    sy[j] = y;
    sz[j] = z;
    ssq[j] = sq_norm_rn(x, y, z);
    valid = mask[(size_t)b * N + j] != 0;
    scid[j] = valid ? cids[(size_t)b * N + j] : -1;
    color = colors[(size_t)b * N + j];
  }
  __syncthreads();

  // The two planes, row j by the thread of point j.
  uint32_t* pred = pred_bits + (size_t)b * NW * N;
  if (live) {
    const float x = sx[j], y = sy[j], z = sz[j], sq = ssq[j];
    const int cid = scid[j];
    for (int w = 0; w < NW; ++w) {
      uint32_t a = 0u, p = 0u;
      const int i0 = w * 32;
      const int iend = min(32, N - i0);
      for (int k = 0; k < iend; ++k) {
        const int i = i0 + k;
        const int ci = scid[i];
        if (ci < 0) continue;
        if (pair_d2_rn(x, y, z, sq, sx[i], sy[i], sz[i], ssq[i]) <= r2) a |= 1u << k;
        if (i < j && ci == cid) p |= 1u << k;
      }
      adj[(size_t)w * N + j] = a;
      pred[(size_t)w * N + j] = p;
    }
  }
  __syncthreads();  // pred's global writes are visible to the block after this

  bool covered = false, selected = false;
  for (int c = 0; c < 27; ++c) {
    // unc = valid & ~covered, one word a warp
    const uint32_t ub = __ballot_sync(0xffffffffu, valid && !covered);
    if (lane == 0) unc[word] = ub;
    __syncthreads();
    // blocked = pred^T unc: the thread of a colour-c uncovered point counts
    // its uncovered same-cell predecessors
    bool is_cand = false;
    if (valid && !covered && color == c) {
      int n = 0;
      for (int w = 0; w < NW; ++w) n += __popc(pred[(size_t)w * N + j] & unc[w]);
      is_cand = n == 0;
    }
    selected |= is_cand;
    const uint32_t cb = __ballot_sync(0xffffffffu, is_cand);
    if (lane == 0) cand[word] = cb;
    __syncthreads();
    // new_cov = adj cand
    if (live && !covered) {
      int n = 0;
      for (int w = 0; w < NW; ++w) n += __popc(adj[(size_t)w * N + j] & cand[w]);
      covered = n > 0;
    }
    // the next step's first write (unc) comes after every read of cand and
    // unc of this step: each warp passes the barrier below before writing
    __syncthreads();
  }
  if (live) sel_out[(size_t)b * N + j] = (selected && valid) ? 1 : 0;
}

}  // namespace

extern "C" int poisson_sweep_v2_launch(const void* pts, const void* mask, const void* cids,
                                       const void* colors, int B, int N, float r2,
                                       void* pred_bits, void* sel_out, void* stream) {
  if (N > kV2MaxN || N <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const int NW = (N + 31) / 32;
  const size_t smem = sizeof(uint32_t) * ((size_t)NW * N + 2 * NW) + (size_t)N * (4 * 4 + 4);
  cudaError_t err = cudaFuncSetAttribute(
      poisson_sweep_v2_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  poisson_sweep_v2_kernel<<<B, 32 * NW, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(pts), static_cast<const uint8_t*>(mask),
      static_cast<const int*>(cids), static_cast<const int*>(colors), N, NW, r2,
      static_cast<uint32_t*>(pred_bits), static_cast<uint8_t*>(sel_out));
  MCCNN_LAUNCH_RETURN();
}
