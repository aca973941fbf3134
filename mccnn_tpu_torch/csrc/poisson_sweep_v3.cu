// K3v3: the 27-colour Poisson-disk sweep over colour-sorted points, each
// colour step confined to one window of W = 256 sorted points; one cloud per
// block.
//
// Replaces mccnn_tpu/ops/pallas/poisson_kernel.py::_sweep_kernel_v3 (selected
// by MCCNN_POISSON_SWEEP=v3, any value but v1 / v2 / v4*). The wrapper
// (ops/cuda/poisson_kernel.py::v3_layout) sorts the points by (colour, cell,
// index) with a stable argsort, as the reference's jnp.argsort, and gives each
// colour a 128-aligned window start; it calls this kernel only when every
// colour run of the batch lies inside its window (the reference's `fits`
// test; otherwise the default sweep, K3, runs). Then inside a colour's window
// a cell is one contiguous run in ascending original index, so:
//   * candidates: W threads test the window's points; a colour-c point is
//     blocked when an earlier point of its run (same cell id, earlier in the
//     window) is uncovered: the window's same-cell-predecessor pass, walked
//     back over the run;
//   * coverage: every point not yet covered tests d2 against the window's
//     candidates (a shared list), formed on the fly: no N x N plane.
// The kernel reads the points through `order` into the sorted domain in
// shared memory and writes each flag back at its original index.
//
// d2 is core/grid.py::pair_d2's expression with one rounding per op
// (common.cuh), so the selection is K3's and the plain version's bit for bit.
// Limit: Np <= 1024 sorted rows (N rounded up to 8).

#include "common.cuh"

namespace {

constexpr int kV3MaxN = 1024;
constexpr int kV3Window = 256;

__global__ void poisson_sweep_v3_kernel(const float* __restrict__ pts,
                                        const uint8_t* __restrict__ mask,
                                        const int* __restrict__ cids,
                                        const int* __restrict__ colors,
                                        const int* __restrict__ order,
                                        const int* __restrict__ starts, int N, int Np,
                                        float r2, uint8_t* __restrict__ sel_out) {
  extern __shared__ unsigned char smem_v3[];
  float* sx = reinterpret_cast<float*>(smem_v3);
  float* sy = sx + Np;
  float* sz = sy + Np;
  float* ssq = sz + Np;
  int* scid = reinterpret_cast<int*>(ssq + Np);  // -1: invalid or padding row
  int* clist = scid + Np;                         // this step's candidates (<= W)
  int* scol = clist + kV3Window;
  uint8_t* covered = reinterpret_cast<uint8_t*>(scol + Np);
  uint8_t* selected = covered + Np;
  __shared__ int ncand;

  const int b = blockIdx.x;
  const int* ord = order + (size_t)b * Np;
  for (int p = threadIdx.x; p < Np; p += blockDim.x) {
    const int o = ord[p];
    float x = 0.f, y = 0.f, z = 0.f;
    int cid = -1, col = -2;
    if (o < N) {
      const float* P = pts + ((size_t)b * N + o) * 3;
      x = P[0];
      y = P[1];
      z = P[2];
      col = colors[(size_t)b * N + o];
      if (mask[(size_t)b * N + o]) cid = cids[(size_t)b * N + o];
    }
    sx[p] = x;
    sy[p] = y;
    sz[p] = z;
    ssq[p] = sq_norm_rn(x, y, z);
    scid[p] = cid;
    scol[p] = col;
    covered[p] = 0;
    selected[p] = 0;
  }

  for (int c = 0; c < 27; ++c) {
    __syncthreads();  // the previous step's coverage (and the loads) complete
    if (threadIdx.x == 0) ncand = 0;
    __syncthreads();
    // Candidates of colour c inside the window [s, s + W).
    const int s = starts[(size_t)b * 27 + c];
    for (int t = threadIdx.x; t < kV3Window; t += blockDim.x) {
      const int p = s + t;
      const int cid = scid[p];
      if (cid < 0 || covered[p] || scol[p] != c) continue;
      bool blocked = false;
      for (int u = t - 1; u >= 0 && scid[s + u] == cid; --u) {
        if (!covered[s + u]) {
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
    // Coverage of every row against the window's candidates (an OR: the
    // order of the list does not matter).
    const int n = ncand;
    if (n == 0) continue;
    for (int p = threadIdx.x; p < Np; p += blockDim.x) {
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
  for (int p = threadIdx.x; p < Np; p += blockDim.x) {
    const int o = ord[p];
    if (o < N) sel_out[(size_t)b * N + o] = (selected[p] && scid[p] >= 0) ? 1 : 0;
  }
}

}  // namespace

extern "C" int poisson_sweep_v3_launch(const void* pts, const void* mask, const void* cids,
                                       const void* colors, const void* order,
                                       const void* starts, int B, int N, int Np, float r2,
                                       void* sel_out, void* stream) {
  if (Np > kV3MaxN || Np <= kV3Window || N > Np || N <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = (size_t)Np * (4 * sizeof(float) + 2 * sizeof(int) + 2) +
                      kV3Window * sizeof(int);
  cudaError_t err = cudaFuncSetAttribute(
      poisson_sweep_v3_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int threads = Np < 1024 ? ((Np + 31) / 32) * 32 : 1024;
  poisson_sweep_v3_kernel<<<B, threads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(pts), static_cast<const uint8_t*>(mask),
      static_cast<const int*>(cids), static_cast<const int*>(colors),
      static_cast<const int*>(order), static_cast<const int*>(starts), N, Np, r2,
      static_cast<uint8_t*>(sel_out));
  MCCNN_LAUNCH_RETURN();
}
