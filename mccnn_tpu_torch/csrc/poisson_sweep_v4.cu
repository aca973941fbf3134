// K3v4: the 27-colour Poisson-disk sweep with SB clouds folded into one
// block; each colour step is one barrier-separated phase for all SB clouds.
//
// Replaces mccnn_tpu/ops/pallas/poisson_kernel.py::_sweep_kernel_v4 (selected
// by MCCNN_POISSON_SWEEP=v4 or v4<SB>; _call_v4 runs B / SB grid steps of SB
// clouds each). Here a block holds SB clouds of N points as one folded set of
// SB * N points in shared memory (32 bytes a point: SB * N <= 4096 is 128
// KB), and every phase of a colour step strides its threads over all of
// them, so SB clouds share one chain of 27 x 3 barriers instead of SB:
//   * once, each valid point links to the previous valid point of its cell in
//     its own cloud;
//   * candidates: a colour-c uncovered point whose chain holds no uncovered
//     point is selected and appended to its cloud's candidate list;
//   * coverage: an uncovered point tests d2 against its cloud's list only.
// B / SB blocks; B % SB == 0 (the wrapper and the reference route any other
// batch to the default sweep).
//
// d2 is core/grid.py::pair_d2's expression with one rounding per op
// (common.cuh), so the selection is K3's and the plain version's bit for bit.
// Limit: N <= 1024, SB <= 4.

#include "common.cuh"

namespace {

constexpr int kV4MaxN = 1024;
constexpr int kV4MaxSB = 4;

__global__ void poisson_sweep_v4_kernel(const float* __restrict__ pts,
                                        const uint8_t* __restrict__ mask,
                                        const int* __restrict__ cids,
                                        const int* __restrict__ colors, int N, int SB,
                                        float r2, uint8_t* __restrict__ sel_out) {
  extern __shared__ unsigned char smem_v4[];
  const int T = SB * N;  // folded points of the block
  float* sx = reinterpret_cast<float*>(smem_v4);
  float* sy = sx + T;
  float* sz = sy + T;
  float* ssq = sz + T;
  int* scid = reinterpret_cast<int*>(ssq + T);
  int* prev = scid + T;   // previous valid point of the same cell and cloud, or -1
  int* clist = prev + T;  // candidates of this step: cloud g's at g * N + k
  uint8_t* scol = reinterpret_cast<uint8_t*>(clist + T);
  uint8_t* valid = scol + T;
  uint8_t* covered = valid + T;
  uint8_t* selected = covered + T;
  __shared__ int ncand[kV4MaxSB];

  // The block's SB clouds are consecutive: folded point f is global point
  // blockIdx.x * T + f, of cloud f / N.
  const size_t base = (size_t)blockIdx.x * T;
  for (int f = threadIdx.x; f < T; f += blockDim.x) {
    const float* P = pts + (base + f) * 3;
    const float x = P[0], y = P[1], z = P[2];
    sx[f] = x;
    sy[f] = y;
    sz[f] = z;
    ssq[f] = sq_norm_rn(x, y, z);
    scid[f] = cids[base + f];
    scol[f] = static_cast<uint8_t>(colors[base + f]);
    valid[f] = mask[base + f];
    covered[f] = 0;
    selected[f] = 0;
  }
  __syncthreads();
  for (int f = threadIdx.x; f < T; f += blockDim.x) {
    const int first = (f / N) * N;  // the cloud's first folded point
    int q = f - 1;
    if (valid[f])
      while (q >= first && !(valid[q] && scid[q] == scid[f])) --q;
    prev[f] = q >= first ? q : -1;
  }

  for (int c = 0; c < 27; ++c) {
    __syncthreads();  // the previous step's coverage (and the links) complete
    if (threadIdx.x < SB) ncand[threadIdx.x] = 0;
    __syncthreads();
    // Candidates of colour c in all SB clouds.
    for (int f = threadIdx.x; f < T; f += blockDim.x) {
      if (!valid[f] || covered[f] || scol[f] != c) continue;
      bool blocked = false;
      for (int q = prev[f]; q >= 0; q = prev[q]) {
        if (!covered[q]) {
          blocked = true;
          break;
        }
      }
      if (!blocked) {
        const int g = f / N;
        selected[f] = 1;
        clist[g * N + atomicAdd(&ncand[g], 1)] = f;
      }
    }
    __syncthreads();
    // Coverage in all SB clouds, each against its own cloud's candidates.
    for (int f = threadIdx.x; f < T; f += blockDim.x) {
      if (covered[f]) continue;
      const int g = f / N;
      const int n = ncand[g];
      const int* list = clist + g * N;
      const float px = sx[f], py = sy[f], pz = sz[f], psq = ssq[f];
      for (int k = 0; k < n; ++k) {
        const int q = list[k];
        if (pair_d2_rn(px, py, pz, psq, sx[q], sy[q], sz[q], ssq[q]) <= r2) {
          covered[f] = 1;
          break;
        }
      }
    }
  }
  __syncthreads();
  for (int f = threadIdx.x; f < T; f += blockDim.x)
    sel_out[base + f] = selected[f] & valid[f];
}

}  // namespace

extern "C" int poisson_sweep_v4_launch(const void* pts, const void* mask, const void* cids,
                                       const void* colors, int B, int N, int SB, float r2,
                                       void* sel_out, void* stream) {
  if (N > kV4MaxN || N <= 0 || SB < 1 || SB > kV4MaxSB || B % SB != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const int T = SB * N;
  const size_t smem = (size_t)T * (4 * sizeof(float) + 3 * sizeof(int) + 4);
  cudaError_t err = cudaFuncSetAttribute(
      poisson_sweep_v4_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int threads = T < 1024 ? ((T + 31) / 32) * 32 : 1024;
  poisson_sweep_v4_kernel<<<B / SB, threads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(pts), static_cast<const uint8_t*>(mask),
      static_cast<const int*>(cids), static_cast<const int*>(colors), N, SB, r2,
      static_cast<uint8_t*>(sel_out));
  MCCNN_LAUNCH_RETURN();
}
