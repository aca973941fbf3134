// K4: dense Gaussian KDE of each point within its own point set.
//
// Replaces mccnn_tpu/ops/pallas/density_kernel.py::_kde_kernel (reached
// through kde_density_pallas from core/pdf.py::kde_density).
//
//   density[b, i] = norm * sum_{valid j, d2(i,j) <= r2} exp(-0.5 * d2 / h^2)
//   norm = 1 / (h^3 (2 pi)^1.5),   masked queries get 1.0.
//
// What bounds it on the H100: the pairs. Every query visits all N sources, so
// the work is B*N^2 distance + exp evaluations (8.4 M pairs at B=8, N=1024);
// the bytes (positions in, one float out) are negligible. The simple design:
// one thread per query, source positions (and |p|^2) staged through shared
// memory in tiles of the block size, so each source is read from device
// memory once per block instead of once per thread. The sum runs in source
// order in fp32 — deterministic. No limit on N beyond int indexing; the
// dispatch in core/pdf.py keeps N within the reference's dense-path bound.

#include "common.cuh"

namespace {

constexpr int kKdeBlock = 256;

__global__ void kde_density_kernel(const float* __restrict__ pts,
                                   const uint8_t* __restrict__ mask, int N,
                                   float r2, float neg_half_inv_h2, float norm,
                                   float* __restrict__ out) {
  __shared__ float sx[kKdeBlock], sy[kKdeBlock], sz[kKdeBlock], ssq[kKdeBlock];
  __shared__ uint8_t sv[kKdeBlock];

  const int b = blockIdx.y;
  const int i = blockIdx.x * kKdeBlock + threadIdx.x;
  const float* P = pts + (size_t)b * N * 3;
  const uint8_t* V = mask + (size_t)b * N;

  float qx = 0.f, qy = 0.f, qz = 0.f, qsq = 0.f;
  if (i < N) {
    qx = P[3 * i];
    qy = P[3 * i + 1];
    qz = P[3 * i + 2];
    qsq = sq_norm_rn(qx, qy, qz);
  }
  float acc = 0.f;
  for (int j0 = 0; j0 < N; j0 += kKdeBlock) {
    const int j = j0 + threadIdx.x;
    if (j < N) {
      float x = P[3 * j], y = P[3 * j + 1], z = P[3 * j + 2];
      sx[threadIdx.x] = x;
      sy[threadIdx.x] = y;
      sz[threadIdx.x] = z;
      ssq[threadIdx.x] = sq_norm_rn(x, y, z);
      sv[threadIdx.x] = V[j];
    }
    __syncthreads();
    const int nj = min(kKdeBlock, N - j0);
    for (int t = 0; t < nj; ++t) {
      float d2 = pair_d2_rn(qx, qy, qz, qsq, sx[t], sy[t], sz[t], ssq[t]);
      d2 = fmaxf(d2, 0.f);
      if (sv[t] && d2 <= r2) acc += expf(d2 * neg_half_inv_h2);
    }
    __syncthreads();
  }
  if (i < N) out[(size_t)b * N + i] = V[i] ? norm * acc : 1.0f;
}

}  // namespace

extern "C" int kde_density_launch(const void* pts, const void* mask, int B, int N,
                                  float r2, float neg_half_inv_h2, float norm,
                                  void* out, void* stream) {
  dim3 grid((N + kKdeBlock - 1) / kKdeBlock, B);
  kde_density_kernel<<<grid, kKdeBlock, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(pts), static_cast<const uint8_t*>(mask), N, r2,
      neg_half_inv_h2, norm, static_cast<float*>(out));
  MCCNN_LAUNCH_RETURN();
}
