// K1: the dense Monte-Carlo convolution, forward.
//
// Replaces mccnn_tpu/ops/pallas/dense_conv.py::_fwd_kernel_b (reached through
// _fwd_call_b and dense_mc_conv). For every sample i and every valid source j
// with d2(i, j) <= r2:
//
//   out[i] = sum_j [ sum_h relu(((p_j - x_i) / r) . W1[:, h] + b1[h]) * (f~_j . W2[h])
//                    + f~_j . b2 ],        f~ = features / pdf, masked to 0.
//
// The TPU kernel folds W2 into the features first (one wide MXU product over
// (H+1) * N rows). This port contracts over the neighbours first — the
// bilinear factorisation of mccnn_tpu/core/mcconv.py:98-126 — in two kernels:
//
//   1. pair kernel:        G[b,i,h,c] = sum_j a_h(i,j) * f~[b,j,c]   (h < H: relu
//                          planes, h = H: the in-radius mask), plus the count;
//   2. projection kernel:  out = sum_{h<H,c} G W2[h,c,o] + sum_c G[..,H,c] b2[c,o]
//                          (full), or the per-channel form (depthwise), times
//                          1/count in mean mode, and 0 for masked samples.
//
// The pair kernel, shared with K1p, is csrc/dense_conv_pair.cuh: it tests
// every pair's d2 and forms planes and FMAs only for the in-radius pairs of
// valid points, over warp-ballot lists (dense_pairs.cuh); its header says
// what bounds it on the H100 and what its design does about that.
//
// Everything is fp32, no atomics: two calls are bit-identical. The projection
// is a 64x64x16 shared-memory tiled GEMM, 4x4 outputs per thread, its k
// range split over blocks (partials summed in split order) where the output
// tiles alone would not fill the card (a few hundred rows: conv_1_2, the
// global site).
//
// Limits: H == 8 (KERNEL_HIDDEN; the accumulators are unrolled) and C <= 1024
// (256 threads of 4 channels).

#include "dense_conv_pair.cuh"

namespace {

// out[r, o] = scale[r] * sum_k A[r, k] * W[k, o], with W = [w2 (H*C rows); b2 (C rows)].
// Where the output tiles alone would not fill the card (a few rows: the deep
// and global sites), the k range is split over gridDim.z: block z sums k in
// [z * kchunk, (z + 1) * kchunk) into part[z] and mcconv_project_reduce_kernel
// adds the partials in z order and scales. One split writes out directly.
constexpr int kBM = 64, kBN = 64, kBK = 16;

__global__ void mcconv_project_full_kernel(const float* __restrict__ A,
                                           const float* __restrict__ w2,
                                           const float* __restrict__ b2,
                                           const float* __restrict__ scale, int R,
                                           int K, int KW, int CO, int kchunk,
                                           float* __restrict__ out, float* __restrict__ part) {
  __shared__ float As[kBK][kBM + 4];
  __shared__ float Ws[kBK][kBN];
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const int r0 = blockIdx.y * kBM, o0 = blockIdx.x * kBN;
  const int kb = blockIdx.z * kchunk, ke = min(K, kb + kchunk);
  float acc[4][4] = {};
  for (int k0 = kb; k0 < ke; k0 += kBK) {
    for (int t = threadIdx.x; t < kBM * kBK; t += blockDim.x) {
      const int rr = t / kBK, kk = t % kBK;
      const int r = r0 + rr, k = k0 + kk;
      As[kk][rr] = (r < R && k < ke) ? A[(size_t)r * K + k] : 0.f;
    }
    for (int t = threadIdx.x; t < kBK * kBN; t += blockDim.x) {
      const int kk = t / kBN, oo = t % kBN;
      const int k = k0 + kk, o = o0 + oo;
      float w = 0.f;
      if (k < ke && o < CO)
        w = k < KW ? w2[(size_t)k * CO + o] : b2[(size_t)(k - KW) * CO + o];
      Ws[kk][oo] = w;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kBK; ++kk) {
      float a[4], w[4];
#pragma unroll
      for (int u = 0; u < 4; ++u) a[u] = As[kk][ty + 16 * u];
#pragma unroll
      for (int v = 0; v < 4; ++v) w[v] = Ws[kk][tx + 16 * v];
#pragma unroll
      for (int u = 0; u < 4; ++u)
#pragma unroll
        for (int v = 0; v < 4; ++v) acc[u][v] += a[u] * w[v];
    }
    __syncthreads();
  }
  float* dst = gridDim.z == 1 ? out : part + (size_t)blockIdx.z * R * CO;
#pragma unroll
  for (int u = 0; u < 4; ++u) {
    const int r = r0 + ty + 16 * u;
    if (r >= R) continue;
    const float sc = gridDim.z == 1 ? scale[r] : 1.f;
#pragma unroll
    for (int v = 0; v < 4; ++v) {
      const int o = o0 + tx + 16 * v;
      if (o < CO) dst[(size_t)r * CO + o] = gridDim.z == 1 ? acc[u][v] * sc : acc[u][v];
    }
  }
}

// out[r, o] = scale[r] * sum_{z < Z} part[z, r, o], summed in z order.
__global__ void mcconv_project_reduce_kernel(const float* __restrict__ part, int Z, int R,
                                             int CO, const float* __restrict__ scale,
                                             float* __restrict__ out) {
  const size_t l = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  const size_t L = (size_t)R * CO;
  if (l >= L) return;
  float acc = 0.f;
  for (int z = 0; z < Z; ++z) acc += part[(size_t)z * L + l];
  out[l] = acc * scale[l / CO];
}

// out[r, c] = scale[r] * (sum_{h<H} G[r,h,c] w2[h,c] + G[r,H,c] b2[c]).
__global__ void mcconv_project_depthwise_kernel(const float* __restrict__ G,
                                                const float* __restrict__ w2,
                                                const float* __restrict__ b2,
                                                const float* __restrict__ scale,
                                                int R, int H, int C,
                                                float* __restrict__ out) {
  const size_t t = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= (size_t)R * C) return;
  const int r = t / C, c = t % C;
  const float* g = G + (size_t)r * (H + 1) * C + c;
  float acc = 0.f;
  for (int h = 0; h < H; ++h) acc += g[(size_t)h * C] * w2[h * C + c];
  acc += g[(size_t)H * C] * b2[c];
  out[t] = acc * scale[r];
}

}  // namespace

extern "C" int mcconv_pair_launch(const void* smp, const void* smask, const void* src,
                                  const void* srcmask, const void* wf, const void* w1,
                                  const void* b1, int B, int M, int N, int C, int H,
                                  float r2, float radius, void* G, void* cnt,
                                  void* stream) {
  if (H != kHidden || C < 1 || C > kMaxC || M < 1 || N < 1 || B < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  return launch_pair_kernel<false>(smp, smask, src, srcmask, wf, w1, b1, nullptr, B, M, N, C, r2,
                                   radius, G, cnt, static_cast<cudaStream_t>(stream));
}

// Splits of the projection's k range for an R x CO output over K (the caller
// sizes the partials as splits * R * CO floats where splits > 1).
extern "C" int mcconv_project_splits(int R, int K, int CO) {
  int kchunk;
  return split_k(div_up(CO, kBN) * div_up(R, kBM), K, &kchunk);
}

extern "C" int mcconv_project_full_launch(const void* G, const void* w2, const void* b2,
                                          const void* scale, int R, int K, int KW, int CO,
                                          void* part, void* out, void* stream) {
  int kchunk;
  const int splits = split_k(div_up(CO, kBN) * div_up(R, kBM), K, &kchunk);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  dim3 grid(div_up(CO, kBN), div_up(R, kBM), splits);
  mcconv_project_full_kernel<<<grid, 256, 0, st>>>(
      static_cast<const float*>(G), static_cast<const float*>(w2),
      static_cast<const float*>(b2), static_cast<const float*>(scale), R, K, KW, CO, kchunk,
      static_cast<float*>(out), static_cast<float*>(part));
  if (splits > 1) {
    const size_t L = (size_t)R * CO;
    mcconv_project_reduce_kernel<<<(unsigned)((L + 255) / 256), 256, 0, st>>>(
        static_cast<const float*>(part), splits, R, CO, static_cast<const float*>(scale),
        static_cast<float*>(out));
  }
  MCCNN_LAUNCH_RETURN();
}

extern "C" int mcconv_project_depthwise_launch(const void* G, const void* w2,
                                               const void* b2, const void* scale, int R,
                                               int H, int C, void* out, void* stream) {
  const size_t total = (size_t)R * C;
  const int threads = 256;
  const unsigned blocks = (unsigned)((total + threads - 1) / threads);
  mcconv_project_depthwise_kernel<<<blocks, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(G), static_cast<const float*>(w2),
      static_cast<const float*>(b2), static_cast<const float*>(scale), R, H, C,
      static_cast<float*>(out));
  MCCNN_LAUNCH_RETURN();
}
