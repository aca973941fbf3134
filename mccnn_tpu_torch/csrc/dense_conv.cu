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
// At MCClassS's sites this is 5-30x fewer multiply-adds than folding first
// (conv_0_1: 5.1 M vs 586 M MAC per cloud).
//
// What bounds it on the H100: stage 1 is bound by the pair-plane arithmetic
// and shared-memory reads (B*M*N pairs, each 8 pre-activations and then
// (H+1) FMAs per channel); stage 2 is a small fp32 GEMM (at most 320 x 2304 x
// 256 on the slice). The simple design: a block takes TS samples of one cloud
// and walks all sources in tiles of 32. For each tile it stages the source
// positions and f~ rows in shared memory, computes the (32, H+1, TS) plane of
// a_h values once (fp32 — the reference measured a 3x dW1 error from bf16
// planes, dense_conv.py:282-292), and then each thread accumulates up to four
// (sample, channel) outputs of G for all H+1 rows in registers. Everything is
// fp32, sums run in source order: deterministic, no atomics. The GEMM is a
// 64x64x16 shared-memory tiled kernel, 4x4 outputs per thread.
//
// Limits: H == 8 (KERNEL_HIDDEN; the accumulators are unrolled) and C <= 1024
// (TS * C <= 1024 outputs per block, four per thread).

#include "common.cuh"

namespace {

constexpr int kPairThreads = 256;
constexpr int kTJ = 32;          // sources per shared-memory tile
constexpr int kPairsPerThread = 4;
constexpr int kMaxPairs = kPairThreads * kPairsPerThread;

template <int H>
__global__ void mcconv_pair_kernel(const float* __restrict__ smp,
                                   const uint8_t* __restrict__ smask,
                                   const float* __restrict__ src,
                                   const uint8_t* __restrict__ srcmask,
                                   const float* __restrict__ wf,
                                   const float* __restrict__ w1,
                                   const float* __restrict__ b1, int M, int N,
                                   int C, int TS, float r2, float radius,
                                   float* __restrict__ G, float* __restrict__ cnt) {
  constexpr int H1 = H + 1;
  extern __shared__ float sm[];
  float* plane = sm;                       // [kTJ][H1][TS]
  float* sfeat = plane + kTJ * H1 * TS;    // [kTJ][C]
  float* spos = sfeat + kTJ * C;           // [kTJ][4]: x, y, z, |p|^2
  float* qpos = spos + kTJ * 4;            // [TS][4]
  float* sw1 = qpos + TS * 4;              // [3][H]
  float* sb1 = sw1 + 3 * H;                // [H]
  uint8_t* svalid = reinterpret_cast<uint8_t*>(sb1 + H);  // [kTJ]
  uint8_t* qvalid = svalid + kTJ;                          // [TS]

  const int b = blockIdx.y;
  const int i0 = blockIdx.x * TS;
  const int ms = min(TS, M - i0);
  const float* S = src + (size_t)b * N * 3;
  const float* F = wf + (size_t)b * N * C;

  for (int t = threadIdx.x; t < TS; t += blockDim.x) {
    float x = 0.f, y = 0.f, z = 0.f;
    uint8_t v = 0;
    if (t < ms) {
      const float* q = smp + ((size_t)b * M + i0 + t) * 3;
      x = q[0];
      y = q[1];
      z = q[2];
      v = smask[(size_t)b * M + i0 + t];
    }
    qpos[4 * t] = x;
    qpos[4 * t + 1] = y;
    qpos[4 * t + 2] = z;
    qpos[4 * t + 3] = sq_norm_rn(x, y, z);
    qvalid[t] = v;
  }
  for (int t = threadIdx.x; t < 3 * H; t += blockDim.x) sw1[t] = w1[t];
  for (int t = threadIdx.x; t < H; t += blockDim.x) sb1[t] = b1[t];

  // This thread's (sample, channel) outputs: q = tid + k * blockDim.
  float acc[kPairsPerThread][H1];
  float count[kPairsPerThread];
#pragma unroll
  for (int k = 0; k < kPairsPerThread; ++k) {
    count[k] = 0.f;
#pragma unroll
    for (int h = 0; h < H1; ++h) acc[k][h] = 0.f;
  }
  const int npairs = TS * C;

  for (int j0 = 0; j0 < N; j0 += kTJ) {
    const int nj = min(kTJ, N - j0);
    __syncthreads();  // previous tile fully consumed (and the prologue stored)
    for (int t = threadIdx.x; t < nj; t += blockDim.x) {
      float x = S[3 * (j0 + t)], y = S[3 * (j0 + t) + 1], z = S[3 * (j0 + t) + 2];
      spos[4 * t] = x;
      spos[4 * t + 1] = y;
      spos[4 * t + 2] = z;
      spos[4 * t + 3] = sq_norm_rn(x, y, z);
      svalid[t] = srcmask[(size_t)b * N + j0 + t];
    }
    for (int t = threadIdx.x; t < nj * C; t += blockDim.x)
      sfeat[t] = F[(size_t)j0 * C + t];
    __syncthreads();
    for (int t = threadIdx.x; t < nj * TS; t += blockDim.x) {
      const int j = t / TS, s = t % TS;
      const float px = spos[4 * j], py = spos[4 * j + 1], pz = spos[4 * j + 2];
      const float qx = qpos[4 * s], qy = qpos[4 * s + 1], qz = qpos[4 * s + 2];
      const float d2 = pair_d2_rn(qx, qy, qz, qpos[4 * s + 3], px, py, pz, spos[4 * j + 3]);
      const bool in = qvalid[s] && svalid[j] && d2 <= r2;
      const float ox = mc_offset(px, qx, radius), oy = mc_offset(py, qy, radius),
                  oz = mc_offset(pz, qz, radius);
      float* pl = plane + (size_t)j * H1 * TS + s;
#pragma unroll
      for (int h = 0; h < H; ++h) {
        const float pre = mc_preact(ox, oy, oz, sw1, sb1, H, h);
        pl[h * TS] = in ? fmaxf(pre, 0.f) : 0.f;
      }
      pl[H * TS] = in ? 1.f : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < kPairsPerThread; ++k) {
      const int q = threadIdx.x + k * blockDim.x;
      if (q < npairs) {
        const int s = q / C, c = q % C;
        for (int j = 0; j < nj; ++j) {
          const float f = sfeat[j * C + c];
          const float* pl = plane + (size_t)j * H1 * TS + s;
#pragma unroll
          for (int h = 0; h < H1; ++h) acc[k][h] += pl[h * TS] * f;
        }
        if (c == 0)
          for (int j = 0; j < nj; ++j) count[k] += plane[((size_t)j * H1 + H) * TS + s];
      }
    }
  }
#pragma unroll
  for (int k = 0; k < kPairsPerThread; ++k) {
    const int q = threadIdx.x + k * blockDim.x;
    if (q < npairs) {
      const int s = q / C, c = q % C;
      if (s < ms) {
        float* g = G + ((size_t)b * M + i0 + s) * H1 * C + c;
#pragma unroll
        for (int h = 0; h < H1; ++h) g[(size_t)h * C] = acc[k][h];
        if (c == 0) cnt[(size_t)b * M + i0 + s] = count[k];
      }
    }
  }
}

// out[r, o] = scale[r] * sum_k A[r, k] * W[k, o], with W = [w2 (H*C rows); b2 (C rows)].
constexpr int kBM = 64, kBN = 64, kBK = 16;

__global__ void mcconv_project_full_kernel(const float* __restrict__ A,
                                           const float* __restrict__ w2,
                                           const float* __restrict__ b2,
                                           const float* __restrict__ scale, int R,
                                           int K, int KW, int CO,
                                           float* __restrict__ out) {
  __shared__ float As[kBK][kBM + 4];
  __shared__ float Ws[kBK][kBN];
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const int r0 = blockIdx.y * kBM, o0 = blockIdx.x * kBN;
  float acc[4][4] = {};
  for (int k0 = 0; k0 < K; k0 += kBK) {
    for (int t = threadIdx.x; t < kBM * kBK; t += blockDim.x) {
      const int rr = t / kBK, kk = t % kBK;
      const int r = r0 + rr, k = k0 + kk;
      As[kk][rr] = (r < R && k < K) ? A[(size_t)r * K + k] : 0.f;
    }
    for (int t = threadIdx.x; t < kBK * kBN; t += blockDim.x) {
      const int kk = t / kBN, oo = t % kBN;
      const int k = k0 + kk, o = o0 + oo;
      float w = 0.f;
      if (k < K && o < CO)
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
#pragma unroll
  for (int u = 0; u < 4; ++u) {
    const int r = r0 + ty + 16 * u;
    if (r >= R) continue;
    const float sc = scale[r];
#pragma unroll
    for (int v = 0; v < 4; ++v) {
      const int o = o0 + tx + 16 * v;
      if (o < CO) out[(size_t)r * CO + o] = acc[u][v] * sc;
    }
  }
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
  if (H != 8 || C < 1 || C > kMaxPairs || M < 1 || N < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  int TS = kMaxPairs / C;
  if (TS > 64) TS = 64;
  if (TS > M) TS = M;
  const size_t smem = sizeof(float) * ((size_t)kTJ * (H + 1) * TS + (size_t)kTJ * C +
                                       kTJ * 4 + TS * 4 + 3 * H + H) +
                      kTJ + TS;
  cudaError_t err = cudaFuncSetAttribute(
      mcconv_pair_kernel<8>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid((M + TS - 1) / TS, B);
  mcconv_pair_kernel<8><<<grid, kPairThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(smp), static_cast<const uint8_t*>(smask),
      static_cast<const float*>(src), static_cast<const uint8_t*>(srcmask),
      static_cast<const float*>(wf), static_cast<const float*>(w1),
      static_cast<const float*>(b1), M, N, C, TS, r2, radius, static_cast<float*>(G),
      static_cast<float*>(cnt));
  MCCNN_LAUNCH_RETURN();
}

extern "C" int mcconv_project_full_launch(const void* G, const void* w2, const void* b2,
                                          const void* scale, int R, int K, int KW, int CO,
                                          void* out, void* stream) {
  dim3 grid((CO + kBN - 1) / kBN, (R + kBM - 1) / kBM);
  mcconv_project_full_kernel<<<grid, 256, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(G), static_cast<const float*>(w2),
      static_cast<const float*>(b2), static_cast<const float*>(scale), R, K, KW, CO,
      static_cast<float*>(out));
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
