// K1v1: the dense Monte-Carlo convolution, forward, in one launch.
//
// Replaces mccnn_tpu/ops/pallas/dense_conv.py::_fwd_kernel (with its h-loop
// _hloop), the per-h variant that MCCNN_DENSE_V1=1 selects (reached through
// _fwd_call, dense_conv.py:578-604). It computes K1's function
// (dense_conv.cu): for every sample i and every valid source j with
// d2(i, j) <= r2,
//
//   out[i] = s_i * sum_j [ sum_h a_h(i,j) (f~_j . W2[h]) + f~_j . b2 ],
//   a_h(i,j) = relu(((p_j - x_i) / r) . W1[:, h] + b1[h]),
//
// with s_i = 1/count in mean mode (1 otherwise) and 0 for a masked sample.
// The TPU kernel loops over h inside a grid step that holds every source:
// acc += (a_h^T f~) w2_h, elementwise (depthwise) or as a small matmul with
// w2[h] (full). Here a block takes (cloud, tile of TS samples, slice of OW
// output channels), walks all N sources through shared memory in tiles of 32,
// forms each a_h with K1's expressions (pair_d2_rn, mc_offset, mc_preact: the
// same plane as K1 / K2) and accumulates g_h = a_h^T f~ for its tile in
// registers, up to four (sample, channel) rows of H+1 sums a thread. Then it
// folds them into the output without writing G to device memory: depthwise,
// each thread scales its own rows by w2[:, c] and b2[c]; full, the block
// stages its G tile (TS, H+1, C) in shared memory and each thread forms
// out[s, o] = sum_{h,c} G[s, h, c] Wcat[h*C + c, o] for eight samples at a
// time, Wcat = [W2 as (H*C, CO); b2 as (C, CO)] read in place.
//
// What bounds it on the H100: the pair plane's arithmetic and shared-memory
// reads (per pair 8 pre-activations and (H+1) FMAs a channel), and for a
// wide full conv the Wcat reads of the fold (each block reads its OW columns
// of Wcat once per eight samples, from L2). A block with a CO slice redoes
// the tile's pairs: OW is at most 256, so the global 256 -> 1024 site forms
// its (few) pairs four times. fp32 throughout, sums in a fixed order, no
// atomics: two calls give bit-identical outputs.
//
// Limits: H == 8 and C <= 1024 (TS * C <= 1024 rows a block), as K1.

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kTJ = 32;  // sources per shared-memory tile
constexpr int kPerThread = 4;
constexpr int kMaxPairs = kThreads * kPerThread;
constexpr int kFold = 8;  // samples a thread folds at once (full conv)

template <int H>
__global__ void mcconv_v1_fwd_kernel(const float* __restrict__ smp,
                                     const uint8_t* __restrict__ smask,
                                     const float* __restrict__ src,
                                     const uint8_t* __restrict__ srcmask,
                                     const float* __restrict__ wf,
                                     const float* __restrict__ w1,
                                     const float* __restrict__ b1,
                                     const float* __restrict__ w2,
                                     const float* __restrict__ b2, int M, int N, int C,
                                     int CO, int TS, int OW, int mean, float r2,
                                     float radius, float* __restrict__ out,
                                     float* __restrict__ cnt) {
  constexpr int H1 = H + 1;
  const bool full = CO > 0;
  extern __shared__ float sm[];
  float* plane = sm;                       // [kTJ][H1][TS]
  float* sfeat = plane + kTJ * H1 * TS;    // [kTJ][C]
  float* spos = sfeat + kTJ * C;           // [kTJ][4]: x, y, z, |p|^2
  float* qpos = spos + kTJ * 4;            // [TS][4]
  float* sscale = qpos + TS * 4;           // [TS]: the output factor s_i
  float* sw1 = sscale + TS;                // [3][H]
  float* sb1 = sw1 + 3 * H;                // [H]
  float* sg = sb1 + H;                     // [TS][H1][C] (full only)
  uint8_t* svalid = reinterpret_cast<uint8_t*>(sg + (full ? TS * H1 * C : 0));  // [kTJ]
  uint8_t* qvalid = svalid + kTJ;                                                // [TS]

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

  float acc[kPerThread][H1];
  float count[kPerThread];
#pragma unroll
  for (int k = 0; k < kPerThread; ++k) {
    count[k] = 0.f;
#pragma unroll
    for (int h = 0; h < H1; ++h) acc[k][h] = 0.f;
  }
  const int npairs = TS * C;

  for (int j0 = 0; j0 < N; j0 += kTJ) {
    const int nj = min(kTJ, N - j0);
    __syncthreads();  // previous tile consumed (and the prologue stored)
    for (int t = threadIdx.x; t < nj; t += blockDim.x) {
      float x = S[3 * (j0 + t)], y = S[3 * (j0 + t) + 1], z = S[3 * (j0 + t) + 2];
      spos[4 * t] = x;
      spos[4 * t + 1] = y;
      spos[4 * t + 2] = z;
      spos[4 * t + 3] = sq_norm_rn(x, y, z);
      svalid[t] = srcmask[(size_t)b * N + j0 + t];
    }
    for (int t = threadIdx.x; t < nj * C; t += blockDim.x) sfeat[t] = F[(size_t)j0 * C + t];
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
    for (int k = 0; k < kPerThread; ++k) {
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

  // The count and the output factor of each sample; one writer of cnt.
#pragma unroll
  for (int k = 0; k < kPerThread; ++k) {
    const int q = threadIdx.x + k * blockDim.x;
    if (q < npairs && q % C == 0) {
      const int s = q / C;
      const float sc = mean ? __fdiv_rn(1.f, fmaxf(count[k], 1.f)) : 1.f;
      sscale[s] = qvalid[s] ? sc : 0.f;
      if (s < ms && blockIdx.z == 0) cnt[(size_t)b * M + i0 + s] = count[k];
    }
  }
  if (!full) {
    __syncthreads();
#pragma unroll
    for (int k = 0; k < kPerThread; ++k) {
      const int q = threadIdx.x + k * blockDim.x;
      if (q < npairs) {
        const int s = q / C, c = q % C;
        if (s < ms) {
          float o = 0.f;
#pragma unroll
          for (int h = 0; h < H; ++h) o += acc[k][h] * w2[h * C + c];
          o += acc[k][H] * b2[c];
          out[((size_t)b * M + i0 + s) * C + c] = o * sscale[s];
        }
      }
    }
    return;
  }

  // Full conv: stage the tile's G, then fold it with this block's Wcat columns.
#pragma unroll
  for (int k = 0; k < kPerThread; ++k) {
    const int q = threadIdx.x + k * blockDim.x;
    if (q < npairs) {
      const int s = q / C, c = q % C;
#pragma unroll
      for (int h = 0; h < H1; ++h) sg[((size_t)s * H1 + h) * C + c] = acc[k][h];
    }
  }
  __syncthreads();
  const int K = H1 * C, KW = H * C;
  const int oo = threadIdx.x % OW, group = threadIdx.x / OW, groups = blockDim.x / OW;
  const int o = blockIdx.z * OW + oo;
  if (o >= CO) return;
  for (int s0 = group * kFold; s0 < ms; s0 += groups * kFold) {
    float a[kFold];
#pragma unroll
    for (int u = 0; u < kFold; ++u) a[u] = 0.f;
    const int ns = min(kFold, ms - s0);
    for (int kk = 0; kk < K; ++kk) {
      const float w = kk < KW ? w2[(size_t)kk * CO + o] : b2[(size_t)(kk - KW) * CO + o];
#pragma unroll
      for (int u = 0; u < kFold; ++u)
        if (u < ns) a[u] += sg[(size_t)(s0 + u) * K + kk] * w;
    }
#pragma unroll
    for (int u = 0; u < kFold; ++u)
      if (u < ns) out[((size_t)b * M + i0 + s0 + u) * CO + o] = a[u] * sscale[s0 + u];
  }
}

}  // namespace

// out (B, M, CO | C) and cnt (B, M); CO == 0 selects the depthwise conv.
extern "C" int mcconv_v1_fwd_launch(const void* smp, const void* smask, const void* src,
                                    const void* srcmask, const void* wf, const void* w1,
                                    const void* b1, const void* w2, const void* b2, int B,
                                    int M, int N, int C, int CO, int H, int mean, float r2,
                                    float radius, void* out, void* cnt, void* stream) {
  if (H != 8 || C < 1 || C > kMaxPairs || M < 1 || N < 1 || B < 1 || CO < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  int TS = kMaxPairs / C;
  if (TS > 64) TS = 64;
  if (TS > M) TS = M;
  int OW = 32;  // output columns a block folds: a power of two that divides kThreads
  while (OW < CO && OW < kThreads) OW *= 2;
  const int slices = CO > 0 ? (CO + OW - 1) / OW : 1;
  const size_t smem =
      sizeof(float) * ((size_t)kTJ * (H + 1) * TS + (size_t)kTJ * C + kTJ * 4 + TS * 5 +
                       3 * H + H + (CO > 0 ? (size_t)TS * (H + 1) * C : 0)) +
      kTJ + TS;
  cudaError_t err = cudaFuncSetAttribute(
      mcconv_v1_fwd_kernel<8>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid((M + TS - 1) / TS, B, slices);
  mcconv_v1_fwd_kernel<8><<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(smp), static_cast<const uint8_t*>(smask),
      static_cast<const float*>(src), static_cast<const uint8_t*>(srcmask),
      static_cast<const float*>(wf), static_cast<const float*>(w1),
      static_cast<const float*>(b1), static_cast<const float*>(w2),
      static_cast<const float*>(b2), M, N, C, CO, TS, OW, mean, r2, radius,
      static_cast<float*>(out), static_cast<float*>(cnt));
  MCCNN_LAUNCH_RETURN();
}
