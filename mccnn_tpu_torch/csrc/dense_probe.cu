// T1: the dense conv's timing probes, K1 stripped to its parts.
//
// Replaces the Pallas kernel bodies of tools/exp_dense_breakdown.py, run by
// its `call` (:84-94: one grid step per tile of 256 samples) and `call_big`
// (:186-198: one grid step per cloud): k_mm_only (:96), k_vpu_only (:110),
// k_fwd_replica (:131), k_h1 (:153), k_noop (:182), k_mm_big (:200) and
// k_fwd_bf16 (:234). They time where K1's time goes (loads, the pair planes,
// the contraction) on one cloud set: B clouds of N points that are both the
// samples and the sources, C channels of bf16 features fz, the TPU tool's
// w1 (8 x H: rows 0-2 take xyz, row 3 the samples' |x|^2 of the tool's
// transposed sample tiles), b1, w2 (H x C), b2 (C). Each variant computes
// what its TPU body computes from those inputs (mccnn_tpu_torch/ops/cuda/
// dense_probe.py holds their plain versions):
//   mm_only  (0): the (H+1) contractions of K1 with a fixed plane, a_h(i, j)
//                 = bf16(x_j) for every h; out = sum_h g w2[h % H];
//   vpu_only (1): the H planes a_h = bf16(relu(pre_h) mask) (pre_h =
//                 (cw_h(j) - sw_h(i)) + b1_h), summed in a running bf16
//                 plane, and one contraction of that plane;
//   replica  (2): K1's forward body: H planes bf16(relu(pre_h) mask) and the
//                 mask, contracted and folded by w2 and b2;
//   h1       (3): the first plane alone, contracted and scaled by w2[0];
//   noop     (4): the loads alone; out = w2[0][0];
//   mm_big   (5): mm_only's function as (H+1) bf16 tensor-core GEMMs;
//   fwd_bf16 (6): replica with bf16 arithmetic: cw + b1 and sw rounded to
//                 bf16, pre = bf16(bf16(cw - sw) + bf16(penalty)), a_h =
//                 max(pre, 0), the mask plane in bf16.
// Two schedules. noop, mm_only and mm_big walk mm_big's staged schedule
// (csrc/dense_probe_stage.cuh: 128-sample x 64-channel tiles over the whole
// card, fz resident in shared memory), in csrc/dense_probe_staged.cu and
// csrc/dense_probe_mm_big.cu, which this entry dispatches variants 0, 4 and
// 5 to. The other four, in this file, keep K1's all-pairs schedule before PR 11's
// lists: a block takes TS samples of a cloud and walks the sources in tiles
// of 32, stages positions and fz in shared memory, fills the variant's
// planes ([32][P][TS], fp32 holding the bf16 values where the TPU body
// rounds to bf16; the running plane of vpu_only is __nv_bfloat16), and each
// thread accumulates up to four (sample, channel) outputs over every plane
// in fp32 registers, in source order. No atomics: two calls are
// bit-identical.
//
// What bounds it on the H100: as K1, the contraction's FMAs and shared-memory
// reads on the CUDA cores (2 (H+1) C operations a pair for replica and
// fwd_bf16, 2 C for vpu_only and h1, beside their planes), and each block's
// re-reading of the cloud's fz from L2. Limits: H == 8, C <= 1024.

#include <cuda_bf16.h>

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kTJ = 32;  // sources per shared-memory tile
constexpr int kPairsPerThread = 4;
constexpr int kMaxPairs = kThreads * kPairsPerThread;
enum { kMmOnly = 0, kVpuOnly, kReplica, kH1, kNoop, kMmBig, kFwdBf16, kVariants };

__device__ __forceinline__ float bf16_round(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

template <int V, int H>
__host__ __device__ constexpr int planes_of() {
  return (V == kVpuOnly || V == kH1) ? 1 : H + 1;
}

template <int V, int H>
__global__ void __launch_bounds__(kThreads)
    dense_probe_kernel(const float* __restrict__ pts, const __nv_bfloat16* __restrict__ fz,
                       const float* __restrict__ w1, const float* __restrict__ b1,
                       const float* __restrict__ w2, const float* __restrict__ b2, int N, int C,
                       int TS, float r2, float inv_r, float* __restrict__ out) {
  constexpr int P = planes_of<V, H>();
  extern __shared__ float sm[];
  float* plane = sm;                       // [kTJ][P][TS]
  float* sfeat = plane + kTJ * P * TS;     // [kTJ][C]
  float* spos = sfeat + kTJ * C;           // [kTJ][4]: x, y, z, |p|^2
  float* cw = spos + kTJ * 4;              // [kTJ][H]: (p . w1) / r
  float* qpos = cw + kTJ * H;              // [TS][4]
  float* sw = qpos + TS * 4;               // [TS][H]: (x . w1 + |x|^2 w1[3]) / r
  float* sw1 = sw + TS * H;                // [4][H]: rows 0-3 of w1
  float* sb1 = sw1 + 4 * H;                // [H]

  const int b = blockIdx.y;
  const float* S = pts + (size_t)b * N * 3;
  const __nv_bfloat16* F = fz + (size_t)b * N * C;
  const int n_stiles = (N + TS - 1) / TS;
  const int npairs = TS * C;
  for (int t = threadIdx.x; t < 4 * H; t += blockDim.x) sw1[t] = w1[t];
  for (int t = threadIdx.x; t < H; t += blockDim.x) sb1[t] = b1[t];

  for (int it = blockIdx.x; it < n_stiles; it += gridDim.x) {
    const int i0 = it * TS;
    const int ms = min(TS, N - i0);
    __syncthreads();  // the previous sample tile is done (and w1, b1 are stored)
    for (int t = threadIdx.x; t < TS; t += blockDim.x) {
      float x = 0.f, y = 0.f, z = 0.f;
      if (t < ms) {
        x = S[3 * (i0 + t)];
        y = S[3 * (i0 + t) + 1];
        z = S[3 * (i0 + t) + 2];
      }
      const float sq = sq_norm_rn(x, y, z);
      qpos[4 * t] = x;
      qpos[4 * t + 1] = y;
      qpos[4 * t + 2] = z;
      qpos[4 * t + 3] = sq;
      for (int h = 0; h < H; ++h) {
        const float base = __fadd_rn(__fadd_rn(__fmul_rn(x, sw1[h]), __fmul_rn(y, sw1[H + h])),
                                     __fmul_rn(z, sw1[2 * H + h]));
        sw[t * H + h] = __fmul_rn(__fadd_rn(base, __fmul_rn(sq, sw1[3 * H + h])), inv_r);
      }
    }
    float acc[kPairsPerThread][P];
#pragma unroll
    for (int k = 0; k < kPairsPerThread; ++k)
#pragma unroll
      for (int p = 0; p < P; ++p) acc[k][p] = 0.f;

    for (int j0 = 0; j0 < N; j0 += kTJ) {
      const int nj = min(kTJ, N - j0);
      __syncthreads();  // the previous tile is consumed
      for (int t = threadIdx.x; t < nj; t += blockDim.x) {
        const float x = S[3 * (j0 + t)], y = S[3 * (j0 + t) + 1], z = S[3 * (j0 + t) + 2];
        spos[4 * t] = x;
        spos[4 * t + 1] = y;
        spos[4 * t + 2] = z;
        spos[4 * t + 3] = sq_norm_rn(x, y, z);
        for (int h = 0; h < H; ++h)
          cw[t * H + h] = __fmul_rn(__fadd_rn(__fadd_rn(__fmul_rn(x, sw1[h]), __fmul_rn(y, sw1[H + h])),
                                              __fmul_rn(z, sw1[2 * H + h])),
                                    inv_r);
      }
      for (int t = threadIdx.x; t < nj * C; t += blockDim.x)
        sfeat[t] = __bfloat162float(F[(size_t)j0 * C + t]);
      __syncthreads();
      for (int t = threadIdx.x; t < nj * TS; t += blockDim.x) {
        const int j = t / TS, s = t % TS;
        float* pl = plane + (size_t)j * P * TS + s;
        const float d2 = pair_d2_rn(qpos[4 * s], qpos[4 * s + 1], qpos[4 * s + 2], qpos[4 * s + 3],
                                    spos[4 * j], spos[4 * j + 1], spos[4 * j + 2], spos[4 * j + 3]);
        const bool in = d2 <= r2;
        const float mask = in ? 1.f : 0.f;
        if constexpr (V == kVpuOnly) {
          __nv_bfloat16 run = __float2bfloat16_rn(0.f);
#pragma unroll
          for (int h = 0; h < H; ++h) {
            const float pre = __fadd_rn(__fsub_rn(cw[j * H + h], sw[s * H + h]), sb1[h]);
            const __nv_bfloat16 a = __float2bfloat16_rn(__fmul_rn(fmaxf(pre, 0.f), mask));
            run = __float2bfloat16_rn(__fadd_rn(__bfloat162float(run), __bfloat162float(a)));
          }
          pl[0] = __bfloat162float(run);
        } else if constexpr (V == kH1) {
          const float pre = __fadd_rn(__fsub_rn(cw[j * H], sw[s * H]), sb1[0]);
          pl[0] = bf16_round(__fmul_rn(fmaxf(pre, 0.f), mask));
        } else if constexpr (V == kReplica) {
#pragma unroll
          for (int h = 0; h < H; ++h) {
            const float pre = __fadd_rn(__fsub_rn(cw[j * H + h], sw[s * H + h]), sb1[h]);
            pl[h * TS] = bf16_round(__fmul_rn(fmaxf(pre, 0.f), mask));
          }
          pl[H * TS] = mask;
        } else if constexpr (V == kFwdBf16) {
          const float pen = bf16_round(in ? 0.f : -1.0e9f);
#pragma unroll
          for (int h = 0; h < H; ++h) {
            const float c = bf16_round(__fadd_rn(cw[j * H + h], sb1[h]));
            const float q = bf16_round(sw[s * H + h]);
            const float pre = bf16_round(__fadd_rn(bf16_round(__fsub_rn(c, q)), pen));
            pl[h * TS] = fmaxf(pre, 0.f);
          }
          pl[H * TS] = mask;
        }
      }
      __syncthreads();
#pragma unroll
      for (int k = 0; k < kPairsPerThread; ++k) {
        const int q = threadIdx.x + k * blockDim.x;
        if (q < npairs) {
          const int s = q / C, c = q % C;
          for (int j = 0; j < nj; ++j) {
            const float f = sfeat[j * C + c];
            const float* pl = plane + (size_t)j * P * TS + s;
#pragma unroll
            for (int p = 0; p < P; ++p) acc[k][p] += pl[p * TS] * f;
          }
        }
      }
    }
#pragma unroll
    for (int k = 0; k < kPairsPerThread; ++k) {
      const int q = threadIdx.x + k * blockDim.x;
      if (q >= npairs) continue;
      const int s = q / C, c = q % C;
      if (s >= ms) continue;
      float o = 0.f;
      if constexpr (V == kVpuOnly) {
        o = acc[k][0];
      } else if constexpr (V == kH1) {
        o = __fmul_rn(acc[k][0], w2[c]);
      } else {
#pragma unroll
        for (int h = 0; h < H; ++h) o = __fadd_rn(o, __fmul_rn(acc[k][h], w2[h * C + c]));
        o = __fadd_rn(o, __fmul_rn(acc[k][H], b2[c]));
      }
      out[((size_t)b * N + i0 + s) * C + c] = o;
    }
  }
}

template <int V>
int launch_variant(const float* pts, const __nv_bfloat16* fz, const float* w1, const float* b1,
                   const float* w2, const float* b2, int B, int N, int C, float r2, float inv_r,
                   float* out, cudaStream_t stream) {
  constexpr int H = 8;
  constexpr int P = planes_of<V, H>();
  int TS = kMaxPairs / C;
  if (TS > 64) TS = 64;
  if (TS > N) TS = N;
  const size_t smem = sizeof(float) * ((size_t)kTJ * P * TS + (size_t)kTJ * C +
                                       kTJ * 4 + kTJ * H + TS * 4 + TS * H + 4 * H + H);
  cudaError_t err = cudaFuncSetAttribute(dense_probe_kernel<V, H>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int n_stiles = (N + TS - 1) / TS;
  dim3 grid(n_stiles, B);
  dense_probe_kernel<V, H><<<grid, kThreads, smem, stream>>>(pts, fz, w1, b1, w2, b2, N, C, TS,
                                                             r2, inv_r, out);
  MCCNN_LAUNCH_RETURN();
}

}  // namespace

int dense_probe_noop_launch(const float* pts, const __nv_bfloat16* fz, const float* w2, int B,
                            int N, int C, int H, float* out, cudaStream_t stream);
int dense_probe_mm_only_launch(const float* pts, const __nv_bfloat16* fz, const float* w2, int B,
                               int N, int C, int H, float* out, cudaStream_t stream);
int dense_probe_mm_big_launch(const float* pts, const __nv_bfloat16* fz, const float* w2, int B,
                              int N, int C, int H, float* out, cudaStream_t stream);

// variant: 0 mm_only, 1 vpu_only, 2 replica, 3 h1, 4 noop, 5 mm_big, 6 fwd_bf16.
// pts (B, N, 3) fp32, fz (B, N, C) bf16, w1 (8, H), b1 (H,), w2 (H, C), b2
// (C,) fp32; out (B, N, C) fp32.
extern "C" int dense_probe_launch(int variant, const void* pts, const void* fz, const void* w1,
                                  const void* b1, const void* w2, const void* b2, int B, int N,
                                  int C, int H, float r2, float inv_r, void* out, void* stream) {
  if (H != 8 || C < 1 || C > kMaxPairs || N < 1 || B < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const auto* p = static_cast<const float*>(pts);
  const auto* f = static_cast<const __nv_bfloat16*>(fz);
  const auto* a1 = static_cast<const float*>(w1);
  const auto* c1 = static_cast<const float*>(b1);
  const auto* a2 = static_cast<const float*>(w2);
  const auto* c2 = static_cast<const float*>(b2);
  auto* o = static_cast<float*>(out);
  const auto s = static_cast<cudaStream_t>(stream);
  switch (variant) {
    case kMmOnly: return dense_probe_mm_only_launch(p, f, a2, B, N, C, H, o, s);
    case kVpuOnly: return launch_variant<kVpuOnly>(p, f, a1, c1, a2, c2, B, N, C, r2, inv_r, o, s);
    case kReplica: return launch_variant<kReplica>(p, f, a1, c1, a2, c2, B, N, C, r2, inv_r, o, s);
    case kH1: return launch_variant<kH1>(p, f, a1, c1, a2, c2, B, N, C, r2, inv_r, o, s);
    case kNoop: return dense_probe_noop_launch(p, f, a2, B, N, C, H, o, s);
    case kMmBig: return dense_probe_mm_big_launch(p, f, a2, B, N, C, H, o, s);
    case kFwdBf16: return launch_variant<kFwdBf16>(p, f, a1, c1, a2, c2, B, N, C, r2, inv_r, o, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
