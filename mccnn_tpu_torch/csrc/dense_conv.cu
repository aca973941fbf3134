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
// What bounds the pair kernel on the H100: only the in-radius pairs of valid
// points carry work (8 pre-activations and (H+1) FMAs a channel); every other
// pair needs one d2 test. At ShapeNet's 1024 -> 1024 sites a few pairs in a
// thousand are in radius, at MCClassS's global site all of them; levels are
// mostly padding (~100 valid samples in 496 slots). So the kernel tests
// every pair and does the rest only for the pairs that pass:
//
//   - a block owns a tile of samples of one cloud and sweeps the cloud's
//     sources in staged chunks, building each sample's list of in-radius
//     sources with warp ballots and their a_h (dense_pairs.cuh); a group of
//     32 sources with no valid one, and a sample tile with no valid sample,
//     cost no d2 test (the tile still writes its zero rows of G and counts:
//     G comes from torch.empty and K2's dW2 reads every row);
//   - a thread holds up to 4 channels of one sample in registers for all H+1
//     rows (36 accumulators) and, per listed source, reads its 8 a_h once
//     from shared memory and its f~ values from L2 (no block stages the
//     cloud's features); at C <= 4 the rows are spread over threads instead,
//     one row a thread, so every thread of the block works;
//   - a block keeps at least 16 samples, so that all 8 warps sweep and one
//     staged chunk serves many samples; at C > 64 it covers its channels in
//     passes of 64, and a pass after the first walks the first pass's lists
//     again where they held every in-radius pair (one chunk, one round);
//   - where the grid would not fill the card (B * tiles < 264: MCClassS's
//     conv_1_2 and global site, the zoo's deep sites) the channels are split
//     over a third grid dimension; each block redoes its tile's sweep, so
//     every output keeps one writer and one FMA chain;
//   - every output adds its in-radius sources in increasing j in one FMA
//     chain, as the previous all-pairs kernel did with exact zeros for the
//     pairs now skipped, so G and the count are bit-equal to it.
//
// Everything is fp32, no atomics: two calls are bit-identical. The GEMM is a
// 64x64x16 shared-memory tiled kernel, 4x4 outputs per thread, its k range
// split over blocks (partials summed in split order) where the output tiles
// alone would not fill the card (a few hundred rows: conv_1_2, the global
// site).
//
// Limits: H == 8 (KERNEL_HIDDEN; the accumulators are unrolled) and C <= 1024
// (256 threads of 4 channels).

#include "dense_pairs.cuh"

namespace {

using namespace dense_pairs;

constexpr int kListBudget = 2048;  // list entries a block (36 bytes each)

// HPT rows of G a thread: 9 (all rows, kCpt channels) or 1 (C <= 4). A block
// covers `passes` runs of 4 * TPS channels (slice blockIdx.z of them); a pass
// after the first walks the first pass's lists again where those held every
// in-radius pair (one chunk, one round), and sweeps again where not.
template <int HPT>
__global__ void __launch_bounds__(kThreads)
    mcconv_pair_kernel(const float* __restrict__ smp, const uint8_t* __restrict__ smask,
                       const float* __restrict__ src, const uint8_t* __restrict__ srcmask,
                       const float* __restrict__ wf, const float* __restrict__ w1,
                       const float* __restrict__ b1, int M, int N, int C, int TS, int TPS,
                       int passes, int chunk, int cap, float r2, float radius,
                       float* __restrict__ G, float* __restrict__ cnt) {
  constexpr int H = kHidden, H1 = kHidden + 1, HG = H1 / HPT;
  extern __shared__ float4 sm4[];
  float4* opos = sm4;                                   // [chunk] sources
  float4* qpos = opos + chunk;                          // [TS] samples
  Lists L;
  L.cap = cap;
  L.astride = 8 * cap + 4;
  L.istride = cap + 1;
  L.ostride = 0;
  L.act = reinterpret_cast<float*>(qpos + TS);          // [TS][astride]
  L.idx = reinterpret_cast<int*>(L.act + (size_t)TS * L.astride);  // [TS][istride]
  L.off = nullptr;
  unsigned* ogrp = reinterpret_cast<unsigned*>(L.idx + TS * L.istride);  // [chunk / 32]
  L.resume = reinterpret_cast<int*>(ogrp + chunk / 32);
  L.len = L.resume + TS;
  L.count = L.len + TS;
  int* qvalid = L.count + TS;
  float* sw1 = reinterpret_cast<float*>(qvalid + TS);  // [3][H]
  float* sb1 = sw1 + 3 * H;                            // [H]

  const int b = blockIdx.y;
  const int i0 = blockIdx.x * TS;
  const int ms = min(TS, M - i0);
  const int CS = kCpt * TPS;

  for (int t = threadIdx.x; t < TS; t += blockDim.x) {
    float x = 0.f, y = 0.f, z = 0.f;
    int v = 0;
    if (t < ms) {
      const size_t k = (size_t)b * M + i0 + t;
      x = smp[3 * k];
      y = smp[3 * k + 1];
      z = smp[3 * k + 2];
      v = smask[k] != 0;
    }
    qpos[t] = make_float4(x, y, z, sq_norm_rn(x, y, z));
    qvalid[t] = v;
    L.count[t] = 0;
  }
  for (int t = threadIdx.x; t < 3 * H; t += blockDim.x) sw1[t] = w1[t];
  for (int t = threadIdx.x; t < H; t += blockDim.x) sb1[t] = b1[t];

  // This thread's outputs in a pass: sample s, rows hg * HPT .. + HPT,
  // channels c0 + cl + k * TPS.
  const int per = HG * TPS;
  const int s = threadIdx.x / per, hg = (threadIdx.x % per) / TPS, cl = threadIdx.x % TPS;
  const bool owner = s < ms;
  const float* F = wf + (size_t)b * N * C;
  const bool any = __syncthreads_or(threadIdx.x < ms && smask[(size_t)b * M + i0 + threadIdx.x]);
  bool reuse = false;  // the lists hold every in-radius pair of the tile
  for (int pass = 0; pass < passes; ++pass) {
    const int c0 = (blockIdx.z * passes + pass) * CS, cend = min(C, c0 + CS);
    int ch[kCpt];
    bool cv[kCpt];
#pragma unroll
    for (int k = 0; k < kCpt; ++k) {
      ch[k] = c0 + cl + k * TPS;
      cv[k] = owner && ch[k] < cend;
    }
    float acc[HPT][kCpt];
#pragma unroll
    for (int h = 0; h < HPT; ++h)
#pragma unroll
      for (int k = 0; k < kCpt; ++k) acc[h][k] = 0.f;

    if (any) {  // else a tile of padding: zero rows, zero counts
      int rounds = 0;
      for (int o0 = 0; o0 < N; o0 += chunk) {
        const int n = min(chunk, N - o0);
        if (!reuse) {
          __syncthreads();  // the previous chunk's lists and counts are consumed
          stage_others(src, srcmask, b, N, o0, n, opos, ogrp);
          for (int t = threadIdx.x; t < TS; t += blockDim.x) {
            L.resume[t] = 0;
            if (o0 == 0) L.count[t] = 0;
          }
          __syncthreads();
        }
        bool more = false;
        do {
          if (!reuse)
            more = __syncthreads_or(sweep_round<true>(qpos, qvalid, ms, opos, ogrp,
                                                      (n + 31) >> 5, o0, sw1, sb1, r2, radius,
                                                      L));
          // This thread's sample's listed sources, in increasing j, into acc.
          if (owner) {
            const int ne = L.len[s];
            const int* li = L.idx + s * L.istride;
            const float* la = L.act + (size_t)s * L.astride;
#pragma unroll 4
            for (int e = 0; e < ne; ++e) {
              const float* frow = F + (size_t)li[e] * C;
              float f[kCpt];
#pragma unroll
              for (int k = 0; k < kCpt; ++k) f[k] = cv[k] ? __ldg(frow + ch[k]) : 0.f;
              if constexpr (HPT == H1) {
                const float4 a0 = *reinterpret_cast<const float4*>(la + 8 * e);
                const float4 a1 = *reinterpret_cast<const float4*>(la + 8 * e + 4);
                const float a[H] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
#pragma unroll
                for (int k = 0; k < kCpt; ++k) {
#pragma unroll
                  for (int h = 0; h < H; ++h) acc[h][k] = __fmaf_rn(a[h], f[k], acc[h][k]);
                  acc[HPT - 1][k] = __fadd_rn(acc[HPT - 1][k], f[k]);  // a_H = 1
                }
              } else {
                const float a = hg < H ? la[8 * e + hg] : 1.f;
#pragma unroll
                for (int k = 0; k < kCpt; ++k) acc[0][k] = __fmaf_rn(a, f[k], acc[0][k]);
              }
            }
          }
          if (!reuse) __syncthreads();  // the lists are consumed before the next round
          ++rounds;
        } while (more);
      }
      reuse = rounds == 1;  // one chunk, one round: the next pass walks these lists
    }
    if (owner) {
      float* g = G + ((size_t)b * M + i0 + s) * H1 * C;
#pragma unroll
      for (int h = 0; h < HPT; ++h)
#pragma unroll
        for (int k = 0; k < kCpt; ++k)
          if (cv[k]) g[(size_t)(hg * HPT + h) * C + ch[k]] = acc[h][k];
    }
  }
  if (blockIdx.z == 0)
    for (int t = threadIdx.x; t < ms; t += blockDim.x)
      cnt[(size_t)b * M + i0 + t] = (float)L.count[t];
}

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

size_t pair_smem(const Plan& p) {
  const size_t astride = 8 * (size_t)p.cap + 4, istride = p.cap + 1;
  return sizeof(float4) * ((size_t)p.chunk + p.owners) +
         sizeof(float) * (size_t)p.owners * astride + sizeof(int) * (size_t)p.owners * istride +
         sizeof(unsigned) * (p.chunk / 32) + sizeof(int) * 4 * (size_t)p.owners +
         sizeof(float) * 4 * kHidden;
}

template <int HPT>
int launch_pair(const Plan& p, dim3 grid, cudaStream_t stream, const void* smp,
                const void* smask, const void* src, const void* srcmask, const void* wf,
                const void* w1, const void* b1, int M, int N, int C, float r2, float radius,
                void* G, void* cnt) {
  const size_t smem = pair_smem(p);
  cudaError_t err = cudaFuncSetAttribute(mcconv_pair_kernel<HPT>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  mcconv_pair_kernel<HPT><<<grid, p.threads, smem, stream>>>(
      static_cast<const float*>(smp), static_cast<const uint8_t*>(smask),
      static_cast<const float*>(src), static_cast<const uint8_t*>(srcmask),
      static_cast<const float*>(wf), static_cast<const float*>(w1),
      static_cast<const float*>(b1), M, N, C, p.owners, p.tps, p.passes, p.chunk, p.cap, r2,
      radius, static_cast<float*>(G), static_cast<float*>(cnt));
  MCCNN_LAUNCH_RETURN();
}

}  // namespace

extern "C" int mcconv_pair_launch(const void* smp, const void* smask, const void* src,
                                  const void* srcmask, const void* wf, const void* w1,
                                  const void* b1, int B, int M, int N, int C, int H,
                                  float r2, float radius, void* G, void* cnt,
                                  void* stream) {
  if (H != kHidden || C < 1 || C > kMaxC || M < 1 || N < 1 || B < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const bool rows = C <= kCpt;  // one row of G a thread, all of C in its registers
  const Plan p = make_plan(B, M, N, C, rows, kListBudget, 64);
  const dim3 grid(p.tiles, B, p.slices);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  return rows ? launch_pair<1>(p, grid, st, smp, smask, src, srcmask, wf, w1, b1, M, N, C, r2,
                               radius, G, cnt)
              : launch_pair<kHidden + 1>(p, grid, st, smp, smask, src, srcmask, wf, w1, b1, M,
                                         N, C, r2, radius, G, cnt);
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
