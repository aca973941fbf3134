// The sample-tile kernel of the per-h dense MC conv pair, K1v1
// (dense_conv_v1.cu) and K2v1 (dense_conv_v1_bwd.cu).
//
// A block owns a tile of TS samples of one cloud and sweeps the cloud's
// sources in staged chunks, building each sample's list of in-radius
// sources with warp ballots and their a_h (dense_pairs.cuh, as K1's pair
// kernel): a pair out of radius or with a masked point costs one d2 test, a
// group of 32 masked sources none, and a tile of masked samples no test at
// all. The tile's G[i,h,c] = sum_j a_h(i,j) f~[j,c] (h = H: the in-radius
// mask) stays in registers: a thread holds 4 channels of one sample for all
// H+1 rows (one row at C <= 4, the rows spread over threads), and adds the
// listed sources' terms in increasing j in one FMA chain per value, so G is
// the value K1's pair kernel writes, bit for bit. TS is chosen so that one
// run of the block's threads covers all C channels of the tile: the sweep
// and its lists are made once per tile, however wide C and CO are.
//
// Then, by kMode:
//   - kFoldOut (K1v1): the tile's G goes to shared memory and the block folds
//     it into out = s_i * (G . [W2; b2]) itself (the depthwise fold is per
//     channel); no G reaches device memory. A thread folds up to 8 samples
//     of one column at once, each output one FMA chain over k = h * C + c in
//     increasing k (the order of K1's projection where it does not split
//     k, so the two agree bit for bit there). Each block reads the
//     whole Wcat ((H+1) C CO floats) for its tile from L2: 9.4 MB at a
//     global 256 -> 1024 site, whose clouds hold one sample each. Where a
//     cloud is one small tile (M <= TS), a cluster of CL blocks (CL clouds)
//     shares the work instead: each block forms its cloud's G, gathers the
//     others' from their shared memory (distributed shared memory) and folds
//     one CL-th of the columns for all CL clouds, so Wcat crosses L2 once a
//     cluster and no pair is tested twice.
//   - kGRows (K2v1): the tile's G rows go to device memory, one writer each
//     (every row, zeros for masked samples and tiles of padding), for the
//     backward's row-split [dW2; db2] GEMM, and so do the tile's rows of
//     t = s * dout, which the backward's other passes read.
//
// Limits: H == 8, C <= 1024 (kMaxC), as K1.

#pragma once

#include <cooperative_groups.h>

#include "dense_pairs.cuh"

namespace dense_v1 {

using namespace dense_pairs;
namespace cg = cooperative_groups;

constexpr int kListBudget = 1024;  // list entries a block (36 bytes each)
constexpr int kFoldOut = 0, kGRows = 1;

// The block shape for (M samples, N sources, C channels): TS samples a
// block, `hpt` rows of G a thread (H+1, or 1 at C <= 4), `tps` threads a
// sample and row group, each holding kCpt channels strided by tps.
struct TilePlan {
  int ts, hpt, tps, cap, chunk, tiles;
};

inline TilePlan tile_plan(int M, int N, int C) {
  TilePlan p;
  const bool rows = C <= kCpt;
  p.hpt = rows ? 1 : kHidden + 1;
  p.tps = rows ? 1 : div_up(C, kCpt);
  int ts = kThreads / (rows ? kHidden + 1 : p.tps);  // one run covers C
  if (ts > kMaxOwners) ts = kMaxOwners;
  if (ts > M) ts = M;
  p.ts = ts;
  p.tiles = div_up(M, ts);
  int cap = kListBudget / ts;
  if (cap < 64) cap = 64;
  if (cap > 256) cap = 256;
  p.cap = cap;
  p.chunk = N < kChunk ? (N + 31) / 32 * 32 : kChunk;
  return p;
}

// Shared memory of a block; `fold`: the tile's G, and with CL > 1 the
// cluster's gathered G and output factors.
inline size_t tile_smem(const TilePlan& p, int C, bool fold, int CL) {
  const size_t ts = p.ts, astride = 8 * (size_t)p.cap + 4, istride = p.cap + 1;
  const size_t tile = ts * (kHidden + 1) * C;
  return sizeof(float4) * ((size_t)p.chunk + ts) + sizeof(float) * ts * astride +
         sizeof(int) * ts * istride + sizeof(unsigned) * (p.chunk / 32) +
         sizeof(int) * 4 * ts +
         sizeof(float) * (4 * kHidden + ts + (fold ? tile : 0) +
                          (CL > 1 ? CL * (tile + ts) : 0));
}

// The cluster of a K1v1 launch: CL clouds a cluster where a cloud is one
// tile, the conv is full and the gathered tiles fit (at most 8, the
// portable cluster size); 1 otherwise.
inline int fold_cluster(const TilePlan& p, int B, int C, int CO) {
  int CL = 1;
  const size_t tile = (size_t)p.ts * (kHidden + 1) * C;
  if (CO > 0 && p.tiles == 1)
    while (CL < 8 && 2 * CL <= B && (2 * CL + 1) * (tile + p.ts) * sizeof(float) <= 98304)
      CL *= 2;
  return CL;
}

// out[s0 + u, o] (u < ns <= kFold samples; CO the row length) of the staged
// G rows sg (rows of K = (H+1) C), scaled by sscale. Each output is one FMA
// chain in increasing k; the Wcat values of kBatch rows are loaded before
// any of them is used, so kBatch loads are in flight a thread.
constexpr int kFold = 8, kBatch = 8;

__device__ __forceinline__ void fold_full(const float* sg, const float* sscale,
                                          const float* __restrict__ w2,
                                          const float* __restrict__ b2, int K, int KW, int CO,
                                          int s0, int ns, int o,
                                          float* __restrict__ out_rows) {
  float a[kFold];
#pragma unroll
  for (int u = 0; u < kFold; ++u) a[u] = 0.f;
  const float* gs = sg + (size_t)s0 * K;
  for (int part = 0; part < 2; ++part) {  // the rows k < KW of w2, then those of b2
    const float* W = part == 0 ? w2 : b2;
    const int k0 = part == 0 ? 0 : KW, nk = part == 0 ? KW : K - KW;
    for (int j = 0; j < nk; j += kBatch) {
      const int nb = min(kBatch, nk - j);
      float w[kBatch];
#pragma unroll
      for (int t = 0; t < kBatch; ++t) w[t] = t < nb ? __ldg(W + (size_t)(j + t) * CO + o) : 0.f;
#pragma unroll
      for (int t = 0; t < kBatch; ++t) {
        if (t >= nb) break;
#pragma unroll
        for (int u = 0; u < kFold; ++u)
          a[u] = __fmaf_rn(u < ns ? gs[(size_t)u * K + k0 + j + t] : 0.f, w[t], a[u]);
      }
    }
  }
#pragma unroll
  for (int u = 0; u < kFold; ++u)
    if (u < ns) out_rows[(size_t)(s0 + u) * CO + o] = __fmul_rn(a[u], sscale[s0 + u]);
}

// kMode kFoldOut: out (B, M, CO | C) and cnt (B, M), CO == 0 the depthwise
// conv. kGRows: G (B, M, H+1, C), and out = t = s * dout (B, M, CO | C) from
// the given dout and cnt, s = 1/max(cnt, 1) in mean mode (1 otherwise) and 0
// for a masked sample, rounded as the plain version rounds it.
template <int HPT, int kMode>
__global__ void __launch_bounds__(kThreads)
    mcconv_v1_tile_kernel(const float* __restrict__ smp, const uint8_t* __restrict__ smask,
                          const float* __restrict__ src, const uint8_t* __restrict__ srcmask,
                          const float* __restrict__ wf, const float* __restrict__ w1,
                          const float* __restrict__ b1, const float* __restrict__ w2,
                          const float* __restrict__ b2, const float* __restrict__ dout,
                          int B, int M, int N, int C, int CO, int TS, int TPS, int chunk,
                          int cap, int CL, int mean, float r2, float radius,
                          float* __restrict__ out, float* __restrict__ cnt,
                          float* __restrict__ G) {
  constexpr int H = kHidden, H1 = kHidden + 1, HG = H1 / HPT;
  extern __shared__ float4 sm4[];
  float4* opos = sm4;           // [chunk] sources
  float4* qpos = opos + chunk;  // [TS] samples
  Lists L;
  L.cap = cap;
  L.astride = 8 * cap + 4;
  L.istride = cap + 1;
  L.ostride = 0;
  L.act = reinterpret_cast<float*>(qpos + TS);                      // [TS][astride]
  L.idx = reinterpret_cast<int*>(L.act + (size_t)TS * L.astride);  // [TS][istride]
  L.off = nullptr;
  unsigned* ogrp = reinterpret_cast<unsigned*>(L.idx + TS * L.istride);  // [chunk / 32]
  L.resume = reinterpret_cast<int*>(ogrp + chunk / 32);
  L.len = L.resume + TS;
  L.count = L.len + TS;
  int* qvalid = L.count + TS;
  float* sw1 = reinterpret_cast<float*>(qvalid + TS);  // [3][H]
  float* sb1 = sw1 + 3 * H;                            // [H]
  float* sscale = sb1 + H;                             // [TS]: the output factor s_i
  float* sg = sscale + TS;                             // [TS][H1][C] (kFoldOut)
  float* gall = sg + TS * H1 * C;                      // [CL][TS][H1][C] (CL > 1)
  float* sall = gall + (size_t)CL * TS * H1 * C;       // [CL][TS]

  const int b = blockIdx.y;  // >= B: a cluster's padding block, no samples
  const int i0 = blockIdx.x * TS;
  const int ms = b < B ? min(TS, M - i0) : 0;

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

  // This thread's values of G: sample s, rows hg * HPT .. + HPT, channels
  // cl + k * TPS (all of C in one run: tile_plan).
  const int per = HG * TPS;
  const int s = threadIdx.x / per, hg = (threadIdx.x % per) / TPS, cl = threadIdx.x % TPS;
  const bool owner = s < ms;
  int ch[kCpt];
  bool cv[kCpt];
#pragma unroll
  for (int k = 0; k < kCpt; ++k) {
    ch[k] = cl + k * TPS;
    cv[k] = owner && ch[k] < C;
  }
  float acc[HPT][kCpt];
#pragma unroll
  for (int h = 0; h < HPT; ++h)
#pragma unroll
    for (int k = 0; k < kCpt; ++k) acc[h][k] = 0.f;
  const float* F = wf + (size_t)b * N * C;

  const bool any = __syncthreads_or(threadIdx.x < ms && smask[(size_t)b * M + i0 + threadIdx.x]);
  if (any) {  // else a tile of padding: zero rows, zero counts
    for (int o0 = 0; o0 < N; o0 += chunk) {
      const int n = min(chunk, N - o0);
      __syncthreads();  // the previous chunk's lists are consumed
      stage_others(src, srcmask, b, N, o0, n, opos, ogrp);
      for (int t = threadIdx.x; t < TS; t += blockDim.x) L.resume[t] = 0;
      __syncthreads();
      bool more;
      do {
        more = __syncthreads_or(sweep_round<true>(qpos, qvalid, ms, opos, ogrp, (n + 31) >> 5,
                                                  o0, sw1, sb1, r2, radius, L));
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
        __syncthreads();  // the lists are consumed before the next round
      } while (more);
    }
  }

  if constexpr (kMode == kGRows) {
    if (owner) {
      float* g = G + ((size_t)b * M + i0 + s) * H1 * C;
#pragma unroll
      for (int h = 0; h < HPT; ++h)
#pragma unroll
        for (int k = 0; k < kCpt; ++k)
          if (cv[k]) g[(size_t)(hg * HPT + h) * C + ch[k]] = acc[h][k];
    }
    const int width = CO > 0 ? CO : C;
    const size_t r0 = (size_t)b * M + i0;
    for (int q = threadIdx.x; q < ms * width; q += blockDim.x) {
      const int si = q / width;
      const float sc = mean ? __fdiv_rn(1.f, fmaxf(cnt[r0 + si], 1.f)) : 1.f;
      out[r0 * width + q] = __fmul_rn(dout[r0 * width + q], qvalid[si] ? sc : 0.f);
    }
    return;
  } else {
    // Stage the tile's G and each sample's count and output factor.
    if (owner) {
#pragma unroll
      for (int h = 0; h < HPT; ++h)
#pragma unroll
        for (int k = 0; k < kCpt; ++k)
          if (cv[k]) sg[((size_t)s * H1 + hg * HPT + h) * C + ch[k]] = acc[h][k];
    }
    for (int t = threadIdx.x; t < ms; t += blockDim.x) {
      const float count = (float)L.count[t];
      const float sc = mean ? __fdiv_rn(1.f, fmaxf(count, 1.f)) : 1.f;
      sscale[t] = qvalid[t] ? sc : 0.f;
      cnt[(size_t)b * M + i0 + t] = count;
    }
    const int K = H1 * C, KW = H * C;
    if (CL > 1) {  // one tile a cloud (M <= TS): fold the cluster's clouds together
      cg::cluster_group cluster = cg::this_cluster();
      const int rank = (int)cluster.block_rank();
      const int b0 = b - rank, nq = min(CL, B - b0);  // the cluster's clouds
      cluster.sync();  // every block's tile is staged
      for (int q = 0; q < nq; ++q) {
        const float* rg = cluster.map_shared_rank(sg, q);
        const float* rs = cluster.map_shared_rank(sscale, q);
        for (int t = threadIdx.x; t < M * K; t += blockDim.x) gall[(size_t)q * M * K + t] = rg[t];
        for (int t = threadIdx.x; t < M; t += blockDim.x) sall[q * M + t] = rs[t];
      }
      cluster.sync();  // the gathers are done before any block exits
      // Samples u = q M + i of clouds b0 + q are rows b0 M + u of out.
      const int slice = ((CO + CL - 1) / CL + 31) / 32 * 32;
      const int c0 = rank * slice, c1 = min(CO, c0 + slice), nsm = nq * M;
      int OW = 32;
      while (OW < c1 - c0 && OW < (int)blockDim.x) OW *= 2;
      const int groups = blockDim.x / OW, oo = threadIdx.x % OW, group = threadIdx.x / OW;
      for (int o = c0 + oo; o < c1; o += OW)
        for (int s0 = group * kFold; s0 < nsm; s0 += groups * kFold)
          fold_full(gall, sall, w2, b2, K, KW, CO, s0, min(kFold, nsm - s0), o,
                    out + (size_t)b0 * M * CO);
      return;
    }
    __syncthreads();
    float* rows = out + ((size_t)b * M + i0) * (CO > 0 ? CO : C);
    if (CO == 0) {  // depthwise: out[s, c] = s_i (sum_h G[s,h,c] w2[h,c] + G[s,H,c] b2[c])
      for (int q = threadIdx.x; q < ms * C; q += blockDim.x) {
        const int si = q / C, c = q - si * C;
        const float* g = sg + (size_t)si * H1 * C + c;
        float o = 0.f;
#pragma unroll
        for (int h = 0; h < H; ++h) o = __fmaf_rn(g[(size_t)h * C], __ldg(w2 + h * C + c), o);
        o = __fmaf_rn(g[(size_t)H * C], __ldg(b2 + c), o);
        rows[(size_t)si * C + c] = __fmul_rn(o, sscale[si]);
      }
      return;
    }
    // Full: threads cover OW columns (a power of two dividing the block) and
    // blockDim / OW sample groups; every column of CO in this block.
    int OW = 32;
    while (OW < CO && OW < (int)blockDim.x) OW *= 2;
    const int groups = blockDim.x / OW, oo = threadIdx.x % OW, group = threadIdx.x / OW;
    for (int o = oo; o < CO; o += OW)
      for (int s0 = group * kFold; s0 < ms; s0 += groups * kFold)
        fold_full(sg, sscale, w2, b2, K, KW, CO, s0, min(kFold, ms - s0), o, rows);
  }
}

// Launch the tile kernel of kMode for a batch (H == 8 and 1 <= C <= kMaxC
// checked by the caller); kGRows reads dout and cnt.
template <int kMode>
int launch_tile(const void* smp, const void* smask, const void* src, const void* srcmask,
                const void* wf, const void* w1, const void* b1, const void* w2, const void* b2,
                const void* dout, int B, int M, int N, int C, int CO, int mean, float r2,
                float radius, void* out, void* cnt, void* G, void* stream) {
  const TilePlan p = tile_plan(M, N, C);
  const int CL = kMode == kFoldOut ? fold_cluster(p, B, C, CO) : 1;
  const size_t smem = tile_smem(p, C, kMode == kFoldOut, CL);
  auto kernel = p.hpt == 1 ? mcconv_v1_tile_kernel<1, kMode>
                           : mcconv_v1_tile_kernel<kHidden + 1, kMode>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(p.tiles, div_up(B, CL) * CL);  // clusters of CL clouds along y
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = static_cast<cudaStream_t>(stream);
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = 1;
  attr.val.clusterDim.y = CL;
  attr.val.clusterDim.z = 1;
  cfg.attrs = &attr;
  cfg.numAttrs = CL > 1 ? 1 : 0;
  err = cudaLaunchKernelEx(
      &cfg, kernel, static_cast<const float*>(smp), static_cast<const uint8_t*>(smask),
      static_cast<const float*>(src), static_cast<const uint8_t*>(srcmask),
      static_cast<const float*>(wf), static_cast<const float*>(w1),
      static_cast<const float*>(b1), static_cast<const float*>(w2),
      static_cast<const float*>(b2), static_cast<const float*>(dout), B, M, N, C, CO, p.ts,
      p.tps, p.chunk, p.cap, CL, mean, r2, radius, static_cast<float*>(out),
      static_cast<float*>(cnt), static_cast<float*>(G));
  if (err != cudaSuccess) return static_cast<int>(err);
  MCCNN_LAUNCH_RETURN();
}

}  // namespace dense_v1
