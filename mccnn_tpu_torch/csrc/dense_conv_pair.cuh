// The pair kernel of K1 (dense_conv.cu) and of K1p (dense_conv_planes.cu):
// G[b,i,h,c] = sum_j a_h(i,j) * f~[b,j,c] over the in-radius sources of each
// sample (h < H: relu planes, h = H: the in-radius mask), and the count.
//
// What bounds it on the H100: only the in-radius pairs of valid points
// carry work (8 pre-activations and (H+1) FMAs a channel); every other
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
// K1 forms a listed pair's a_h in K1's offset form ((p_j - x_i) / r) . W1 +
// b1 (`OffsetForm`, one entry a lane). K1p forms them in the reference's
// factored form (cw_h(j) - sw_h(i)) + b1_h on the tensor cores
// (`PlanesForm`): everything else, lists, passes, splits and contraction,
// is the same kernel. Everything is fp32, no atomics: two calls are
// bit-identical. Limits: H == 8 (KERNEL_HIDDEN; the accumulators are
// unrolled) and C <= 1024 (256 threads of 4 channels).

#pragma once

#include "dense_pairs.cuh"

namespace {

using namespace dense_pairs;

constexpr int kPieceWords = 3 * kHidden;  // a point's TF32 pieces, [piece][h]
constexpr uint32_t kOne = 0x3f800000u;    // 1.0f, exact in TF32

__device__ __forceinline__ void mma_tf32(float* d, const uint32_t* a, const uint32_t* b,
                                         float c) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%10,%11,%12,%13};\n"
      : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]), "f"(c), "f"(c),
        "f"(c), "f"(c));
}

// The 8 words at p (16-byte aligned) into v, or `fill` where p is null.
__device__ __forceinline__ void load8(const uint32_t* p, uint32_t fill, uint32_t* v) {
  if (p) {
    const uint4 x = __ldg(reinterpret_cast<const uint4*>(p));
    const uint4 y = __ldg(reinterpret_cast<const uint4*>(p) + 1);
    v[0] = x.x, v[1] = x.y, v[2] = x.z, v[3] = x.w, v[4] = y.x, v[5] = y.y, v[6] = y.z, v[7] = y.w;
  } else {
#pragma unroll
    for (int h = 0; h < 8; ++h) v[h] = fill;
  }
}

// K1p's entries: a_h = relu((cw_h(j) - sw_h(i)) + b1_h) of a complete list,
// 16 listed sources an MMA (mma.sync m16n8k8 TF32, one an h): row e of A is
// [c1 c2 c3 1 | 1 1 0 0] with cw_h(j_e) = c1 + c2 + c3, every column of B is
// the owner's [1 1 1 -s1 | -s2 -s3 0 0] with sw_h(i) = s1 + s2 + s3, and b1_h
// is in the accumulator. The pieces are exact TF32 splits, formed once a
// point by mcconv_planes_pieces_kernel (dense_conv_planes.cu), so every
// product is exact and the entry is the tensor core's fp32 sum of cw, -sw
// and b1, as the all-pairs K1p formed each plane value. The 8 columns repeat
// one sample: the MMA's rows are the list's entries, and no pair outside the
// lists gets a plane value. Lane (grp, tig) holds rows grp and grp + 8; the
// lanes of tig 0 and 1 store them.
struct PlanesForm {
  const uint32_t* cw;  // this cloud's sources: [N][3][H] pieces of cw
  const uint32_t* sw;  // this block's samples: [TS][3][H] pieces of -sw
  const float* b1;     // [H], in shared memory

  __device__ __forceinline__ void operator()(int s, float4, const int* idx, int len, int,
                                             const float4*, const Lists& L) const {
    const int lane = threadIdx.x & 31, grp = lane >> 2, tig = lane & 3;
    const uint32_t* sp = sw + (size_t)s * kPieceWords;
    uint32_t bq0[kHidden], bq1[kHidden];  // B rows tig and tig + 4, every h
    load8(tig == 3 ? sp : nullptr, kOne, bq0);
    load8(tig < 2 ? sp + (1 + tig) * kHidden : nullptr, 0u, bq1);
    const uint32_t a23 = tig < 2 ? kOne : 0u;
    float* act = L.act + (size_t)s * L.astride;
    for (int e0 = 0; e0 < len; e0 += 16) {  // len is the warp's: every lane runs each MMA
      const int ea = e0 + grp, ec = ea + 8;
      uint32_t pa[kHidden], pc[kHidden];  // A columns tig of rows ea and ec, every h
      load8(tig < 3 && ea < len ? cw + (size_t)idx[ea] * kPieceWords + tig * kHidden : nullptr,
            tig < 3 ? 0u : kOne, pa);
      load8(tig < 3 && ec < len ? cw + (size_t)idx[ec] * kPieceWords + tig * kHidden : nullptr,
            tig < 3 ? 0u : kOne, pc);
      float v[kHidden];
#pragma unroll
      for (int h = 0; h < kHidden; ++h) {
        const uint32_t a[4] = {pa[h], pc[h], a23, a23}, bf[2] = {bq0[h], bq1[h]};
        float d[4];
        mma_tf32(d, a, bf, b1[h]);
        v[h] = fmaxf(tig == 0 ? d[0] : d[2], 0.f);  // row ea (tig 0) or ec (tig 1)
      }
      const int e = tig == 0 ? ea : ec;
      if (tig < 2 && e < len) {
        float4* dst = reinterpret_cast<float4*>(act + 8 * e);
        dst[0] = make_float4(v[0], v[1], v[2], v[3]);
        dst[1] = make_float4(v[4], v[5], v[6], v[7]);
      }
    }
  }
};

constexpr int kListBudget = 2048;  // list entries a block (36 bytes each)

// HPT rows of G a thread: 9 (all rows, kCpt channels) or 1 (C <= 4). A block
// covers `passes` runs of 4 * TPS channels (slice blockIdx.z of them); a pass
// after the first walks the first pass's lists again where those held every
// in-radius pair (one chunk, one round), and sweeps again where not.
// kPlanes: K1p, its entries formed by `PlanesForm` from `pieces` (K1 passes
// none).
template <int HPT, bool kPlanes>
__global__ void __launch_bounds__(kThreads)
    mcconv_pair_kernel(const float* __restrict__ smp, const uint8_t* __restrict__ smask,
                       const float* __restrict__ src, const uint8_t* __restrict__ srcmask,
                       const float* __restrict__ wf, const float* __restrict__ w1,
                       const float* __restrict__ b1, const uint32_t* __restrict__ pieces, int M,
                       int N, int C, int TS, int TPS, int passes, int chunk, int cap, float r2,
                       float radius, float* __restrict__ G, float* __restrict__ cnt) {
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
          if (!reuse) {
            if constexpr (kPlanes)  // the pieces of the cloud's sources and the tile's samples
              more = __syncthreads_or(sweep_round<true>(
                  qpos, qvalid, ms, opos, ogrp, (n + 31) >> 5, o0, r2, L,
                  PlanesForm{pieces + (size_t)b * N * kPieceWords,
                             pieces + ((size_t)gridDim.y * N + (size_t)b * M + i0) * kPieceWords,
                             sb1}));
            else
              more = __syncthreads_or(sweep_round<true>(qpos, qvalid, ms, opos, ogrp,
                                                        (n + 31) >> 5, o0, sw1, sb1, r2,
                                                        radius, L));
          }
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

size_t pair_smem(const Plan& p) {
  const size_t astride = 8 * (size_t)p.cap + 4, istride = p.cap + 1;
  return sizeof(float4) * ((size_t)p.chunk + p.owners) +
         sizeof(float) * (size_t)p.owners * astride + sizeof(int) * (size_t)p.owners * istride +
         sizeof(unsigned) * (p.chunk / 32) + sizeof(int) * 4 * (size_t)p.owners +
         sizeof(float) * 4 * kHidden;
}

template <int HPT, bool kPlanes>
int launch_pair(const Plan& p, dim3 grid, cudaStream_t stream, const void* smp,
                const void* smask, const void* src, const void* srcmask, const void* wf,
                const void* w1, const void* b1, const uint32_t* pieces, int M, int N, int C,
                float r2, float radius, void* G, void* cnt) {
  const size_t smem = pair_smem(p);
  cudaError_t err = cudaFuncSetAttribute(mcconv_pair_kernel<HPT, kPlanes>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  mcconv_pair_kernel<HPT, kPlanes><<<grid, p.threads, smem, stream>>>(
      static_cast<const float*>(smp), static_cast<const uint8_t*>(smask),
      static_cast<const float*>(src), static_cast<const uint8_t*>(srcmask),
      static_cast<const float*>(wf), static_cast<const float*>(w1),
      static_cast<const float*>(b1), pieces, M, N, C, p.owners, p.tps, p.passes, p.chunk, p.cap,
      r2, radius, static_cast<float*>(G), static_cast<float*>(cnt));
  MCCNN_LAUNCH_RETURN();
}

// The pair kernel of K1 (kPlanes false) or K1p at (B, M samples, N sources,
// C channels): its plan, grid and launch. K1p's `pieces` hold the TF32
// pieces of cw for the B * N sources, then of -sw for the B * M samples.
template <bool kPlanes>
int launch_pair_kernel(const void* smp, const void* smask, const void* src, const void* srcmask,
                       const void* wf, const void* w1, const void* b1, const uint32_t* pieces,
                       int B, int M, int N, int C, float r2, float radius, void* G, void* cnt,
                       cudaStream_t stream) {
  const bool rows = C <= kCpt;  // one row of G a thread, all of C in its registers
  const Plan p = make_plan(B, M, N, C, rows, kListBudget, 64);
  const dim3 grid(p.tiles, B, p.slices);
  return rows ? launch_pair<1, kPlanes>(p, grid, stream, smp, smask, src, srcmask, wf, w1, b1,
                                        pieces, M, N, C, r2, radius, G, cnt)
              : launch_pair<kHidden + 1, kPlanes>(p, grid, stream, smp, smask, src, srcmask, wf,
                                                  w1, b1, pieces, M, N, C, r2, radius, G, cnt);
}

}  // namespace
