// K2: the dense Monte-Carlo convolution, backward.
//
// Replaces mccnn_tpu/ops/pallas/dense_conv.py::_bwd_kernel_b (reached through
// _bwd_call_b from the custom_vjp of dense_mc_conv). K1 (dense_conv.cu) writes
// G[b,i,h,c] = sum_j a_h(i,j) f~[b,j,c] and out = s_i * (G . [W2; b2]); given
// t = s * dout (s = 1/count in mean mode, 0 for masked samples), this computes
// the gradients with respect to f~, W1, b1, W2 and b2:
//
//   dG[i,h,c]  = sum_o t[i,o] Wcat[h*C+c, o]        (Wcat = [W2 as (H*C, CO); b2])
//   dWcat      = G^T t                               (-> dW2, db2)
//   d_f~[j,c]  = sum_i sum_{h<=H} a_h(i,j) dG[i,h,c]
//   dpre_h(i,j) = [pre_h > 0] [in radius] sum_c dG[i,h,c] f~[j,c]
//   dW1[k,h]   = sum_{i,j} dpre_h(i,j) (p_j - x_i)_k / r,   db1[h] = sum dpre_h.
//
// The TPU kernel walks source tiles on a sequential grid and carries dW1..db2
// in scratch from step to step, with bf16 planes and features. Blocks on the
// H100 run in no order, so the port splits the work into kernels that each
// give every output one writer, all in fp32:
//
//   1. dG: a 64x64x16 tiled GEMM (t @ Wcat^T) whose B operand reads W2 and b2
//      in place, its reduction over CO split over blocks where the output
//      tiles alone would not fill the card (the global site: 32 rows). A
//      depthwise dG is t * [w2; b2], which the pair kernel forms where it
//      reads it: no dG is stored.
//   2. dWcat: the same tiled GEMM in its transposed form (G^T t), split over
//      the rows of the batch (R = B*M up to 16k at conv_0_1) into chunks
//      whose partial products a third kernel sums in chunk order.
//   3. the pair kernel (d_f~, dW1, db1), below.
//
// What bounds the pair kernel on the H100: only the in-radius pairs of valid
// points carry work (8 pre-activations, (H+1) FMAs a channel for d_f~, H for
// dpre) and the dG rows those pairs read; every other pair needs one d2 test
// on positions (16 bytes a point). A kernel that stages every sample's dG for
// every source block reads the cloud's dG once a block: 9.4 MB a cloud and
// 256 blocks a cloud at ShapeNet's dec_1_0 (C = 256). So:
//
//   - a block owns a tile of sources of one cloud and sweeps the cloud's
//     sample positions in staged chunks, building each source's list of
//     in-radius samples with warp ballots, with their a_h and offsets
//     (dense_pairs.cuh; the same d2, offsets and a_h as K1's, so a pair at the
//     radius is in or out on both passes). It reads dG rows only for listed
//     pairs, from L2, and stages no dG at all. A source tile with no valid
//     source writes its zero rows of d_f~ and a zero partial and exits;
//   - a thread holds up to 4 channels of one source: their d_f~ sums and f~
//     values stay in registers (at C > 64, in passes of 64 channels over at
//     least 16 sources a block, as K1). Per listed sample it loads the 9 dG
//     rows of its channels (at a depthwise site it loads t's row and forms
//     dG = t * [w2; b2] itself, the values a stored dG would hold), adds
//     sum_h a_h dG to each d_f~ sum in one FMA chain in
//     increasing i (one writer per (j, c): bit-equal to the all-pairs kernel,
//     whose skipped terms were exact zeros), and forms this thread's share of
//     each dot product dG[i,h,:] . f~[j,:] over its channels. It adds that
//     share times [a_h > 0] (o_x, o_y, o_z, 1) into 32 register sums of dW1 /
//     db1: the C-long dot products are spread over the threads that hold the
//     channels, and no thread walks one alone;
//   - the block sums the 32 values over its threads in a fixed order (warp
//     shuffles, then warps in order) into one partial; the reduction kernel
//     sums the partials in block order;
//   - where the grid would not fill the card (B * tiles < 264) the channels
//     are split over a third grid dimension, as in K1.
//
// No float atomics anywhere: two calls give bit-identical gradients, as the
// reference's do (tests/test_pallas_mcconv.py:82). The ReLU step is taken as
// a_h > 0, i.e. pre_h > 0 in fp32, so pre_h == 0 takes the step value 0 as
// jnp.where(pre > 0, ...) does.
//
// Limits: H == 8 (KERNEL_HIDDEN) and C <= 1024, as K1.

#include "dense_pairs.cuh"

namespace {

using namespace dense_pairs;

constexpr int kListBudget = 1024;  // list entries a block (52 bytes each)

constexpr int kBM = 64, kBN = 64, kBK = 16;

// dG[r, n] = sum_o t[r, o] * Wcat[n, o]; rows n < KW of Wcat are w2 (KW, CO),
// the rest b2 (NC - KW, CO). As K1's projection, the o range is split over
// gridDim.z where the output tiles would not fill the card (part[z], summed
// in z order by mcconv_bwd_reduce_kernel).
__global__ void mcconv_bwd_dg_full_kernel(const float* __restrict__ t,
                                          const float* __restrict__ w2,
                                          const float* __restrict__ b2, int R, int CO,
                                          int KW, int NC, int kchunk, float* __restrict__ dG,
                                          float* __restrict__ part) {
  __shared__ float As[kBK][kBM + 4];
  __shared__ float Bs[kBK][kBN + 4];
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const int r0 = blockIdx.y * kBM, n0 = blockIdx.x * kBN;
  const int kb = blockIdx.z * kchunk, ke = min(CO, kb + kchunk);
  float acc[4][4] = {};
  for (int k0 = kb; k0 < ke; k0 += kBK) {
    for (int i = threadIdx.x; i < kBM * kBK; i += blockDim.x) {
      const int rr = i / kBK, kk = i % kBK;
      const int r = r0 + rr, k = k0 + kk;
      As[kk][rr] = (r < R && k < ke) ? t[(size_t)r * CO + k] : 0.f;
    }
    for (int i = threadIdx.x; i < kBN * kBK; i += blockDim.x) {
      const int nn = i / kBK, kk = i % kBK;
      const int n = n0 + nn, k = k0 + kk;
      float w = 0.f;
      if (n < NC && k < ke)
        w = n < KW ? w2[(size_t)n * CO + k] : b2[(size_t)(n - KW) * CO + k];
      Bs[kk][nn] = w;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kBK; ++kk) {
      float a[4], w[4];
#pragma unroll
      for (int u = 0; u < 4; ++u) a[u] = As[kk][ty + 16 * u];
#pragma unroll
      for (int v = 0; v < 4; ++v) w[v] = Bs[kk][tx + 16 * v];
#pragma unroll
      for (int u = 0; u < 4; ++u)
#pragma unroll
        for (int v = 0; v < 4; ++v) acc[u][v] += a[u] * w[v];
    }
    __syncthreads();
  }
  float* dst = gridDim.z == 1 ? dG : part + (size_t)blockIdx.z * R * NC;
#pragma unroll
  for (int u = 0; u < 4; ++u) {
    const int r = r0 + ty + 16 * u;
    if (r >= R) continue;
#pragma unroll
    for (int v = 0; v < 4; ++v) {
      const int n = n0 + tx + 16 * v;
      if (n < NC) dst[(size_t)r * NC + n] = acc[u][v];
    }
  }
}

// part[z, m, n] = sum over rows r of chunk z of A[r, m] * t[r, n]
// (A = G as (R, MA), t as (R, CO)); chunk z covers rows [z*rchunk, (z+1)*rchunk).
__global__ void mcconv_bwd_dw2_full_kernel(const float* __restrict__ A,
                                           const float* __restrict__ t, int R, int MA,
                                           int CO, int rchunk, float* __restrict__ part) {
  __shared__ float As[kBK][kBM];
  __shared__ float Bs[kBK][kBN];
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const int m0 = blockIdx.y * kBM, n0 = blockIdx.x * kBN;
  const int rb = blockIdx.z * rchunk;
  const int re = min(R, rb + rchunk);
  float acc[4][4] = {};
  for (int k0 = rb; k0 < re; k0 += kBK) {
    for (int i = threadIdx.x; i < kBK * kBM; i += blockDim.x) {
      const int kk = i / kBM, mm = i % kBM;
      const int r = k0 + kk, m = m0 + mm;
      As[kk][mm] = (r < re && m < MA) ? A[(size_t)r * MA + m] : 0.f;
    }
    for (int i = threadIdx.x; i < kBK * kBN; i += blockDim.x) {
      const int kk = i / kBN, nn = i % kBN;
      const int r = k0 + kk, n = n0 + nn;
      Bs[kk][nn] = (r < re && n < CO) ? t[(size_t)r * CO + n] : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kBK; ++kk) {
      float a[4], w[4];
#pragma unroll
      for (int u = 0; u < 4; ++u) a[u] = As[kk][ty + 16 * u];
#pragma unroll
      for (int v = 0; v < 4; ++v) w[v] = Bs[kk][tx + 16 * v];
#pragma unroll
      for (int u = 0; u < 4; ++u)
#pragma unroll
        for (int v = 0; v < 4; ++v) acc[u][v] += a[u] * w[v];
    }
    __syncthreads();
  }
  float* out = part + (size_t)blockIdx.z * MA * CO;
#pragma unroll
  for (int u = 0; u < 4; ++u) {
    const int m = m0 + ty + 16 * u;
    if (m >= MA) continue;
#pragma unroll
    for (int v = 0; v < 4; ++v) {
      const int n = n0 + tx + 16 * v;
      if (n < CO) out[(size_t)m * CO + n] = acc[u][v];
    }
  }
}

// part[z, h, c] = sum over rows r of chunk z of G[r, h, c] * t[r, c].
__global__ void mcconv_bwd_dw2_depthwise_kernel(const float* __restrict__ G,
                                                const float* __restrict__ t, int R, int H1,
                                                int C, int rchunk, float* __restrict__ part) {
  const int l = blockIdx.x * blockDim.x + threadIdx.x;
  if (l >= H1 * C) return;
  const int c = l % C;
  const int rb = blockIdx.y * rchunk;
  const int re = min(R, rb + rchunk);
  float acc = 0.f;
  for (int r = rb; r < re; ++r) acc += G[(size_t)r * H1 * C + l] * t[(size_t)r * C + c];
  part[(size_t)blockIdx.y * H1 * C + l] = acc;
}

// out[l] = sum_{z < Z} part[z * L + l], summed in z order.
__global__ void mcconv_bwd_reduce_kernel(const float* __restrict__ part, int Z, int L,
                                         float* __restrict__ out) {
  const int l = blockIdx.x * blockDim.x + threadIdx.x;
  if (l >= L) return;
  float acc = 0.f;
  for (int z = 0; z < Z; ++z) acc += part[(size_t)z * L + l];
  out[l] = acc;
}

// kDepthwise: dG is not formed; `dG` points at t (B, M, C) and each dG value
// is formed where it is read, t[i,c] * (h < H ? w2[h,c] : b2[c]), the
// product the elementwise dG kernel would have stored.
template <bool kDepthwise>
__global__ void __launch_bounds__(kThreads, 2)
    mcconv_bwd_pair_kernel(const float* __restrict__ smp, const uint8_t* __restrict__ smask,
                           const float* __restrict__ src, const uint8_t* __restrict__ srcmask,
                           const float* __restrict__ wf, const float* __restrict__ w1,
                           const float* __restrict__ b1, const float* __restrict__ w2,
                           const float* __restrict__ b2, const float* __restrict__ dG, int M,
                           int N, int C, int TJ, int TPS, int passes, int chunk, int cap,
                           float r2,
                           float radius, float* __restrict__ dwf, float* __restrict__ part) {
  constexpr int H = kHidden, H1 = kHidden + 1;
  extern __shared__ float4 sm4[];
  float4* opos = sm4;           // [chunk] samples
  float4* jpos = opos + chunk;  // [TJ] sources
  Lists L;
  L.cap = cap;
  L.ostride = cap + 1;
  L.astride = 8 * cap + 4;
  L.istride = cap + 1;
  L.off = jpos + TJ;                                              // [TJ][ostride]
  L.act = reinterpret_cast<float*>(L.off + (size_t)TJ * L.ostride);  // [TJ][astride]
  L.idx = reinterpret_cast<int*>(L.act + (size_t)TJ * L.astride);  // [TJ][istride]
  unsigned* ogrp = reinterpret_cast<unsigned*>(L.idx + TJ * L.istride);  // [chunk / 32]
  L.resume = reinterpret_cast<int*>(ogrp + chunk / 32);
  L.len = L.resume + TJ;
  L.count = L.len + TJ;
  int* jvalid = L.count + TJ;
  float* sw1 = reinterpret_cast<float*>(jvalid + TJ);  // [3][H]
  float* sb1 = sw1 + 3 * H;                            // [H]
  float* red = sb1 + H;                                // [warps][4 * H]

  const int b = blockIdx.y;
  const int j0 = blockIdx.x * TJ;
  const int nj = min(TJ, N - j0);
  const int CS = kCpt * TPS;

  for (int t = threadIdx.x; t < TJ; t += blockDim.x) {
    float x = 0.f, y = 0.f, z = 0.f;
    int v = 0;
    if (t < nj) {
      const size_t k = (size_t)b * N + j0 + t;
      x = src[3 * k];
      y = src[3 * k + 1];
      z = src[3 * k + 2];
      v = srcmask[k] != 0;
    }
    jpos[t] = make_float4(x, y, z, sq_norm_rn(x, y, z));
    jvalid[t] = v;
    L.count[t] = 0;
  }
  for (int t = threadIdx.x; t < 3 * H; t += blockDim.x) sw1[t] = w1[t];
  for (int t = threadIdx.x; t < H; t += blockDim.x) sb1[t] = b1[t];

  // This thread's outputs in a pass: source s, channels c0 + cl + k * TPS.
  const int s = threadIdx.x / TPS, cl = threadIdx.x % TPS;
  const bool owner = s < nj;
  float gw[4][H];  // this thread's share of dW1[0..2][h] and db1[h], over every pass
#pragma unroll
  for (int k = 0; k < 4; ++k)
#pragma unroll
    for (int h = 0; h < H; ++h) gw[k][h] = 0.f;
  const bool any = __syncthreads_or(threadIdx.x < nj && srcmask[(size_t)b * N + j0 + threadIdx.x]);
  bool reuse = false;  // the lists hold every in-radius pair of the tile
  for (int pass = 0; pass < passes; ++pass) {
    const int c0 = (blockIdx.z * passes + pass) * CS, cend = min(C, c0 + CS);
    int ch[kCpt];
    bool cv[kCpt];
    float f[kCpt], acc[kCpt];
#pragma unroll
    for (int k = 0; k < kCpt; ++k) {
      ch[k] = c0 + cl + k * TPS;
      cv[k] = owner && ch[k] < cend;
      f[k] = cv[k] ? wf[((size_t)b * N + j0 + s) * C + ch[k]] : 0.f;
      acc[k] = 0.f;
    }

    if (any) {  // else a tile of padding: zero rows, a zero partial
      int rounds = 0;
      for (int o0 = 0; o0 < M; o0 += chunk) {
        const int n = min(chunk, M - o0);
        if (!reuse) {
          __syncthreads();  // the previous chunk's lists are consumed
          stage_others(smp, smask, b, M, o0, n, opos, ogrp);
          for (int t = threadIdx.x; t < TJ; t += blockDim.x) L.resume[t] = 0;
          __syncthreads();
        }
        bool more = false;
        do {
          if (!reuse)
            more = __syncthreads_or(sweep_round<false>(jpos, jvalid, nj, opos, ogrp,
                                                       (n + 31) >> 5, o0, sw1, sb1, r2, radius,
                                                       L));
          // This thread's source's listed samples, in increasing i: d_f~ into
          // acc, this thread's share of dW1 / db1 into gw.
          if (owner) {
            const int ne = L.len[s];
            const int* li = L.idx + s * L.istride;
            const float* la = L.act + (size_t)s * L.astride;
            const float4* lo = L.off + s * L.ostride;
            for (int e = 0; e < ne; ++e) {
              const float4 a0 = *reinterpret_cast<const float4*>(la + 8 * e);
              const float4 a1 = *reinterpret_cast<const float4*>(la + 8 * e + 4);
              const float a[H] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
              float gv[kCpt][H1];
              if constexpr (kDepthwise) {
                const float* trow = dG + ((size_t)b * M + li[e]) * C;
#pragma unroll
                for (int k = 0; k < kCpt; ++k) {
                  const float tv = cv[k] ? __ldg(trow + ch[k]) : 0.f;
#pragma unroll
                  for (int h = 0; h < H; ++h)
                    gv[k][h] = cv[k] ? __fmul_rn(tv, __ldg(w2 + h * C + ch[k])) : 0.f;
                  gv[k][H] = cv[k] ? __fmul_rn(tv, __ldg(b2 + ch[k])) : 0.f;
                }
              } else {
                const float* g = dG + ((size_t)b * M + li[e]) * H1 * C;
#pragma unroll
                for (int k = 0; k < kCpt; ++k)
#pragma unroll
                  for (int h = 0; h < H1; ++h)
                    gv[k][h] = cv[k] ? __ldg(g + (size_t)h * C + ch[k]) : 0.f;
              }
              float d[H];
#pragma unroll
              for (int h = 0; h < H; ++h) d[h] = 0.f;
#pragma unroll
              for (int k = 0; k < kCpt; ++k) {
#pragma unroll
                for (int h = 0; h < H; ++h) {
                  acc[k] = __fmaf_rn(a[h], gv[k][h], acc[k]);
                  d[h] = __fmaf_rn(gv[k][h], f[k], d[h]);
                }
                acc[k] = __fadd_rn(acc[k], gv[k][H]);  // a_H = 1
              }
              const float4 o = lo[e];
#pragma unroll
              for (int h = 0; h < H; ++h) {
                const float dh = a[h] > 0.f ? d[h] : 0.f;
                gw[0][h] = __fmaf_rn(dh, o.x, gw[0][h]);
                gw[1][h] = __fmaf_rn(dh, o.y, gw[1][h]);
                gw[2][h] = __fmaf_rn(dh, o.z, gw[2][h]);
                gw[3][h] = __fadd_rn(gw[3][h], dh);
              }
            }
          }
          if (!reuse) __syncthreads();  // the lists are consumed before the next round
          ++rounds;
        } while (more);
      }
      reuse = rounds == 1;  // one chunk, one round: the next pass walks these lists
    }
#pragma unroll
    for (int k = 0; k < kCpt; ++k)
      if (cv[k]) dwf[((size_t)b * N + j0 + s) * C + ch[k]] = acc[k];
  }

  // One partial of dW1 / db1 a block: warp trees, then the warps in order.
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, nw = blockDim.x >> 5;
#pragma unroll
  for (int k = 0; k < 4; ++k)
#pragma unroll
    for (int h = 0; h < H; ++h) {
      float v = gw[k][h];
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(kFull, v, off);
      if (lane == 0) red[warp * 4 * H + k * H + h] = v;
    }
  __syncthreads();
  if (threadIdx.x < 4 * H) {
    float v = 0.f;
    for (int w = 0; w < nw; ++w) v += red[w * 4 * H + threadIdx.x];
    const size_t blk = ((size_t)b * gridDim.x + blockIdx.x) * gridDim.z + blockIdx.z;
    part[blk * 4 * H + threadIdx.x] = v;
  }
}

Plan bwd_plan(int B, int N, int M, int C) {
  return make_plan(B, N, M, C, false, kListBudget, 32);
}

size_t pair_smem(const Plan& p) {
  const size_t TJ = p.owners, cap = p.cap;
  return sizeof(float4) * ((size_t)p.chunk + TJ + TJ * (cap + 1)) +
         sizeof(float) * TJ * (8 * cap + 4) + sizeof(int) * TJ * (cap + 1) +
         sizeof(unsigned) * (p.chunk / 32) + sizeof(int) * 4 * TJ +
         sizeof(float) * (4 * kHidden + (p.threads / 32) * 4 * kHidden);
}

}  // namespace

// Partial rows of dW1 / db1 the pair kernel writes for a batch (the caller
// sizes the buffer as that many times 4 * H floats), or 0 if the shape is
// refused.
extern "C" int mcconv_bwd_pair_blocks(int B, int N, int M, int C) {
  if (B < 1 || C < 1 || C > kMaxC || N < 1 || M < 1) return 0;
  const Plan p = bwd_plan(B, N, M, C);
  return B * p.tiles * p.slices;
}

template <bool kDepthwise>
int launch_bwd_pair(const Plan& p, cudaStream_t stream, const void* smp, const void* smask,
                    const void* src, const void* srcmask, const void* wf, const void* w1,
                    const void* b1, const void* w2, const void* b2, const void* dG, int B,
                    int M, int N, int C, float r2, float radius, void* dwf, void* part) {
  const size_t smem = pair_smem(p);
  cudaError_t err = cudaFuncSetAttribute(mcconv_bwd_pair_kernel<kDepthwise>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(p.tiles, B, p.slices);
  mcconv_bwd_pair_kernel<kDepthwise><<<grid, p.threads, smem, stream>>>(
      static_cast<const float*>(smp), static_cast<const uint8_t*>(smask),
      static_cast<const float*>(src), static_cast<const uint8_t*>(srcmask),
      static_cast<const float*>(wf), static_cast<const float*>(w1),
      static_cast<const float*>(b1), static_cast<const float*>(w2),
      static_cast<const float*>(b2), static_cast<const float*>(dG), M, N, C, p.owners, p.tps,
      p.passes, p.chunk, p.cap, r2, radius, static_cast<float*>(dwf), static_cast<float*>(part));
  MCCNN_LAUNCH_RETURN();
}

// With depthwise, dG is t (B, M, C) and the kernel forms dG's values from w2
// (H, C) and b2 (C); else dG is (B, M, H+1, C) and w2 / b2 are not read.
extern "C" int mcconv_bwd_pair_launch(const void* smp, const void* smask, const void* src,
                                      const void* srcmask, const void* wf, const void* w1,
                                      const void* b1, const void* w2, const void* b2,
                                      const void* dG, int B, int M, int N, int C, int H,
                                      int depthwise, float r2, float radius, void* dwf,
                                      void* part, void* stream) {
  if (H != kHidden || C < 1 || C > kMaxC || M < 1 || N < 1 || B < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const Plan p = bwd_plan(B, N, M, C);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  return depthwise ? launch_bwd_pair<true>(p, st, smp, smask, src, srcmask, wf, w1, b1, w2, b2,
                                           dG, B, M, N, C, r2, radius, dwf, part)
                   : launch_bwd_pair<false>(p, st, smp, smask, src, srcmask, wf, w1, b1, w2,
                                            b2, dG, B, M, N, C, r2, radius, dwf, part);
}

// Splits of the dG GEMM's o range for an R x NC output over CO (the caller
// sizes the partials as splits * R * NC floats where splits > 1).
extern "C" int mcconv_bwd_dg_splits(int R, int CO, int NC) {
  int kchunk;
  return split_k(div_up(NC, kBN) * div_up(R, kBM), CO, &kchunk);
}

extern "C" int mcconv_bwd_dg_full_launch(const void* t, const void* w2, const void* b2,
                                         int R, int CO, int KW, int NC, void* part, void* dG,
                                         void* stream) {
  int kchunk;
  const int splits = split_k(div_up(NC, kBN) * div_up(R, kBM), CO, &kchunk);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  dim3 grid(div_up(NC, kBN), div_up(R, kBM), splits);
  mcconv_bwd_dg_full_kernel<<<grid, kThreads, 0, st>>>(
      static_cast<const float*>(t), static_cast<const float*>(w2),
      static_cast<const float*>(b2), R, CO, KW, NC, kchunk, static_cast<float*>(dG),
      static_cast<float*>(part));
  if (splits > 1) {
    const size_t L = (size_t)R * NC;
    mcconv_bwd_reduce_kernel<<<(unsigned)((L + kThreads - 1) / kThreads), kThreads, 0, st>>>(
        static_cast<const float*>(part), splits, (int)L, static_cast<float*>(dG));
  }
  MCCNN_LAUNCH_RETURN();
}

extern "C" int mcconv_bwd_dw2_full_launch(const void* G, const void* t, int R, int MA,
                                          int CO, int splits, int rchunk, void* part,
                                          void* stream) {
  dim3 grid((CO + kBN - 1) / kBN, (MA + kBM - 1) / kBM, splits);
  mcconv_bwd_dw2_full_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(G), static_cast<const float*>(t), R, MA, CO, rchunk,
      static_cast<float*>(part));
  MCCNN_LAUNCH_RETURN();
}

extern "C" int mcconv_bwd_dw2_depthwise_launch(const void* G, const void* t, int R, int H1,
                                               int C, int splits, int rchunk, void* part,
                                               void* stream) {
  dim3 grid((H1 * C + kThreads - 1) / kThreads, splits);
  mcconv_bwd_dw2_depthwise_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(G), static_cast<const float*>(t), R, H1, C, rchunk,
      static_cast<float*>(part));
  MCCNN_LAUNCH_RETURN();
}

extern "C" int mcconv_bwd_reduce_launch(const void* part, int Z, int L, void* out,
                                        void* stream) {
  const unsigned blocks = (unsigned)((L + kThreads - 1) / kThreads);
  mcconv_bwd_reduce_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(part), Z, L, static_cast<float*>(out));
  MCCNN_LAUNCH_RETURN();
}
