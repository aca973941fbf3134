// The body of K6 and K10 (tile_conv_bwd.cuh, bucket_conv_bwd.cu): the
// Monte-Carlo convolution's backward over in-radius pair lists of a block's
// sources.
//
// With t = s * dout (the cotangent of the projection) and dG[i,h,c] = sum_o
// t[i,o] Wcat[h,c,o], for every valid pair (sample i, source j) that the
// kernel's walk hands a block and with d2(i, j) <= r2:
//
//   X[j,h,o]    = sum_i a_h(i,j) t[i,o]                 (a_H = 1)
//   dpre_h(i,j) = [pre_h(i,j) > 0] sum_c dG[i,h,c] f~[j,c]
//   dW1[k,h]    = sum dpre_h (p_j - x_i)_k / r,   db1[h] = sum dpre_h
//
// and from X: d_f~[j,c] = sum_{h,o} X[j,h,o] Wcat[h,c,o] and dWcat[h,c,o] =
// sum_j f~[j,c] X[j,h,o]. Depthwise sites (o = c) project X here; the full
// site writes X and K2's GEMMs (dense_conv_bwd.cu) form d_f~ and dWcat.
//
// A block owns up to 32 sources of one cloud ("owners"). The kernel's walk
// (`Walk::stage`) stages the candidate samples in chunks of up to 1024, in
// the order the old schedules summed them (K6: a source tile's run of steps,
// each step's sample minors in order; K10: the 27-cell window's kept samples
// in window order), with each sample's row. The block sweeps each chunk once
// (dense_pairs.cuh `sweep_append`): one d2 test per candidate pair, and each
// owner's in-radius valid samples appended to its list with their offsets,
// a_h and row. The lists grow across chunks until one fills (`cap`); then,
// and once at the end, the block contracts what they hold:
//   - a thread holds 4 channels of one source, strided by `tps` threads, so a
//     pass covers 4 * tps channels; `passes` runs of channels cover the
//     block's (all max(C, KU) of them, or a slice where the grid would not
//     fill the card). X[j, 0..H, c] of those channels stays in 9 registers a
//     channel: per listed sample one FFMA a_h * t[i,c] each, t's row read
//     from L2 for the thread's channels, in staging order. So every X value
//     is the chain of the old all-candidate kernels minus their exact zeros
//     (an out-of-radius or invalid pair's plane was 0), bit for bit;
//   - per listed sample and h with a_h > 0, the thread's share of dG[i,h,:] .
//     f~[j,:] over its channels (depthwise, t[i,c] times W2[h,c] f~[j,c],
//     which the pass keeps in registers; a full dG is read from K2's dG
//     GEMM) times (o_x, o_y, o_z, 1) into 32 register sums of dW1 / db1;
//   - with one pass the X registers carry over from one contraction to the
//     next; with several, each pass saves its X between contractions (into X
//     itself at the full site, into the scratch `xs` at depthwise sites) and
//     reads it back, so the FMA chains run on unbroken;
//   - at the end each pass writes d_f~ = sum_h X W2 + X_H b2 (the old
//     epilogue's FMA order) or X, and, depthwise, one partial of [dW2; db2]
//     a block: f~ X summed over the block's sources in index order.
// The dW1 / db1 sums are reduced over the block in a fixed order (warp
// shuffles, then warps in order) into one partial a block. The caller's
// reduction sums the partials in block order: no float atomics, two calls are
// bit-identical.
//
// The bwd_noop probe (kNoop) keeps the staging and the sweep alone (the lists
// only count) and writes 0 x the in-radius pairs an owner met as each of its
// outputs and 0 x the block's as its partials.
#pragma once

#include "dense_pairs.cuh"

namespace list_bwd {

using dense_pairs::Lists;
using dense_pairs::kCpt;
using dense_pairs::kFull;
using dense_pairs::kHidden;

constexpr int kThreads = 256;
constexpr int kChunk = dense_pairs::kChunk;  // candidates staged at once
constexpr int kMaxOwners = dense_pairs::kMaxOwners;
constexpr int kListBudget = 1024;  // list entries a block (52 bytes each)
// bytes of a block's lists: owners x (cap + 1) offsets (16 bytes), (8 cap + 4)
// activations and (cap + 1) rows, at owners x cap <= kListBudget
constexpr size_t kListBytes = 52 * (size_t)kListBudget + 36 * (size_t)kMaxOwners;

// The cap of n <= kMaxOwners owners' lists: each one's share of the budget
// (at least 32, a ballot's hits), at most 256.
__host__ __device__ inline int list_cap(int n) {
  return kListBudget / n < 256 ? kListBudget / n : 256;
}

struct Args {
  const float* wf;  // (B, NP, C) f~, by source row
  const float* dg;  // (B, rows, H+1, C) dG of the full conv by sample row (unread when depthwise)
  const float* w1;
  const float* b1;
  const float* w2;
  const float* b2;
  int NP, rows, C, KU;
  float r2, radius;
  float* out;     // d_f~ (B, NP, C) when depthwise, else X (B, NP, H+1, KU)
  float* xs;      // depthwise X between contractions of a block of several passes: (B, NP, H+1, C)
  float* w1part;  // [blocks][4][H] partials of [dW1; db1]
  float* w2part;  // [partial rows][H+1][C] partials of [dW2; db2] (depthwise)
};

// The body's shared memory, carved from `base` (`smem_bytes() + extra`
// bytes): the walk's own `extra` bytes come last.
struct Smem {
  float4* opos;    // [kChunk] staged candidates (x, y, z, |p|^2); the epilogue's reduction buffer
  float4* jpos;    // [kMaxOwners] the owners
  char* lists;     // [kListBytes]
  unsigned* ogrp;  // [kChunk / 32] validity words
  int* orow;       // [kChunk] the staged candidates' rows
  int* jvalid;     // [kMaxOwners]
  int* jrow;       // [kMaxOwners] the owners' rows in their cloud
  int* resume;     // [kMaxOwners]
  int* len;        // [kMaxOwners]
  int* count;      // [kMaxOwners]
  float* sw1;      // [3][H]
  float* sb1;      // [H]
  float* red;      // [warps][4 * H]
  char* extra;
};

__host__ __device__ constexpr size_t smem_bytes() {
  return 16 * (size_t)kChunk + 16 * (size_t)kMaxOwners + kListBytes + 4 * (size_t)(kChunk / 32) +
         4 * (size_t)kChunk + 4 * 5 * (size_t)kMaxOwners +
         4 * (size_t)(4 * kHidden + (kThreads / 32) * 4 * kHidden);
}

__device__ __forceinline__ Smem carve(char* base) {
  Smem S;
  S.opos = reinterpret_cast<float4*>(base);
  S.jpos = S.opos + kChunk;
  S.lists = reinterpret_cast<char*>(S.jpos + kMaxOwners);
  S.ogrp = reinterpret_cast<unsigned*>(S.lists + kListBytes);
  S.orow = reinterpret_cast<int*>(S.ogrp + kChunk / 32);
  S.jvalid = S.orow + kChunk;
  S.jrow = S.jvalid + kMaxOwners;
  S.resume = S.jrow + kMaxOwners;
  S.len = S.resume + kMaxOwners;
  S.count = S.len + kMaxOwners;
  S.sw1 = reinterpret_cast<float*>(S.count + kMaxOwners);
  S.sb1 = S.sw1 + 3 * kHidden;
  S.red = S.sb1 + kHidden;
  S.extra = reinterpret_cast<char*>(S.red + (kThreads / 32) * 4 * kHidden);
  return S;
}

// The block's lists for n owners of `cap` entries each, with strides padded
// so that the owners a warp reads at once fall in different banks.
__device__ __forceinline__ Lists lists_of(const Smem& S, int n, int cap) {
  Lists L;
  L.cap = cap;
  L.ostride = cap + 1;
  L.astride = 8 * cap + 4;
  L.istride = cap + 1;
  L.off = reinterpret_cast<float4*>(S.lists);
  L.act = reinterpret_cast<float*>(L.off + (size_t)n * L.ostride);
  L.idx = reinterpret_cast<int*>(L.act + (size_t)n * L.astride);
  L.resume = S.resume;
  L.len = S.len;
  L.count = S.count;
  return L;
}

// The backward of one block of cloud b: n_own owners staged at S.jpos /
// S.jvalid / S.jrow (rows of cloud b, visible to every thread), `cap` entries
// a list, `tps` threads an owner, `passes` passes of 4 * tps channels over
// the channels [cbeg, cend) of max(C, KU). The walk stages the candidates:
// `walk.stage(S)` returns how many it staged into S.opos / S.ogrp / S.orow (0
// when done), and `walk.row(q)` points at t's row of sample row q. The dW1 /
// db1 partial goes to row w1row of a.w1part, the [dW2; db2] partial
// (depthwise) to row w2row of a.w2part. Every thread of the block calls it.
template <bool kDepthwise, bool kNoop, class Walk>
__device__ __forceinline__ void owner_backward(const Args& a, Walk& walk, const Smem& S, int b,
                                               int n_own, int cap, int tps, int passes, int cbeg,
                                               int cend, size_t w1row, size_t w2row) {
  constexpr int H = kHidden, H1 = kHidden + 1;
  const int C = a.C, KU = a.KU, CS = kCpt * tps;
  const int xw = kDepthwise ? C : KU;  // X's row width
  float* xsave = kDepthwise ? a.xs : a.out;
  const Lists L = lists_of(S, n_own, cap);
  for (int t = threadIdx.x; t < n_own; t += blockDim.x) {
    L.len[t] = 0;
    L.count[t] = 0;
  }
  for (int t = threadIdx.x; t < 3 * H; t += blockDim.x) S.sw1[t] = a.w1[t];
  for (int t = threadIdx.x; t < H; t += blockDim.x) S.sb1[t] = a.b1[t];
  const bool any = __syncthreads_or(threadIdx.x < n_own && S.jvalid[threadIdx.x]);

  // This thread's outputs: owner s, channels c0 + cl + k * tps of each pass.
  const int s = threadIdx.x / tps, cl = threadIdx.x % tps;
  const bool owner = s < n_own;
  const size_t jrow = owner ? (size_t)b * a.NP + S.jrow[s] : 0;
  float acc[kCpt][H1];  // X of the pass
#pragma unroll
  for (int k = 0; k < kCpt; ++k)
#pragma unroll
    for (int h = 0; h < H1; ++h) acc[k][h] = 0.f;
  float gw[4][H];  // this thread's share of dW1[0..2][h] and db1[h]
#pragma unroll
  for (int k = 0; k < 4; ++k)
#pragma unroll
    for (int h = 0; h < H; ++h) gw[k][h] = 0.f;

  const dense_pairs::RowForm form{S.sw1, S.sb1, S.orow, a.radius};
  bool done = !any, staged = false, first = true;
  int n = 0;
  for (;;) {
    // Sweep until a list fills or the walk ends.
    while (!done) {
      if (!staged) {
        n = walk.stage(S);
        if (n == 0) {
          done = true;
          break;
        }
        for (int t = threadIdx.x; t < n_own; t += blockDim.x) L.resume[t] = 0;
        __syncthreads();
        staged = true;
      }
      const bool more =
          kNoop ? __syncthreads_or(dense_pairs::sweep_append(S.jpos, S.jvalid, n_own, S.opos,
                                                             S.ogrp, (n + 31) >> 5, a.r2, L,
                                                             dense_pairs::CountForm{}))
                : __syncthreads_or(dense_pairs::sweep_append(S.jpos, S.jvalid, n_own, S.opos,
                                                             S.ogrp, (n + 31) >> 5, a.r2, L,
                                                             form));
      if (more) break;  // a list is full: contract, then resume this chunk
      staged = false;
    }
    const bool final = done;
    if (!kNoop || final) {
      for (int pass = 0; pass < passes; ++pass) {
        const int c0 = cbeg + pass * CS, cb = c0 + cl;  // channel k: cb + k * tps
        // a channel of X below xe, of f~ below de
        const int xe = owner ? min(cend, KU) : 0, de = owner ? min(cend, C) : 0;
        // depthwise: W2[h, c] f~[j, c] of the pass; full: f~[j, c]
        float wfv[kCpt][kDepthwise ? H : 1];
#pragma unroll
        for (int k = 0; k < kCpt; ++k) {
          const int c = cb + k * tps;
          const float f = c < de ? a.wf[jrow * C + c] : 0.f;
#pragma unroll
          for (int h = 0; h < (kDepthwise ? H : 1); ++h)
            wfv[k][h] = kDepthwise ? (c < de ? __fmul_rn(__ldg(a.w2 + h * C + c), f) : 0.f) : f;
        }
        if (passes > 1 && !kNoop) {  // this pass's X so far
#pragma unroll
          for (int k = 0; k < kCpt; ++k)
#pragma unroll
            for (int h = 0; h < H1; ++h)
              acc[k][h] = !first && cb + k * tps < xe
                              ? xsave[(jrow * H1 + h) * xw + cb + k * tps]
                              : 0.f;
        }
        if (kNoop) {
          const float zero = owner ? 0.f * (float)L.count[s] : 0.f;
#pragma unroll
          for (int k = 0; k < kCpt; ++k)
#pragma unroll
            for (int h = 0; h < H1; ++h) acc[k][h] = zero;
#pragma unroll
          for (int k = 0; k < 4; ++k)
#pragma unroll
            for (int h = 0; h < H; ++h) gw[k][h] = zero;
        } else if (owner) {
          const bool dpre = c0 < C;  // this pass holds channels of f~
          const int ne = L.len[s];
          const int* li = L.idx + s * L.istride;
          const float* la = L.act + (size_t)s * L.astride;
          const float4* lo = L.off + s * L.ostride;
          for (int e = 0; e < ne; ++e) {
            const float4 a0 = *reinterpret_cast<const float4*>(la + 8 * e);
            const float4 a1 = *reinterpret_cast<const float4*>(la + 8 * e + 4);
            const float av[H] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
            const int q = li[e];
            const float* tr = walk.row(q) + cb;
            float tv[kCpt];
#pragma unroll
            for (int k = 0; k < kCpt; ++k) tv[k] = cb + k * tps < xe ? __ldg(tr + k * tps) : 0.f;
#pragma unroll
            for (int k = 0; k < kCpt; ++k) {
#pragma unroll
              for (int h = 0; h < H; ++h) acc[k][h] = __fmaf_rn(av[h], tv[k], acc[k][h]);
              acc[k][H] = __fadd_rn(acc[k][H], tv[k]);  // a_H = 1
            }
            if (dpre) {
              const float* gr =
                  kDepthwise ? nullptr : a.dg + ((size_t)b * a.rows + q) * H1 * C + cb;
              const float4 o = lo[e];
#pragma unroll
              for (int h = 0; h < H; ++h) {
                float d = 0.f;
#pragma unroll
                for (int k = 0; k < kCpt; ++k) {
                  if constexpr (kDepthwise)
                    d = __fmaf_rn(tv[k], wfv[k][h], d);
                  else
                    d = __fmaf_rn(cb + k * tps < de ? __ldg(gr + (size_t)h * C + k * tps) : 0.f,
                                  wfv[k][0], d);
                }
                const float dh = av[h] > 0.f ? d : 0.f;
                gw[0][h] = __fmaf_rn(dh, o.x, gw[0][h]);
                gw[1][h] = __fmaf_rn(dh, o.y, gw[1][h]);
                gw[2][h] = __fmaf_rn(dh, o.z, gw[2][h]);
                gw[3][h] = __fadd_rn(gw[3][h], dh);
              }
            }
          }
        }
        if (!final) {
          if (passes > 1) {
#pragma unroll
            for (int k = 0; k < kCpt; ++k)
              if (cb + k * tps < xe)
#pragma unroll
                for (int h = 0; h < H1; ++h)
                  xsave[(jrow * H1 + h) * xw + cb + k * tps] = acc[k][h];
          }
          continue;
        }
        // The pass's outputs.
        if (kDepthwise) {
#pragma unroll
          for (int k = 0; k < kCpt; ++k) {
            const int c = cb + k * tps;
            if (c >= xe) continue;
            float o = 0.f;
#pragma unroll
            for (int h = 0; h < H; ++h) o = __fmaf_rn(acc[k][h], __ldg(a.w2 + h * C + c), o);
            o = __fmaf_rn(acc[k][H], __ldg(a.b2 + c), o);
            a.out[jrow * C + c] = o;
          }
          // [dW2; db2] of the pass's channels: f~ X summed over the owners in
          // order, one h at a time through the staging buffer (free now)
          float* red = reinterpret_cast<float*>(S.opos);  // [n_own][CS]
          const int cl_end = min(CS, min(cend, C) - c0);
          float f[kCpt];
#pragma unroll
          for (int k = 0; k < kCpt; ++k)
            f[k] = cb + k * tps < de ? a.wf[jrow * C + cb + k * tps] : 0.f;
          for (int h = 0; h < H1; ++h) {
            __syncthreads();
            if (owner)
#pragma unroll
              for (int k = 0; k < kCpt; ++k)
                red[s * CS + cl + k * tps] = __fmul_rn(f[k], acc[k][h]);
            __syncthreads();
            for (int i = threadIdx.x; i < cl_end; i += blockDim.x) {
              float v = 0.f;
              for (int j = 0; j < n_own; ++j) v = __fadd_rn(v, red[j * CS + i]);
              a.w2part[(w2row * H1 + h) * C + c0 + i] = v;
            }
          }
        } else {
#pragma unroll
          for (int k = 0; k < kCpt; ++k)
            if (cb + k * tps < xe)
#pragma unroll
              for (int h = 0; h < H1; ++h)
                a.out[(jrow * H1 + h) * KU + cb + k * tps] = acc[k][h];
        }
      }
    }
    if (final) break;
    __syncthreads();  // every thread has read the lists
    for (int t = threadIdx.x; t < n_own; t += blockDim.x) L.len[t] = 0;
    __syncthreads();
    first = false;
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
      if (lane == 0) S.red[warp * 4 * H + k * H + h] = v;
    }
  __syncthreads();
  if (threadIdx.x < 4 * H) {
    float v = 0.f;
    for (int w = 0; w < nw; ++w) v += S.red[w * 4 * H + threadIdx.x];
    a.w1part[w1row * 4 * H + threadIdx.x] = v;
  }
}

}  // namespace list_bwd
