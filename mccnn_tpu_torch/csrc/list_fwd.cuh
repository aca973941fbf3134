// The body of K5 and K9 (tile_conv.cuh, bucket_conv.cu): the Monte-Carlo
// convolution's forward over in-radius pair lists of a block's samples.
//
// For every valid pair (sample i, source j) that the kernel's walk hands a
// block and with d2(i, j) <= r2:
//
//   G[i,h,c] = sum_j a_h(i,j) f~[j,c]   (a_h = relu(pre_h), h < H; a_H = 1)
//   cnt[i]   = the number of such j
//
// then out = sum_h G[i,h,c] W2[h,c] + G[i,H,c] b2[c] (depthwise, here) or G
// (the full conv: K1's projection GEMM follows), times 1/cnt in mean mode
// and 0 for an invalid sample.
//
// A block owns up to 32 samples of one cloud ("owners"). The kernel's walk
// (`Walk::stage`) stages the candidate sources in chunks of up to 1024, in
// the order the old all-candidate kernels summed them (K5: a sample tile's
// run of steps, each step's source minors in order, rows in order; K9: the
// 27-cell window's kept sources in window order), with each source's row of
// f~. The block sweeps each chunk once (dense_pairs.cuh `sweep_append`): one
// d2 test a candidate pair (`pair_d2_rn`), and each owner's in-radius valid
// sources appended to its list with their 8 a_h (`mc_offset` /
// `mc_preact`, as every kernel of the port forms them) and row. The lists
// grow across chunks until one fills (`cap`); then, and once at the end, the
// block contracts what they hold:
//   - a thread holds 4 channels of one sample, strided by `tps` threads, for
//     all H+1 rows (36 registers); per listed source it reads the 8 a_h once
//     from shared memory and f~'s values from L2, one FFMA a row and channel,
//     in staging order. So every G value is the FMA chain of the old kernels
//     minus their exact zeros (an out-of-radius or invalid pair's plane was
//     0), bit for bit;
//   - at C <= 4 of the full conv (the stems, C = 1) the rows are spread over
//     threads instead, one row of up to 4 channels a thread (288 threads: 32
//     samples x 9 rows), so that every thread of the block contracts;
//   - `passes` runs of 4 * tps channels cover the block's channels; a pass
//     after the first walks the first pass's lists again where those held
//     every in-radius pair (one contraction), and sweeps again where not, so
//     every output keeps one FMA chain in registers and no scratch is needed;
//   - the pass's epilogue writes out = sum_h G W2 + G_H b2 in the old kernels'
//     FMA order, scaled (depthwise), or G's rows (full); the count goes out
//     once a sample. Every row has one writer: no atomics, two calls are
//     bit-identical.
//
// The probes of K5 (kProbe; tile_conv.cuh says what each stands for):
//   - kProbeNoop: the staging and the sweep alone; the lists only count and
//     it writes 0 x the sample's count as its value;
//   - kProbePlanes: per listed pair the factored planes (cw_h - sw_h) + b1_h,
//     ReLU'd and summed over h, summed over the pairs as the sample's value;
//   - kProbeMm: the lists take every valid candidate (the radius test off for
//     this probe alone), each entry its raw d2 as every a_h and the radius
//     mask as a_H; K5's contraction and epilogue follow. The count is the
//     in-radius count, as every probe's.
#pragma once

#include <math.h>

#include "dense_pairs.cuh"

namespace list_fwd {

using dense_pairs::Lists;
using dense_pairs::kCpt;
using dense_pairs::kFull;
using dense_pairs::kHidden;

constexpr int kThreads = 256;     // 4 channels of one sample a thread, 9 rows
constexpr int kRowThreads = 288;  // rows spread: 32 samples x 9 rows
constexpr int kChunk = dense_pairs::kChunk;  // candidates staged at once
constexpr int kMaxOwners = dense_pairs::kMaxOwners;
constexpr int kListBudget = 2048;  // list entries a block (36 bytes each)
// bytes of a block's lists: owners x ((8 cap + 4) activations and (cap + 1)
// rows), at owners x cap <= kListBudget
constexpr size_t kListBytes = 36 * (size_t)kListBudget + 20 * (size_t)kMaxOwners;
constexpr int kProbeNone = 0, kProbeNoop = 1, kProbePlanes = 2, kProbeMm = 3;

// The cap of n <= kMaxOwners owners' lists: each one's share of the budget,
// at most 256.
__host__ __device__ inline int list_cap(int n) {
  return kListBudget / n < 256 ? kListBudget / n : 256;
}

struct Args {
  const float* w1;  // (3, H)
  const float* b1;  // (H,)
  const float* w2;  // (H, C) depthwise
  const float* b2;  // (C,) depthwise
  int C, rows;      // channels; output rows a cloud
  float r2, radius;
  int mean, depthwise;
  float* out;  // (B, rows, C) depthwise, else G (B, rows, H+1, C); noop / planes (B, rows)
  float* cnt;  // (B, rows)
};

// The body's shared memory, carved from `base` (`smem_bytes() + extra`
// bytes): the walk's own `extra` bytes come last.
struct Smem {
  float4* opos;    // [kChunk] staged candidates (x, y, z, |p|^2)
  float4* qpos;    // [kMaxOwners] the owners
  char* lists;     // [kListBytes]
  unsigned* ogrp;  // [kChunk / 32] validity words
  int* orow;       // [kChunk] the staged candidates' rows of f~
  int* qvalid;     // [kMaxOwners]
  int* qrow;       // [kMaxOwners] the owners' output rows in their cloud
  int* resume;     // [kMaxOwners]
  int* len;        // [kMaxOwners]
  int* count;      // [kMaxOwners] listed pairs
  int* miss;       // [kMaxOwners] listed pairs out of radius (the mm probe)
  float* sw1;      // [3][H]
  float* sb1;      // [H]
  char* extra;
};

__host__ __device__ constexpr size_t smem_bytes() {
  return 16 * (size_t)kChunk + 16 * (size_t)kMaxOwners + kListBytes + 4 * (size_t)(kChunk / 32) +
         4 * (size_t)kChunk + 4 * 6 * (size_t)kMaxOwners + 4 * (size_t)(4 * kHidden);
}

__device__ __forceinline__ Smem carve(char* base) {
  Smem S;
  S.opos = reinterpret_cast<float4*>(base);
  S.qpos = S.opos + kChunk;
  S.lists = reinterpret_cast<char*>(S.qpos + kMaxOwners);
  S.ogrp = reinterpret_cast<unsigned*>(S.lists + kListBytes);
  S.orow = reinterpret_cast<int*>(S.ogrp + kChunk / 32);
  S.qvalid = S.orow + kChunk;
  S.qrow = S.qvalid + kMaxOwners;
  S.resume = S.qrow + kMaxOwners;
  S.len = S.resume + kMaxOwners;
  S.count = S.len + kMaxOwners;
  S.miss = S.count + kMaxOwners;
  S.sw1 = reinterpret_cast<float*>(S.miss + kMaxOwners);
  S.sb1 = S.sw1 + 3 * kHidden;
  S.extra = reinterpret_cast<char*>(S.sb1 + kHidden);
  return S;
}

// The block's lists for n owners of `cap` entries each, with strides padded
// so that the owners a warp reads at once fall in different banks.
__device__ __forceinline__ Lists lists_of(const Smem& S, int n, int cap) {
  Lists L;
  L.cap = cap;
  L.astride = 8 * cap + 4;
  L.istride = cap + 1;
  L.ostride = 0;
  L.act = reinterpret_cast<float*>(S.lists);
  L.idx = reinterpret_cast<int*>(L.act + (size_t)n * L.astride);
  L.off = nullptr;
  L.resume = S.resume;
  L.len = S.len;
  L.count = S.count;
  return L;
}

// `sweep_append`'s entries of K5 and K9 (owner = sample q, staged other =
// source p): the 8 activations (the planes probe: their factored sum in
// slot 0; the mm probe: the raw d2 in every slot) and the source's row (the
// mm probe: ~row for a pair out of radius, counted in miss), one entry a
// lane.
template <int kProbe>
struct SampleForm {
  const float* w1;
  const float* b1;
  const int* orow;
  int* miss;
  float radius, r2;

  __device__ __forceinline__ void operator()(int s, float4 q, int* idx, int start, int len,
                                             const float4* opos, const Lists& L) const {
    int out = 0;
    for (int e = start + (threadIdx.x & 31); e < len; e += 32) {
      const int t = idx[e];
      const float4 p = opos[t];
      int row = orow[t];
      float a[kHidden];
      if constexpr (kProbe == kProbePlanes) {
        float sum = 0.f;
#pragma unroll
        for (int h = 0; h < kHidden; ++h) {
          const float pre =
              __fadd_rn(__fsub_rn(mc_w1_proj(p.x, p.y, p.z, w1, kHidden, h, radius),
                                  mc_w1_proj(q.x, q.y, q.z, w1, kHidden, h, radius)),
                        b1[h]);
          sum = __fadd_rn(sum, fmaxf(pre, 0.f));
        }
        a[0] = sum;
#pragma unroll
        for (int h = 1; h < kHidden; ++h) a[h] = 0.f;
      } else if constexpr (kProbe == kProbeMm) {
        const float d2 = pair_d2_rn(q.x, q.y, q.z, q.w, p.x, p.y, p.z, p.w);
#pragma unroll
        for (int h = 0; h < kHidden; ++h) a[h] = d2;
        if (!(d2 <= r2)) {
          row = ~row;
          ++out;
        }
      } else {
        const float ox = mc_offset(p.x, q.x, radius), oy = mc_offset(p.y, q.y, radius),
                    oz = mc_offset(p.z, q.z, radius);
#pragma unroll
        for (int h = 0; h < kHidden; ++h)
          a[h] = fmaxf(mc_preact(ox, oy, oz, w1, b1, kHidden, h), 0.f);
      }
      float4* dst = reinterpret_cast<float4*>(L.act + (size_t)s * L.astride + 8 * e);
      dst[0] = make_float4(a[0], a[1], a[2], a[3]);
      dst[1] = make_float4(a[4], a[5], a[6], a[7]);
      idx[e] = row;
    }
    if constexpr (kProbe == kProbeMm) {
      out = __reduce_add_sync(kFull, out);
      if ((threadIdx.x & 31) == 0) miss[s] += out;
    }
  }
};

// Owner s's listed pairs of this round, in list order, into acc (this
// thread's rows hg * HPT .., channels ch[k] where cv[k]) or, for the planes
// probe, into *val (the owner's `lead` thread).
template <int HPT, int kProbe, class Walk>
__device__ __forceinline__ void contract_lists(const Lists& L, const Walk& walk, int s, int hg,
                                               bool owner, bool lead, const int (&ch)[kCpt],
                                               const bool (&cv)[kCpt],
                                               float (&acc)[HPT][kCpt], float* val) {
  constexpr int H = kHidden, H1 = kHidden + 1;
  if (!owner) return;
  const int ne = L.len[s];
  const int* li = L.idx + s * L.istride;
  const float* la = L.act + (size_t)s * L.astride;
  if constexpr (kProbe == kProbePlanes) {
    if (lead)
      for (int e = 0; e < ne; ++e) *val = __fadd_rn(*val, la[8 * e]);
  } else if constexpr (kProbe == kProbeNone || kProbe == kProbeMm) {
#pragma unroll 4
    for (int e = 0; e < ne; ++e) {
      int row = li[e];
      float m = 1.f;  // a_H: 1, or the mm probe's radius mask
      if constexpr (kProbe == kProbeMm) {
        if (row < 0) {
          row = ~row;
          m = 0.f;
        }
      }
      const float* fr = walk.row(row);
      float f[kCpt];
#pragma unroll
      for (int k = 0; k < kCpt; ++k) f[k] = cv[k] ? __ldg(fr + ch[k]) : 0.f;
      if constexpr (HPT == H1) {
        const float4 a0 = *reinterpret_cast<const float4*>(la + 8 * e);
        const float4 a1 = *reinterpret_cast<const float4*>(la + 8 * e + 4);
        const float av[H] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
#pragma unroll
        for (int k = 0; k < kCpt; ++k) {
#pragma unroll
          for (int h = 0; h < H; ++h) acc[h][k] = __fmaf_rn(av[h], f[k], acc[h][k]);
          acc[H][k] = kProbe == kProbeMm ? __fmaf_rn(m, f[k], acc[H][k])
                                         : __fadd_rn(acc[H][k], f[k]);
        }
      } else {
        const float av = hg < H ? la[8 * e + hg] : m;
#pragma unroll
        for (int k = 0; k < kCpt; ++k) acc[0][k] = __fmaf_rn(av, f[k], acc[0][k]);
      }
    }
  }
}

// The forward of one block of cloud b: n_own owners staged at S.qpos /
// S.qvalid / S.qrow (visible to every thread once the body's first barrier
// has passed), `cap` entries a list, `tps` threads an owner and row group,
// `passes` passes of 4 * tps channels over the channels [cbeg, cend). HPT
// rows of G a thread: 9, or 1 (rows spread over 9 threads: the full conv at
// C <= 4, one pass). The walk stages the candidates: `walk.stage(S)` returns
// how many it staged into S.opos / S.ogrp / S.orow (0 when done),
// `walk.reset()` starts it over, and `walk.row(q)` points at f~'s row q.
// With `first_slice` the block writes its owners' counts and (noop, planes)
// values. Every thread of the block calls it.
template <int HPT, int kProbe, class Walk>
__device__ __forceinline__ void owner_forward(const Args& a, Walk& walk, const Smem& S, int b,
                                              int n_own, int cap, int tps, int passes, int cbeg,
                                              int cend, bool first_slice) {
  constexpr int H = kHidden, H1 = kHidden + 1, HG = H1 / HPT;
  constexpr bool kChannels = kProbe == kProbeNone || kProbe == kProbeMm;
  static_assert(HPT == H1 || HPT == 1, "9 rows a thread, or one");
  const int C = a.C, CS = kCpt * tps;
  const Lists L = lists_of(S, n_own, cap);
  for (int t = threadIdx.x; t < n_own; t += blockDim.x) {
    L.len[t] = 0;
    L.count[t] = 0;
    S.miss[t] = 0;
  }
  for (int t = threadIdx.x; t < 3 * H; t += blockDim.x) S.sw1[t] = a.w1[t];
  for (int t = threadIdx.x; t < H; t += blockDim.x) S.sb1[t] = a.b1[t];
  const bool any = __syncthreads_or(threadIdx.x < n_own && S.qvalid[threadIdx.x]);

  // This thread's outputs: owner s, rows hg * HPT .. + HPT, channels
  // c0 + cl + k * tps of each pass.
  const int per = HG * tps;
  const int s = threadIdx.x / per, hg = (threadIdx.x % per) / tps, cl = threadIdx.x % tps;
  const bool owner = s < n_own, lead = hg == 0 && cl == 0;
  const float r2 = kProbe == kProbeMm ? INFINITY : a.r2;  // the mm probe lists every valid pair
  const SampleForm<kProbe> form{S.sw1, S.sb1, S.orow, S.miss, a.radius, a.r2};
  const int npass = kChannels ? passes : 1;
  bool reuse = false;  // the lists hold every listed pair of the walk
  for (int pass = 0; pass < npass; ++pass) {
    const int c0 = cbeg + pass * CS, cb = c0 + cl;  // channel k: cb + k * tps
    int ch[kCpt];
    bool cv[kCpt];
#pragma unroll
    for (int k = 0; k < kCpt; ++k) {
      ch[k] = cb + k * tps;
      cv[k] = kChannels && owner && ch[k] < cend;
    }
    float acc[HPT][kCpt];
#pragma unroll
    for (int h = 0; h < HPT; ++h)
#pragma unroll
      for (int k = 0; k < kCpt; ++k) acc[h][k] = 0.f;
    float val = 0.f;  // the planes probe's sum

    if (any && reuse) {
      contract_lists<HPT, kProbe>(L, walk, s, hg, owner, lead, ch, cv, acc, &val);
    } else if (any) {
      // Sweep the walk into the lists, contracting whenever one fills.
      __syncthreads();  // the previous pass's readers of the lists are done
      walk.reset();
      for (int t = threadIdx.x; t < n_own; t += blockDim.x) {
        L.len[t] = 0;
        L.count[t] = 0;
        S.miss[t] = 0;
      }
      bool done = false, staged = false;
      int n = 0, rounds = 0;
      for (;;) {
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
          const int ng = (n + 31) >> 5;
          const bool more =
              kProbe == kProbeNoop
                  ? __syncthreads_or(dense_pairs::sweep_append(S.qpos, S.qvalid, n_own, S.opos,
                                                               S.ogrp, ng, r2, L,
                                                               dense_pairs::CountForm{}))
                  : __syncthreads_or(dense_pairs::sweep_append(S.qpos, S.qvalid, n_own, S.opos,
                                                               S.ogrp, ng, r2, L, form));
          if (more) break;  // a list is full: contract, then resume this chunk
          staged = false;
        }
        contract_lists<HPT, kProbe>(L, walk, s, hg, owner, lead, ch, cv, acc, &val);
        ++rounds;
        if (done) break;
        __syncthreads();  // every thread has read the lists
        for (int t = threadIdx.x; t < n_own; t += blockDim.x) L.len[t] = 0;
        __syncthreads();
      }
      reuse = rounds == 1;
    }

    // The pass's outputs.
    if (!owner) continue;
    const size_t r = (size_t)b * a.rows + S.qrow[s];
    const float cntf = (float)(L.count[s] - S.miss[s]);
    if constexpr (!kChannels) {
      if (first_slice && lead)
        a.out[r] = kProbe == kProbeNoop ? 0.f * cntf : val;
    } else if (a.depthwise) {
      if constexpr (HPT == H1) {
        const float scale = S.qvalid[s] ? (a.mean ? 1.f / fmaxf(cntf, 1.f) : 1.f) : 0.f;
#pragma unroll
        for (int k = 0; k < kCpt; ++k) {
          if (!cv[k]) continue;
          const int c = ch[k];
          float o = 0.f;
#pragma unroll
          for (int h = 0; h < H; ++h) o = __fmaf_rn(acc[h][k], __ldg(a.w2 + h * C + c), o);
          o = __fmaf_rn(acc[H][k], __ldg(a.b2 + c), o);
          a.out[r * C + c] = __fmul_rn(o, scale);
        }
      }
    } else {
#pragma unroll
      for (int h = 0; h < HPT; ++h)
#pragma unroll
        for (int k = 0; k < kCpt; ++k)
          if (cv[k]) a.out[(r * H1 + hg * HPT + h) * C + ch[k]] = acc[h][k];
    }
  }
  if (first_slice)
    for (int t = threadIdx.x; t < n_own; t += blockDim.x)
      a.cnt[(size_t)b * a.rows + S.qrow[t]] = (float)(L.count[t] - S.miss[t]);
}

}  // namespace list_fwd
