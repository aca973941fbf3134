// The in-radius pair lists of the MC conv's pair kernels: K1 and K1p
// (dense_conv_pair.cuh), K2 (dense_conv_bwd.cu), K1v1 (dense_conv_v1.cuh),
// K5 / K9, the tile and bucket forwards (list_fwd.cuh), and K6 / K10, their
// backwards (list_bwd.cuh).
//
// A block owns a few points of one cloud (K1, K5, K9: samples; K2, K6, K10:
// sources) and sweeps the other side of the pair in chunks staged in shared
// memory: the dense kernels a range of the cloud (`stage_others`), K5 / K6 a
// tile's run of minors and K9 / K10 a cell's 27-cell window (`stage_gather`,
// which also keeps each staged other's row). The sweep tests every pair with the
// exact d2 of `pair_d2_rn` and the two masks, nothing more. A warp takes one
// owner at a time and 32 others at a time: `__ballot_sync` marks the
// in-radius others and a prefix `__popc` gives each hit its slot in the
// owner's list. So a list holds the owner's in-radius others in staging
// order, and only those pairs ever cost more than a distance test. A group of
// 32 others with no valid point is skipped on its validity bits alone. Once
// an owner's list for the round is complete, the warp forms the listed pairs'
// offsets and 8 activations a_h = relu(pre_h), one entry a lane: no lane
// waits on another lane's hit, and dense lists keep every lane busy (K1p
// forms them on the tensor cores instead, 16 entries an MMA).
//
// A list holds `cap` entries (cap >= 32). A warp stops an owner's sweep
// before a group whose hits would not fit, and resumes there in the next
// round: a round is one sweep of every owner, a barrier, the kernel's
// contraction over the lists, a barrier. The contraction keeps its sums in
// registers across rounds, so every output still adds its terms in
// increasing index, whatever `cap` is.
// The dense kernels start every chunk's lists empty (`sweep_round`: an entry
// is the other's index in its cloud); K5, K6, K9 and K10 append a chunk's
// hits to the lists of the chunks before it until one fills (`sweep_append`:
// an entry is the other's row, so a list outlives its chunk's staging).

#pragma once

#include "common.cuh"

namespace dense_pairs {

constexpr int kHidden = 8;        // H, the kernel MLP's hidden width (KERNEL_HIDDEN)
constexpr int kThreads = 256;     // the largest block
constexpr int kChunk = 1024;      // others staged per chunk
constexpr int kMaxOwners = 32;    // owners per block
constexpr int kFillBlocks = 264;  // two blocks per SM of an H100: below it, split channels
constexpr unsigned kFull = 0xffffffffu;

// Stages n others into opos as (x, y, z, |p|^2), and one validity word per
// group of 32 into ogrp: fetch(t, &x, &y, &z) gives other t's position and
// returns whether it is valid. blockDim is a multiple of 32, so each warp's
// lanes fall in one group.
template <class Fetch>
__device__ __forceinline__ void stage_gather(int n, float4* opos, unsigned* ogrp,
                                             const Fetch& fetch) {
  const int npad = (n + 31) & ~31;
  for (int t = threadIdx.x; t < npad; t += blockDim.x) {
    bool v = false;
    if (t < n) {
      float x, y, z;
      v = fetch(t, &x, &y, &z);
      opos[t] = make_float4(x, y, z, sq_norm_rn(x, y, z));
    }
    const unsigned bal = __ballot_sync(kFull, v);
    if ((threadIdx.x & 31) == 0) ogrp[t >> 5] = bal;
  }
}

// The others [o0, o0 + n) of cloud b (N of them a cloud).
struct RangeFetch {
  const float* pts;
  const uint8_t* mask;
  size_t k0;
  __device__ __forceinline__ bool operator()(int t, float* x, float* y, float* z) const {
    const size_t k = k0 + t;
    *x = pts[3 * k];
    *y = pts[3 * k + 1];
    *z = pts[3 * k + 2];
    return mask[k] != 0;
  }
};

__device__ __forceinline__ void stage_others(const float* __restrict__ pts,
                                             const uint8_t* __restrict__ mask, int b, int N,
                                             int o0, int n, float4* opos, unsigned* ogrp) {
  stage_gather(n, opos, ogrp, RangeFetch{pts, mask, (size_t)b * N + o0});
}

// The next chunk of a tile walk (K5 over a sample tile's source minors, K6
// over a source tile's sample minors): the real minors of steps *k.. of
// cloud b's list j_ids (B, G, S), in order, into mids, at most mcap of them
// (a step's real minors come first; `sentinel` marks none). A step may span
// two chunks: *gpos counts its minors taken so far, *nreal < 0 means it is
// not read yet. Returns how many it took; the caller syncs before reading
// mids. Every thread of the block calls it.
__device__ __forceinline__ int step_minors(const int* __restrict__ j_ids, int b, int G, int S,
                                           int sentinel, int k1, int mcap, int* stepm,
                                           int* mids, int* k, int* gpos, int* nreal) {
  const int tid = threadIdx.x;
  int nm = 0;
  while (nm < mcap && *k < k1) {
    if (*nreal < 0) {
      __syncthreads();  // stepm's readers are done
      int m = sentinel;
      if (tid < G) {
        m = j_ids[((size_t)b * G + tid) * S + *k];
        stepm[tid] = m;
      }
      *nreal = __syncthreads_count(tid < G && m != sentinel);
      *gpos = 0;
    }
    const int take = min(*nreal - *gpos, mcap - nm);
    for (int i = tid; i < take; i += blockDim.x) mids[nm + i] = stepm[*gpos + i];
    nm += take;
    *gpos += take;
    if (*gpos >= *nreal) {
      ++*k;
      *nreal = -1;
    }
  }
  return nm;
}

// A cell's 27-cell window of kept points (K9: sources, K10: samples), staged
// a chunk at a time in window order (9 z-runs of 3 cells, slot order), each
// with its point index as its row; `row(q)` points at the payload's row of
// point q (f~ for K9, t for K10).
struct WindowWalk {
  const float* pos;      // the window side's slot positions
  const int* pts;        // its point_of_slot
  const float* payload;  // (B, rows, width) by point
  const int* wcell;
  const int* wstart;
  size_t slot0;  // the cloud's first slot
  size_t row0;   // the cloud's first payload row
  int width, cap, j0, total;

  __device__ void reset() { j0 = 0; }

  template <class Smem>
  __device__ int stage(const Smem& S) {
    __syncthreads();  // the previous chunk is consumed
    const int n = min(kChunk, total - j0);
    if (n <= 0) return 0;
    const WindowWalk& w = *this;
    int* orow = S.orow;
    stage_gather(n, S.opos, S.ogrp, [&](int t, float* x, float* y, float* z) {
      const size_t slot = w.slot0 + bucket_window_slot(w.wcell, w.wstart, w.j0 + t, w.cap);
      *x = w.pos[3 * slot];
      *y = w.pos[3 * slot + 1];
      *z = w.pos[3 * slot + 2];
      orow[t] = w.pts[slot];
      return true;
    });
    j0 += n;
    __syncthreads();
    return n;
  }

  __device__ __forceinline__ const float* row(int q) const {
    return payload + (row0 + q) * (size_t)width;
  }
};

// The pair lists of one block. Entry e of owner s: the other's index in its
// cloud at idx[s * istride + e], a_0..a_7 at act[s * astride + 8 e], and
// (with offsets) o_x, o_y, o_z at off[s * ostride + e]. The strides are padded
// so that the owners a warp reads at once fall in different banks.
struct Lists {
  int* idx;
  float* act;
  float4* off;
  int istride, astride, ostride, cap;
  int* resume;  // [owner]: the first group of the chunk not yet swept
  int* len;     // [owner]: this round's entries
  int* count;   // [owner]: in-radius pairs so far
};

// The in-radius test of owner q against lane's other of a group with
// validity word vm (sample first in d2, as every kernel orders it).
template <bool kOwnerIsSample>
__device__ __forceinline__ bool in_radius(float4 q, const float4* opos, unsigned vm, int t,
                                          int lane, float r2) {
  if (!((vm >> lane) & 1u)) return false;
  const float4 p = opos[t];
  const float d2 = kOwnerIsSample ? pair_d2_rn(q.x, q.y, q.z, q.w, p.x, p.y, p.z, p.w)
                                  : pair_d2_rn(p.x, p.y, p.z, p.w, q.x, q.y, q.z, q.w);
  return d2 <= r2;
}

// How a round's complete list of owner s (owner point q, `len` entries at
// idx, cloud indices, the staged chunk's first other at o0) gets its entries'
// activations: the warp's lanes form each entry's offsets and 8 activations
// a_h = relu(pre_h), one entry a lane, from the staged owner and chunk
// (`mc_offset` / `mc_preact`, bit for bit as every other kernel forms them);
// K2's lists (owner = source) keep the offsets too. K1p forms its entries
// on the tensor cores instead (csrc/dense_conv_pair.cuh, `PlanesForm`).
template <bool kOwnerIsSample>
struct OffsetForm {
  const float* w1;
  const float* b1;
  float radius;

  __device__ __forceinline__ void operator()(int s, float4 q, const int* idx, int len, int o0,
                                             const float4* opos, const Lists& L) const {
    for (int e = threadIdx.x & 31; e < len; e += 32) {
      const float4 p = opos[idx[e] - o0];
      const float4 src = kOwnerIsSample ? p : q, smp = kOwnerIsSample ? q : p;
      const float ox = mc_offset(src.x, smp.x, radius), oy = mc_offset(src.y, smp.y, radius),
                  oz = mc_offset(src.z, smp.z, radius);
      float a[kHidden];
#pragma unroll
      for (int h = 0; h < kHidden; ++h)
        a[h] = fmaxf(mc_preact(ox, oy, oz, w1, b1, kHidden, h), 0.f);
      float4* dst = reinterpret_cast<float4*>(L.act + (size_t)s * L.astride + 8 * e);
      dst[0] = make_float4(a[0], a[1], a[2], a[3]);
      dst[1] = make_float4(a[4], a[5], a[6], a[7]);
      if constexpr (!kOwnerIsSample) L.off[s * L.ostride + e] = make_float4(ox, oy, oz, 0.f);
    }
  }
};

// Owner q's sweep of the groups [g, ngroups) of a staged chunk (the chunk's
// first other at o0), appending its in-radius others' o0 + staged index to
// idx from entry *len. Two groups are tested at a time (two independent d2
// chains a lane) and their hits appended in order. It stops before a group
// whose hits would pass cap and returns the group to resume at (ngroups when
// the chunk is done). The whole warp takes part.
template <bool kOwnerIsSample>
__device__ __forceinline__ int sweep_groups(float4 q, const float4* opos, const unsigned* ogrp,
                                            int g, int ngroups, int o0, float r2, int* idx,
                                            int cap, int* len_io) {
  const int lane = threadIdx.x & 31;
  const unsigned below = (1u << lane) - 1u;
  int len = *len_io;
  while (g < ngroups) {
    const unsigned vm0 = ogrp[g], vm1 = g + 1 < ngroups ? ogrp[g + 1] : 0u;
    if ((vm0 | vm1) == 0u) {  // two groups of padding: no valid other
      g += 2;
      continue;
    }
    const int t0 = (g << 5) + lane, t1 = t0 + 32;
    const bool in0 = in_radius<kOwnerIsSample>(q, opos, vm0, t0, lane, r2);
    const bool in1 = in_radius<kOwnerIsSample>(q, opos, vm1, t1, lane, r2);
    const unsigned bal0 = __ballot_sync(kFull, in0), bal1 = __ballot_sync(kFull, in1);
    const int n0 = __popc(bal0), n1 = __popc(bal1);
    if (len + n0 > cap) break;  // resumes at group g next round
    if (in0) idx[len + __popc(bal0 & below)] = o0 + t0;
    len += n0;
    if (len + n1 > cap) {  // resumes at group g + 1
      ++g;
      break;
    }
    if (in1) idx[len + __popc(bal1 & below)] = o0 + t1;
    len += n1;
    g += 2;
  }
  *len_io = len;
  return g > ngroups ? ngroups : g;
}

// One round of the sweep over a staged chunk (`ngroups` groups of 32, the
// chunk's first other at index o0 of its cloud): warp w takes owners w, w +
// nwarps, ... . Owners are (x, y, z, |p|^2) with a validity flag; an invalid
// owner lists nothing. kOwnerIsSample: K1's lists (owner = sample); else
// K2's (owner = source, with the offsets). Every owner's list starts empty;
// once it is complete for the round, `form` gives its entries their
// activations (the whole warp takes part). Returns true where an owner
// stopped before the chunk's end.
template <bool kOwnerIsSample, class Form>
__device__ __forceinline__ bool sweep_round(const float4* own, const int* own_valid,
                                            int n_owner, const float4* opos,
                                            const unsigned* ogrp, int ngroups, int o0, float r2,
                                            Lists L, const Form& form) {
  const int lane = threadIdx.x & 31, nw = blockDim.x >> 5;
  bool more = false;
  for (int s = threadIdx.x >> 5; s < n_owner; s += nw) {
    const float4 q = own[s];
    int* idx = L.idx + s * L.istride;
    int len = 0;
    const int g = sweep_groups<kOwnerIsSample>(q, opos, ogrp, own_valid[s] ? L.resume[s] : ngroups,
                                               ngroups, o0, r2, idx, L.cap, &len);
    __syncwarp();  // the list's indices are visible to every lane
    form(s, q, idx, len, o0, opos, L);
    if (lane == 0) {
      L.resume[s] = g;
      L.len[s] = len;
      L.count[s] += len;
    }
    more |= g < ngroups;
  }
  return more;
}

// One round of the sweep of K5, K6, K9 or K10 over a chunk staged by
// `stage_gather`, whose others' rows are at orow: each owner's hits are
// appended to its list after the L.len[s] entries of the chunks before, and
// `form` gives entries [start, len) their activations (and K6 / K10's
// offsets) and turns each staged index into its row. The owner may be either
// side of the pair: `pair_d2_rn` is symmetric bit for bit (its sums and
// products commute). Returns true where an owner stopped before the chunk's
// end: its list is full.
template <class Form>
__device__ __forceinline__ bool sweep_append(const float4* own, const int* own_valid,
                                             int n_owner, const float4* opos,
                                             const unsigned* ogrp, int ngroups, float r2,
                                             Lists L, const Form& form) {
  const int lane = threadIdx.x & 31, nw = blockDim.x >> 5;
  bool more = false;
  for (int s = threadIdx.x >> 5; s < n_owner; s += nw) {
    const float4 q = own[s];
    int* idx = L.idx + s * L.istride;
    const int start = L.len[s];
    int len = start;
    const int g = sweep_groups<false>(q, opos, ogrp, own_valid[s] ? L.resume[s] : ngroups,
                                      ngroups, 0, r2, idx, L.cap, &len);
    __syncwarp();  // the list's indices are visible to every lane
    form(s, q, idx, start, len, opos, L);
    __syncwarp();  // every lane has read L.len[s]
    if (lane == 0) {
      L.resume[s] = g;
      L.len[s] = len;
      L.count[s] += len - start;
    }
    more |= g < ngroups;
  }
  return more;
}

// `sweep_append`'s entries of K6 and K10 (owner = source q): offsets (source
// minus sample) / r, the 8 activations and the sample's row, one entry a lane.
struct RowForm {
  const float* w1;
  const float* b1;
  const int* orow;
  float radius;

  __device__ __forceinline__ void operator()(int s, float4 q, int* idx, int start, int len,
                                             const float4* opos, const Lists& L) const {
    for (int e = start + (threadIdx.x & 31); e < len; e += 32) {
      const int t = idx[e];
      const float4 p = opos[t];
      const float ox = mc_offset(q.x, p.x, radius), oy = mc_offset(q.y, p.y, radius),
                  oz = mc_offset(q.z, p.z, radius);
      float a[kHidden];
#pragma unroll
      for (int h = 0; h < kHidden; ++h)
        a[h] = fmaxf(mc_preact(ox, oy, oz, w1, b1, kHidden, h), 0.f);
      float4* dst = reinterpret_cast<float4*>(L.act + (size_t)s * L.astride + 8 * e);
      dst[0] = make_float4(a[0], a[1], a[2], a[3]);
      dst[1] = make_float4(a[4], a[5], a[6], a[7]);
      L.off[s * L.ostride + e] = make_float4(ox, oy, oz, 0.f);
      idx[e] = orow[t];
    }
  }
};

// The noop and bwd_noop probes' entries: none formed (the lists only count).
struct CountForm {
  __device__ __forceinline__ void operator()(int, float4, int*, int, int, const float4*,
                                             const Lists&) const {}
};

// The round with every entry formed by `OffsetForm` (w1 (3, H) and b1 (H,)).
template <bool kOwnerIsSample>
__device__ __forceinline__ bool sweep_round(const float4* own, const int* own_valid,
                                            int n_owner, const float4* opos,
                                            const unsigned* ogrp, int ngroups, int o0,
                                            const float* w1, const float* b1, float r2,
                                            float radius, Lists L) {
  return sweep_round<kOwnerIsSample>(own, own_valid, n_owner, opos, ogrp, ngroups, o0, r2, L,
                                     OffsetForm<kOwnerIsSample>{w1, b1, radius});
}

// A kernel's block shape, chosen on the host. `owners` points a block; `hg`
// thread groups an owner's (H+1) rows are split into (K1 at C <= 4: one row
// a thread); `tps` threads per owner and row group, each holding kCpt
// channels strided by tps, so a pass covers 4 * tps channels; `passes` such
// runs of channels a block, in turn; `slices` blocks share an owner tile's
// channels (one more grid dimension, where the owner tiles alone would not
// fill the card); `cap` entries a list; `chunk` others staged at once.
constexpr int kCpt = 4;
constexpr int kMaxC = kThreads * kCpt;  // the kernels' channel limit (the wrappers' MAX_C)
constexpr int kMinOwners = 16;  // wide C takes passes rather than fewer owners a block

struct Plan {
  int owners, hg, tps, passes, slices, cap, chunk, threads, tiles;
};

inline int div_up(int a, int b) { return (a + b - 1) / b; }

// n_owner points a cloud own, n_other are swept; budget = list entries a block.
inline Plan make_plan(int B, int n_owner, int n_other, int C, bool rows_split, int budget,
                      int min_cap) {
  Plan p;
  p.hg = rows_split ? kHidden + 1 : 1;
  const int groups = rows_split ? 1 : div_up(C, kCpt);  // runs of 4 channels
  int owners = kThreads / (p.hg * groups);
  if (owners < kMinOwners && !rows_split) owners = kMinOwners;
  if (owners < 1) owners = 1;
  if (owners > kMaxOwners) owners = kMaxOwners;
  if (owners > n_owner) owners = n_owner;
  p.owners = owners;
  p.tiles = div_up(n_owner, owners);
  p.slices = 1;
  if (B * p.tiles < kFillBlocks && groups > 1) {
    p.slices = div_up(kFillBlocks, B * p.tiles);
    if (p.slices > groups) p.slices = groups;
  }
  const int per_block = div_up(groups, p.slices);
  p.slices = div_up(groups, per_block);
  p.tps = per_block < kThreads / (owners * p.hg) ? per_block : kThreads / (owners * p.hg);
  p.passes = div_up(per_block, p.tps);
  p.slices = div_up(groups, p.passes * p.tps);  // a block covers passes * tps runs
  p.threads = kThreads;  // every warp sweeps; the first owners * hg * tps threads contract
  int cap = budget / owners;
  if (cap < min_cap) cap = min_cap;
  if (cap > 256) cap = 256;
  p.cap = cap;
  p.chunk = (n_other < kChunk ? (n_other + 31) / 32 * 32 : kChunk);
  return p;
}

// The k split of a tiled GEMM whose output tiles make `blocks` blocks:
// one split where they fill the card's 132 SMs, else enough splits to reach
// kFillBlocks, each at least 64 of K, in chunks of 16 (*kchunk).
inline int split_k(int blocks, int K, int* kchunk) {
  int s = 1;
  if (blocks < 132) {
    s = div_up(kFillBlocks, blocks);
    const int most = K / 64;
    if (s > most) s = most;
    if (s < 1) s = 1;
  }
  *kchunk = div_up(div_up(K, s), 16) * 16;
  return div_up(K, *kchunk);
}

}  // namespace dense_pairs
