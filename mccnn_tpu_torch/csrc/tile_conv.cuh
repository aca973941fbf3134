// K5 and K5p: the Monte-Carlo convolution over Hilbert tile pairs, forward.
//
// Replace mccnn_tpu/ops/pallas/tile_conv.py::_fwd_kernel (:525, called at
// :982 through _fwd_call from tile_mc_conv), K5p its packed-record mode
// (spec.pack, :553-557, records from _pack_minor :487, chosen at :1354-1368
// by MCCNN_TILE_PACK=1). Samples and sources are sorted along a Hilbert (or,
// under MCCNN_TILE_ORDER=morton, Morton) curve; the host builds a chunked step
// list in which step k of cloud b pairs the sample tile i_ids[b, k] (T = 128
// sorted samples; the list is non-decreasing in it) with up to G candidate
// minor tiles j_ids[b, :, k] (Tm sorted sources each, Tm in {8, 16, 32, 64,
// 128}, a template parameter; the id n_minor marks none, and a step's real
// minors come first). For every sample i of the tile and every valid source j
// of those minors with d2(i, j) <= r2:
//
//   G[b,i,h,c] = sum_j a_h(i,j) f~[b,j,c]   (a_h = relu(pre_h), h < H; a_H = 1)
//   cnt[b,i]   = the number of such j
//
// then out = sum_h G[.., h, c] W2[h, c] + G[.., H, c] b2[c] (depthwise, in
// this kernel's epilogue) or K1's projection GEMM (full conv, a second
// launch), times 1/cnt in mean mode and 0 for an invalid sample.
//
// The TPU kernel runs one grid step per list step in order and accumulates
// each output tile across its consecutive steps in VMEM. On the H100 a block
// owns a group of up to 32 samples of one sample tile (16 where C > 32, so
// that 4 channels a thread cover 64 channels a pass; the full conv at C <= 4
// spreads the 9 rows of 32 samples over 288 threads) and walks that tile's
// contiguous run of steps, run[b, t] to run[b, t+1] (built on the host with
// searchsorted): it stages each step's real minors in (step, minor, row)
// order, up to 1024 rows at once (a step of G * Tm = 2048 rows spans two
// chunks), and the body of list_fwd.cuh sweeps them once into each sample's
// list of in-radius valid sources (one d2 test a candidate pair, `pair_d2_rn`;
// a_h with `mc_offset` / `mc_preact` for listed pairs alone, as K1, K2, K6,
// K9 and the plain version form them) and contracts the lists over all
// channels of its samples, 4 a thread, in passes. Where B x tiles x groups
// would not fill the card the channels are split over blocks, each redoing
// its group's sweep (dense_pairs.cuh `Plan`). Four blocks walk a tile's run
// (eight where C > 32): the staging is redone by each group, and every
// candidate pair still costs one d2 test. Every output row has one writer and
// the sums run in (step, minor, row) order: no atomics, two calls
// bit-identical. Each G value is the FMA chain of the kernel that formed an
// a_h plane for every candidate pair (one block per tile and 16-channel
// slice) minus its exact zeros, so G, out and cnt are bit for bit that
// kernel's; K5 gives one result at every Tm for one step list.
//
// K5p reads each candidate minor from one contiguous record (the TPU kernel's
// single DMA a minor instead of two): Tm rows of (x, y, z, validity) and then
// the minor's Tm x C payload f~, fp32 (the TPU record bit-casts bf16). It
// stages the same values as K5 (another fetch) and sums in the same order, so
// the two are bit-equal.
//
// What bounds it on the H100: the in-radius pairs' arithmetic, 8
// pre-activations and (H+1) FFMAs a channel, and their f~ rows read from L2;
// every other candidate pair (a sample tile meets about 10x more) costs one
// d2 test on staged positions. Invalid rows are masked by their flags (the
// TPU kernel parks them at a far sentinel coordinate, whose expanded d2
// against another sentinel cancels to ~0). Everything is fp32 (the TPU kernel
// holds features in bf16). Limits: H == 8, T == 128, G * Tm <= 2048, C <=
// 1024. The source rows may run past the last minor (the layout keeps them in
// the major tiling the backward, K6, reads).
//
// The probes (template parameter kProbe; tile_conv_probe.cu and
// tile_conv_packed_probe.cu build them) replace the roofline probes of the
// TPU kernel's forward (spec.probe, :575-608, MCCNN_TILE_PROBE), which strip
// K5 to its parts for tools/exp_tile_roofline.py. Each walks the same steps
// with K5's blocks, stages the same chunks and runs the same d2 sweep, and
// writes K5's count; then it keeps one part (list_fwd.cuh):
//   kProbeNoop:   nothing more: the lists only count, and it writes 0 x the
//                 sample's count as its value (the staging and the sweep);
//   kProbePlanes: the H pre-activations of each listed (in-radius) pair in the
//                 factored form (cw_h(j) - sw_h(i)) + b1_h (mc_w1_proj, as the
//                 TPU probe forms them, :578-591), ReLU'd and summed over h
//                 and over the pairs into the sample's value (the TPU probe's
//                 sum of a_h, no matmul);
//   kProbeMm:     the raw d2 of every valid candidate pair as each of the H
//                 a_h and the radius mask as a_H, with K5's whole contraction
//                 and epilogue (the TPU probe's d2 fed to the 9 feature
//                 matmuls, :595-607). Its lists take every valid candidate:
//                 the radius test is off for this probe alone, so it
//                 contracts ~10x the pairs K5 does, as the TPU probe does.
// noop and planes write the value to out (B, NS), the same for every channel
// (the wrapper broadcasts and scales it); mm writes what K5 writes.
#pragma once

#include "list_fwd.cuh"

namespace {
namespace k5 {

using dense_pairs::kHidden;
using list_fwd::kProbeMm;
using list_fwd::kProbeNone;
using list_fwd::kProbeNoop;
using list_fwd::kProbePlanes;

constexpr int kT = 128;         // samples per tile
constexpr int kH1 = kHidden + 1;
constexpr int kMaxRows = 2048;  // candidate rows a step: G * Tm
constexpr int kMaxG = 256;      // minors a step (G * Tm <= kMaxRows, Tm >= 8)
constexpr int kMaxMinors = list_fwd::kChunk / 8;  // minors a chunk

struct TileConvArgs {
  const float* smp;       // (B, NS, 3) sorted samples
  const uint8_t* svalid;  // (B, NS)
  const float* src;       // (B, NP, 3) sorted sources (K5)
  const uint8_t* pvalid;  // (B, NP) (K5)
  const float* wf;        // (B, NP, C) f~ (K5)
  const float* rec;       // (B, n_minor, Tm * (4 + C)) packed source minors (K5p)
  const int* j_ids;       // (B, G, S)
  const int* run;         // (B, n_tiles + 1)
  const float* w1;        // (3, H)
  const float* b1;        // (H,)
  const float* w2;        // (H, C) depthwise
  const float* b2;        // (C,) depthwise
  int NS, NP, C, S, G, n_tiles, sentinel;
  float r2, radius;
  int mean, depthwise;
  float* out;  // (B, NS, C) depthwise, else G (B, NS, H+1, C); a noop or planes probe's (B, NS)
  float* cnt;  // (B, NS)
};

// A sample tile's run of steps, staged a chunk at a time: the real source
// minors of steps k.. in order into `mids`, then their rows.
template <int TM, bool kPacked>
struct MinorWalk {
  static constexpr int kShift = TM == 8 ? 3 : TM == 16 ? 4 : TM == 32 ? 5 : TM == 64 ? 6 : 7;
  static constexpr int kMcap = list_fwd::kChunk / TM;  // minors a chunk
  const TileConvArgs* a;
  int b, k0, k1, k, gpos, nreal;
  int* stepm;  // [kMaxG] this step's minor ids
  int* mids;   // [kMaxMinors] the chunk's minors

  __device__ void reset() {
    k = k0;
    gpos = 0;
    nreal = -1;
  }

  __device__ int stage(const list_fwd::Smem& S) {
    __syncthreads();  // the previous chunk is consumed
    const int nm = dense_pairs::step_minors(a->j_ids, b, a->G, a->S, a->sentinel, k1, kMcap,
                                            stepm, mids, &k, &gpos, &nreal);
    __syncthreads();  // the chunk's minors are visible
    const int n = nm * TM;
    const TileConvArgs& A = *a;
    const int bb = b;
    const int* ms = mids;
    int* orow = S.orow;
    dense_pairs::stage_gather(n, S.opos, S.ogrp, [&](int t, float* x, float* y, float* z) {
      const int m = ms[t >> kShift], r = t & (TM - 1), q = (m << kShift) + r;
      orow[t] = q;
      if constexpr (kPacked) {
        const float* p = A.rec + ((size_t)bb * A.sentinel + m) * ((size_t)TM * (4 + A.C)) + 4 * r;
        *x = p[0];
        *y = p[1];
        *z = p[2];
        return p[3] != 0.f;
      } else {
        const size_t i = (size_t)bb * A.NP + q;
        *x = A.src[3 * i];
        *y = A.src[3 * i + 1];
        *z = A.src[3 * i + 2];
        return A.pvalid[i] != 0;
      }
    });
    __syncthreads();
    return n;
  }

  // f~'s row of source row q
  __device__ __forceinline__ const float* row(int q) const {
    if constexpr (kPacked)
      return a->rec + ((size_t)b * a->sentinel + (q >> kShift)) * ((size_t)TM * (4 + a->C)) +
             4 * TM + (size_t)(q & (TM - 1)) * a->C;
    else
      return a->wf + ((size_t)b * a->NP + q) * a->C;
  }
};

constexpr int kExtraInts = kMaxG + kMaxMinors;  // the walk's shared memory

template <int TM, bool kPacked, int kProbe, int HPT>
__global__ void __launch_bounds__(HPT == 1 ? list_fwd::kRowThreads : list_fwd::kThreads)
    tile_conv_kernel(const __grid_constant__ TileConvArgs a, int owners, int groups, int cap,
                     int tps, int passes) {
  extern __shared__ __align__(16) char smem[];
  const list_fwd::Smem S = list_fwd::carve(smem);
  const int x = blockIdx.x, t = x / groups, g = x % groups, b = blockIdx.y, z = blockIdx.z;
  const int r0 = t * kT + g * owners, n_own = min(owners, kT - g * owners);
  for (int s = threadIdx.x; s < n_own; s += blockDim.x) {
    const size_t k = (size_t)b * a.NS + r0 + s;
    const float qx = a.smp[3 * k], qy = a.smp[3 * k + 1], qz = a.smp[3 * k + 2];
    S.qpos[s] = make_float4(qx, qy, qz, sq_norm_rn(qx, qy, qz));
    S.qvalid[s] = a.svalid[k] != 0;
    S.qrow[s] = r0 + s;
  }
  int* stepm = reinterpret_cast<int*>(S.extra);
  const int* run = a.run + (size_t)b * (a.n_tiles + 1) + t;
  MinorWalk<TM, kPacked> walk{&a, b, run[0], run[1], run[0], 0, -1, stepm, stepm + kMaxG};
  const list_fwd::Args la{a.w1, a.b1, a.w2, a.b2, a.C, a.NS, a.r2, a.radius, a.mean, a.depthwise,
                          a.out, a.cnt};
  const int cbeg = z * passes * dense_pairs::kCpt * tps;
  const int cend = min(a.C, cbeg + passes * dense_pairs::kCpt * tps);
  list_fwd::owner_forward<HPT, kProbe>(la, walk, S, b, n_own, cap, tps, passes, cbeg, cend,
                                       z == 0);
}

// The block shape of B clouds of n_tiles sample tiles (dense_pairs.cuh's
// `Plan`): 32 samples a block, or 16 where 4 channels a thread need more than
// 8 threads a sample; at C <= 4 of the full conv (`rows`) 32 samples with
// their 9 rows spread over 288 threads; channels split over `slices` blocks
// where the groups alone would not fill the card.
inline dense_pairs::Plan tile_conv_plan(int B, int n_tiles, int C, bool rows) {
  using dense_pairs::div_up;
  const int runs = div_up(C, dense_pairs::kCpt);  // runs of 4 channels
  dense_pairs::Plan p;
  p.hg = rows ? kH1 : 1;
  p.owners = !rows && runs > list_fwd::kThreads / list_fwd::kMaxOwners ? 16 : 32;
  p.tiles = div_up(kT, p.owners);  // groups a tile
  p.threads = rows ? list_fwd::kRowThreads : list_fwd::kThreads;
  const int blocks = B * n_tiles * p.tiles;
  p.slices = 1;
  if (!rows && blocks < dense_pairs::kFillBlocks && runs > 1) {
    p.slices = div_up(dense_pairs::kFillBlocks, blocks);
    if (p.slices > runs) p.slices = runs;
  }
  const int per_block = div_up(runs, p.slices);
  const int most = p.threads / (p.owners * p.hg);
  p.tps = per_block < most ? per_block : most;
  p.passes = div_up(per_block, p.tps);
  p.slices = div_up(runs, p.passes * p.tps);
  p.cap = list_fwd::list_cap(p.owners);
  p.chunk = list_fwd::kChunk;
  return p;
}

inline size_t tile_conv_smem() { return list_fwd::smem_bytes() + sizeof(int) * kExtraInts; }

template <int TM, bool kPacked, int kProbe, int HPT>
int tile_conv_launch_tm(const TileConvArgs& a, const dense_pairs::Plan& p, int B,
                        cudaStream_t stream) {
  const size_t smem = tile_conv_smem();
  auto kernel = tile_conv_kernel<TM, kPacked, kProbe, HPT>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(a.n_tiles * p.tiles, B, p.slices);
  kernel<<<grid, p.threads, smem, stream>>>(a, p.owners, p.tiles, p.cap, p.tps, p.passes);
  MCCNN_LAUNCH_RETURN();
}

template <int TM, bool kPacked, int kProbe>
int tile_conv_launch_rows(const TileConvArgs& a, int B, cudaStream_t stream) {
  const bool rows = !a.depthwise && a.C <= dense_pairs::kCpt;
  const dense_pairs::Plan p = tile_conv_plan(B, a.n_tiles, a.C, rows);
  return rows ? tile_conv_launch_tm<TM, kPacked, kProbe, 1>(a, p, B, stream)
              : tile_conv_launch_tm<TM, kPacked, kProbe, kH1>(a, p, B, stream);
}

// Checks the shapes and launches the instance built for Tm (8, 16, 32, 64 or
// 128); any other Tm, or a shape the kernel does not take, is refused.
template <bool kPacked, int kProbe = kProbeNone>
int tile_conv_dispatch(const TileConvArgs& a, int B, int H, int Tm, cudaStream_t stream) {
  if (H != 8 || a.C < 1 || a.C > dense_pairs::kMaxC || a.G < 1 || a.G > kMaxG || Tm < 8 ||
      (size_t)a.G * Tm > kMaxRows || a.NS != a.n_tiles * kT || a.n_tiles < 1 || B < 1 ||
      B > 65535 || (!kPacked && a.NP < a.sentinel * Tm))
    return static_cast<int>(cudaErrorInvalidValue);
  switch (Tm) {
    case 8: return tile_conv_launch_rows<8, kPacked, kProbe>(a, B, stream);
    case 16: return tile_conv_launch_rows<16, kPacked, kProbe>(a, B, stream);
    case 32: return tile_conv_launch_rows<32, kPacked, kProbe>(a, B, stream);
    case 64: return tile_conv_launch_rows<64, kPacked, kProbe>(a, B, stream);
    case 128: return tile_conv_launch_rows<128, kPacked, kProbe>(a, B, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// The probe instances: kProbe picked at run time (1 noop, 2 planes, 3 mm).
template <bool kPacked>
int tile_conv_probe_dispatch(const TileConvArgs& a, int B, int H, int Tm, int probe,
                             cudaStream_t stream) {
  switch (probe) {
    case kProbeNoop: return tile_conv_dispatch<kPacked, kProbeNoop>(a, B, H, Tm, stream);
    case kProbePlanes: return tile_conv_dispatch<kPacked, kProbePlanes>(a, B, H, Tm, stream);
    case kProbeMm: return tile_conv_dispatch<kPacked, kProbeMm>(a, B, H, Tm, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace k5
}  // namespace
