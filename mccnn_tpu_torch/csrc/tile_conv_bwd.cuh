// K6 and K6p: the Monte-Carlo convolution over Hilbert tile pairs, backward.
//
// Replace mccnn_tpu/ops/pallas/tile_conv.py::_bwd_kernel (:658, called at
// :1057 through _bwd_call from the custom_vjp of tile_mc_conv), K6p its
// packed-record mode (spec.pack, :1038-1041; the records of positions and
// cotangent are packed at :1152-1155). K5 (tile_conv.cuh) forms G[b,i,h,c] =
// sum_j a_h(i,j) f~[b,j,c] over the forward step list (sample majors x source
// minors) and out = s_i * (G . [W2; b2]). The backward walks its own list, as
// the reference's does: step k of cloud b pairs the source tile jb[b, k] (T =
// 128 sorted sources; the list is non-decreasing in it) with up to G sample
// minors ib[b, :, k] (Tm sorted samples each, Tm in {8, 16, 32, 64, 128}; the
// id n_minor marks none, and a step's real minors come first). For every
// valid pair (sample i, source j) of those tiles with d2(i, j) <= r2 it forms
// X, dpre, dW1 and db1, and from X d_f~ and [dW2; db2] (list_bwd.cuh). Forming
// dW2 from X, over the pairs the backward list reaches, and not from the
// forward's G keeps the reference's semantics when a budget is short and the
// two lists drop different pairs; it also means K5 need not keep G at the
// depthwise sites.
//
// The TPU kernel runs one grid step per list step and carries dfeat across a
// tile's consecutive steps in VMEM and the parameter gradients across the
// whole grid. On the H100 a block owns a group of up to 32 sources of one
// source tile (16 where max(C, KU) > 32, so that 4 channels a thread cover
// 64 channels a pass) and walks that tile's contiguous run of steps, run[b, t] to run[b,
// t+1]: it stages each step's real minors in (step, minor, row) order, up to
// 1024 rows at once, and the body of list_bwd.cuh sweeps them once into each
// source's list of in-radius valid samples (one d2 test a candidate pair,
// `pair_d2_rn`; offsets and a_h with `mc_offset` / `mc_preact` for listed pairs
// alone, as K1, K2, K5 and the plain version form them, so a pair at the
// radius falls alike everywhere) and contracts the lists over all channels of
// its sources, in passes of 64 channels. Where B x tiles x groups would not
// fill the card the channels are split over blocks (dense_pairs.cuh `Plan`).
// X at the full site (the stem) and d_f~ at the depthwise sites are bit for
// bit those of the kernel that walked every candidate pair with a 16-channel
// block grid: each X value is that kernel's FFMA chain minus its exact zeros.
// Depthwise sites write one [dW2; db2] partial a source group; the full site
// writes X, and K2's GEMMs (dense_conv_bwd.cu) form d_f~ and dWcat from it,
// and dG before it. The partials are summed in block order by K2's reduction
// kernel: no float atomics, two calls are bit-identical.
//
// K6p reads each sample minor from one contiguous record: Tm rows of (x, y,
// z, validity) and then the minor's Tm x KU cotangent t, fp32 (the TPU record
// bit-casts bf16); dG of the full conv stays a buffer of its own. It stages
// the values K6 stages and sums in the same order: the two are bit-equal.
//
// What bounds it on the H100: the in-radius pairs' arithmetic, (H+1) FFMAs a
// channel for X and H for dpre, and their t rows read from L2; every other
// candidate pair (the step list hands it about 10x more) costs one d2 test on
// staged positions, once a call. Everything is fp32 (the TPU kernel holds
// planes, features and the cotangent in bf16). Invalid rows are masked by
// their flags. Limits: H == 8, T == 128, Tm in {8, 16, 32, 64, 128}, G * Tm
// <= 2048, C and KU <= 1024.
//
// The bwd_noop probe (template parameter kNoop; tile_conv_bwd_probe.cu builds
// it) replaces the roofline probe of the TPU kernel's backward (spec.probe ==
// "bwd_noop", :718-726, MCCNN_TILE_PROBE): it walks the same steps, stages
// the same chunks and runs the same d2 sweep, its lists only counting, then
// writes 0 x the number of in-radius pairs it met (the TPU's jnp.sum(pen) *
// 0.0) as every output and partial, so every gradient is 0 and the staging and
// list building stay in the kernel.
#pragma once

#include "list_bwd.cuh"

namespace {
namespace k6 {

constexpr int kT = 128;         // sources per major tile
constexpr int kMaxRows = 2048;  // candidate rows a step: G * Tm
constexpr int kMaxG = 256;      // minors a step (G * Tm <= kMaxRows, Tm >= 8)
constexpr int kMaxMinors = list_bwd::kChunk / 8;  // minors a chunk

struct TileBwdArgs {
  const float* smp;       // (B, NS, 3) sorted samples (K6)
  const uint8_t* svalid;  // (B, NS) (K6)
  const float* u;         // (B, NS, KU) t (K6)
  const float* rec;       // (B, n_minor, Tm * (4 + KU)) packed sample minors (K6p)
  const float* src;       // (B, NP, 3) sorted sources
  const uint8_t* pvalid;  // (B, NP)
  const float* wf;        // (B, NP, C) f~
  const float* dg;        // (B, NS, H+1, C) dG of the full conv (unread when depthwise)
  const int* j_ids;       // (B, G, S)
  const int* run;         // (B, n_tiles + 1)
  const float* w1;
  const float* b1;
  const float* w2;
  const float* b2;
  int NS, NP, C, KU, S, G, n_tiles, sentinel;
  float r2, radius;
  int depthwise;
  float* out;     // d_f~ (B, NP, C) when depthwise, else X (B, NP, H+1, KU)
  float* xs;      // (B, NP, H+1, C) X between contractions (depthwise, several passes)
  float* w1part;  // (B * n_tiles * groups * slices, 4, H)
  float* w2part;  // (B * n_tiles * groups, H+1, C), depthwise only
};

// A source tile's run of steps, staged a chunk at a time: the real minors of
// steps k.. in order into `mids`, then their rows.
template <bool kPacked>
struct TileWalk {
  const TileBwdArgs* a;
  int b, k, k1, gpos, nreal, shift, mcap;
  int* stepm;  // [kMaxG] this step's minor ids
  int* mids;   // [kMaxMinors] the chunk's minors

  __device__ int stage(const list_bwd::Smem& S) {
    __syncthreads();  // the previous chunk is consumed
    const int nm = dense_pairs::step_minors(a->j_ids, b, a->G, a->S, a->sentinel, k1, mcap,
                                            stepm, mids, &k, &gpos, &nreal);
    __syncthreads();  // the chunk's minors are visible
    const int n = nm << shift, rmask = (1 << shift) - 1;
    const TileBwdArgs& A = *a;
    const int bb = b, sh = shift;
    const int* ms = mids;
    int* orow = S.orow;
    dense_pairs::stage_gather(n, S.opos, S.ogrp, [&](int t, float* x, float* y, float* z) {
      const int m = ms[t >> sh], r = t & rmask, q = (m << sh) + r;
      orow[t] = q;
      if constexpr (kPacked) {
        const size_t rec = (size_t)(rmask + 1) * (4 + A.KU);  // floats a record
        const float* p = A.rec + ((size_t)bb * A.sentinel + m) * rec + 4 * r;
        *x = p[0];
        *y = p[1];
        *z = p[2];
        return p[3] != 0.f;
      } else {
        const size_t i = (size_t)bb * A.NS + q;
        *x = A.smp[3 * i];
        *y = A.smp[3 * i + 1];
        *z = A.smp[3 * i + 2];
        return A.svalid[i] != 0;
      }
    });
    __syncthreads();
    return n;
  }

  // t's row of sample row q
  __device__ __forceinline__ const float* row(int q) const {
    if constexpr (kPacked) {
      const int tm = 1 << shift;
      return a->rec + ((size_t)b * a->sentinel + (q >> shift)) * ((size_t)tm * (4 + a->KU)) +
             4 * tm + (size_t)(q & (tm - 1)) * a->KU;
    } else {
      return a->u + ((size_t)b * a->NS + q) * a->KU;
    }
  }
};

template <bool kDepthwise, bool kPacked, bool kNoop>
__global__ void __launch_bounds__(list_bwd::kThreads, 2)
    tile_conv_bwd_kernel(const __grid_constant__ TileBwdArgs a, int owners, int groups, int cap,
                         int tps, int passes, int shift) {
  extern __shared__ __align__(16) char smem[];
  const list_bwd::Smem S = list_bwd::carve(smem);
  const int x = blockIdx.x, t = x / groups, g = x % groups, b = blockIdx.y, z = blockIdx.z;
  const int r0 = t * kT + g * owners;
  for (int s = threadIdx.x; s < owners; s += blockDim.x) {
    const size_t k = (size_t)b * a.NP + r0 + s;
    const float px = a.src[3 * k], py = a.src[3 * k + 1], pz = a.src[3 * k + 2];
    S.jpos[s] = make_float4(px, py, pz, sq_norm_rn(px, py, pz));
    S.jvalid[s] = a.pvalid[k] != 0;
    S.jrow[s] = r0 + s;
  }
  int* stepm = reinterpret_cast<int*>(S.extra);
  TileWalk<kPacked> walk{&a,     b,  a.run[(size_t)b * (a.n_tiles + 1) + t],
                         a.run[(size_t)b * (a.n_tiles + 1) + t + 1], 0, -1, shift,
                         list_bwd::kChunk >> shift, stepm, stepm + kMaxG};
  const list_bwd::Args la{a.wf, a.dg,   a.w1, a.b1,   a.w2,   a.b2,     a.NP,    a.NS, a.C,
                          a.KU, a.r2,   a.radius, a.out, a.xs, a.w1part, a.w2part};
  const int wide = a.C > a.KU ? a.C : a.KU;
  const int cbeg = z * passes * dense_pairs::kCpt * tps;
  const int cend = min(wide, cbeg + passes * dense_pairs::kCpt * tps);
  list_bwd::owner_backward<kDepthwise, kNoop>(la, walk, S, b, owners, cap, tps, passes, cbeg,
                                              cend, ((size_t)b * gridDim.x + x) * gridDim.z + z,
                                              (size_t)b * gridDim.x + x);
}

// The block shape of B clouds of n_tiles source tiles, as dense_pairs.cuh's
// `make_plan` (channels split over `slices` blocks where the groups alone
// would not fill the card), with owners a group dividing the tile: 32, or 16
// where 4 channels a thread need more than 8 threads an owner.
inline dense_pairs::Plan tile_bwd_plan(int B, int n_tiles, int C, int KU) {
  using dense_pairs::div_up;
  const int runs = div_up(C > KU ? C : KU, dense_pairs::kCpt);  // runs of 4 channels
  dense_pairs::Plan p;
  p.hg = 1;
  p.owners = runs > list_bwd::kThreads / list_bwd::kMaxOwners ? 16 : 32;
  p.tiles = kT / p.owners;  // groups a tile
  const int blocks = B * n_tiles * p.tiles;
  p.slices = 1;
  if (blocks < dense_pairs::kFillBlocks && runs > 1) {
    p.slices = div_up(dense_pairs::kFillBlocks, blocks);
    if (p.slices > runs) p.slices = runs;
  }
  const int per_block = div_up(runs, p.slices);
  p.tps = per_block < list_bwd::kThreads / p.owners ? per_block : list_bwd::kThreads / p.owners;
  p.passes = div_up(per_block, p.tps);
  p.slices = div_up(runs, p.passes * p.tps);
  p.cap = list_bwd::list_cap(p.owners);
  p.chunk = list_bwd::kChunk;
  p.threads = list_bwd::kThreads;
  return p;
}

inline size_t tile_bwd_smem() {
  return list_bwd::smem_bytes() + sizeof(int) * (kMaxG + kMaxMinors);
}

template <bool kDepthwise, bool kPacked, bool kNoop>
int tile_bwd_launch(const TileBwdArgs& a, const dense_pairs::Plan& p, int B, int shift,
                    cudaStream_t stream) {
  const size_t smem = tile_bwd_smem();
  auto kernel = tile_conv_bwd_kernel<kDepthwise, kPacked, kNoop>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(a.n_tiles * p.tiles, B, p.slices);
  kernel<<<grid, list_bwd::kThreads, smem, stream>>>(a, p.owners, p.tiles, p.cap, p.tps,
                                                     p.passes, shift);
  MCCNN_LAUNCH_RETURN();
}

// Checks the shapes and launches the instance for the site (depthwise or
// full); any Tm but 8, 16, 32, 64 and 128, or a shape the kernel does not
// take, is refused.
template <bool kPacked, bool kNoop = false>
int tile_bwd_dispatch(const TileBwdArgs& a, int B, int H, int Tm, cudaStream_t stream) {
  int shift = -1;
  for (int s = 3; s <= 7; ++s)
    if (Tm == 1 << s) shift = s;
  if (H != 8 || shift < 0 || a.C < 1 || a.KU < 1 || a.C > dense_pairs::kMaxC ||
      a.KU > dense_pairs::kMaxC || a.G < 1 || a.G > kMaxG || (size_t)a.G * Tm > kMaxRows ||
      B < 1 || B > 65535 || a.n_tiles < 1 || a.NP != a.n_tiles * kT ||
      a.NS < a.sentinel * Tm || (a.depthwise && a.KU != a.C))
    return static_cast<int>(cudaErrorInvalidValue);
  const dense_pairs::Plan p = tile_bwd_plan(B, a.n_tiles, a.C, a.KU);
  if (a.depthwise && p.passes > 1 && a.xs == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  return a.depthwise ? tile_bwd_launch<true, kPacked, kNoop>(a, p, B, shift, stream)
                     : tile_bwd_launch<false, kPacked, kNoop>(a, p, B, shift, stream);
}

}  // namespace k6
}  // namespace
