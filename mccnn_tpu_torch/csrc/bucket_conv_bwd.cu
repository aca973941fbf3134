// K10: the Monte-Carlo convolution over cell-bucket layouts, backward.
//
// Replaces mccnn_tpu/ops/pallas/mcconv_kernel.py::_bwd_kernel (:366, called at
// :662 through _bwd_call from the custom_vjp of bucket_mc_conv). K9
// (bucket_conv.cu) forms G[b,i,h,c] = sum_j a_h(i,j) f~[b,j,c] over the kept
// sources of the 27 cells around each kept sample's cell, and out = s_i * (G .
// [W2; b2]). With t = s * dout (the cotangent of the projection), for every
// kept source j of a cell and every kept sample i in the 27 cells around it
// with d2(i, j) <= r2 (the same pairs: the windows are symmetric) it forms X,
// dpre, dW1 and db1, and from X d_f~ and [dW2; db2], as K6 does
// (list_bwd.cuh, tile_conv_bwd.cuh).
//
// The TPU kernel sweeps bricks of source cells in order, each with its window
// of sample cells, writes each source slot's d(wf) once and accumulates the
// parameter gradients across the sequential grid. On the H100 a block owns up
// to 32 kept sources of one (cloud, source cell) (a cell with more takes
// several blocks); a block over an empty cell exits after one read, before
// any barrier. It gathers the 27 sample cells' kept counts into a prefix
// table and stages the window's kept samples in window order, up to 1024 at
// once, with their point indices (dout is never scattered into slot order),
// and runs K6's body (list_bwd.cuh): one d2 test a candidate pair into each
// source's list of in-radius samples (offsets and a_h with the expressions of
// K1, K2, K5, K6 and K9, common.cuh, for listed pairs alone), then the
// contraction over all channels of its sources. The pass is sized to the
// owners the block really has: a thread holds 4 channels, so n owners take
// passes of 4 * floor(256 / n) channels (1-4 sources a cell at MCSeg's
// dec_1_0: one pass of all 256), and every pass reads the same lists. X at
// the full site and d_f~ at the depthwise sites are bit for bit those of the
// kernel that walked every window sample with a 16-channel block grid. Every
// d_f~ / X row has one writer (point order by point_of_slot); one partial of
// dW1 / db1 and, depthwise, of [dW2; db2] a block, summed in block order by
// K2's reduction kernel: no float atomics, two calls are bit-identical. A
// block over an empty cell writes no partial, so the wrapper zeroes them.
//
// What bounds it on the H100: the in-radius pairs' arithmetic and their t
// rows read from L2, as K6; every other window pair (2.3-4.2x as many at
// MCSeg's sites) costs one d2 test on staged positions. Everything is fp32
// (the TPU kernel holds planes, features and the cotangent in bf16). Limits:
// H == 8, C and c_out <= 1024.
//
// K10a (kActive) is the same kernel over a list of bricks: it replaces
// _bwd_kernel (:366) as called at :644 with a PrefetchScalarGridSpec, the
// backward of `max_active_bricks`, which sweeps only the first NBA bricks
// (2 x 2 x BZ source cells) of each cloud's source-layout list. Each block
// reads its brick id from the list (bucket_brick_cell) and runs K10's body
// unchanged, over the whole sample layout; the wrapper's t is 0 at the samples
// K9a did not visit (their count is 0 too). The d_f~ rows of sources in
// unvisited bricks keep the zeros they were allocated with, and their pairs
// are in no partial, although K9a read them: the reference's semantics
// (its dfeat is an aliased zeros array, :640-654). A visited block writes its
// partials where K10 writes that cell's, and the other rows stay 0, so K2's
// reduction sums them in K10's order: at an NBA that visits every occupied
// brick, d_f~ and every parameter gradient are K10's bit for bit. What bounds
// it: K10's pair arithmetic over the visited source cells.

#include "list_bwd.cuh"

namespace {

constexpr int kOwners = list_bwd::kMaxOwners;  // kept sources a block

template <bool kDepthwise, bool kActive>
__global__ void __launch_bounds__(list_bwd::kThreads, 2)
    bucket_conv_bwd_kernel(const float* __restrict__ smp_pos, const int* __restrict__ smp_pts,
                           const int* __restrict__ smp_cnt, const float* __restrict__ src_pos,
                           const int* __restrict__ src_pts, const int* __restrict__ src_cnt,
                           const float* __restrict__ u, const int* __restrict__ ids, int nba,
                           int bz, int R, int capS, int capP, int npc,
                           const __grid_constant__ list_bwd::Args a) {
  const int Rp = R + 2;
  const size_t cells = (size_t)Rp * Rp * Rp;
  const int b = blockIdx.y;
  int cell, chunk;
  if (kActive) {
    cell = bucket_brick_cell(ids + (size_t)b * nba, blockIdx.x, npc, R, bz, &chunk);
  } else {
    cell = blockIdx.x / npc;
    chunk = blockIdx.x % npc;
  }
  const int pid = bucket_padded_cell(cell, R);
  const int s0 = chunk * kOwners;
  const int np = min(kOwners, src_cnt[b * cells + pid] - s0);
  if (np <= 0) return;  // the whole block leaves before any barrier; its partials stay 0

  extern __shared__ __align__(16) char smem[];
  const list_bwd::Smem S = list_bwd::carve(smem);
  const size_t pslots = cells * capP + 1;
  for (int s = threadIdx.x; s < np; s += blockDim.x) {
    const size_t slot = b * pslots + (size_t)pid * capP + s0 + s;
    const float x = src_pos[3 * slot], y = src_pos[3 * slot + 1], z = src_pos[3 * slot + 2];
    S.jpos[s] = make_float4(x, y, z, sq_norm_rn(x, y, z));
    S.jvalid[s] = 1;
    S.jrow[s] = src_pts[slot];
  }
  int* wcell = reinterpret_cast<int*>(S.extra);  // [27]
  int* wstart = wcell + 27;                      // [28]
  const int total = bucket_window_prefix(smp_cnt + b * cells, pid, Rp, wcell, wstart);
  dense_pairs::WindowWalk walk{smp_pos, smp_pts, u, wcell, wstart,
                               b * (cells * capS + 1), (size_t)b * a.rows, a.KU, capS, 0, total};
  const int wide = a.C > a.KU ? a.C : a.KU;
  const int runs = (wide + dense_pairs::kCpt - 1) / dense_pairs::kCpt;
  const int tps = min(runs, list_bwd::kThreads / np);
  const int passes = (runs + tps - 1) / tps;
  const size_t block_id = ((size_t)b * R * R * R + cell) * npc + chunk;
  list_bwd::owner_backward<kDepthwise, false>(a, walk, S, b, np, list_bwd::list_cap(np), tps,
                                              passes, 0, wide, block_id, block_id);
}

size_t bwd_smem() { return list_bwd::smem_bytes() + sizeof(int) * (27 + 28); }

template <bool kDepthwise, bool kActive>
int bucket_conv_bwd_go(const void* smp_pos, const void* smp_pts, const void* smp_cnt,
                       const void* src_pos, const void* src_pts, const void* src_cnt,
                       const void* u, const void* ids, int nba, int bz, int R, int capS,
                       int capP, int npc, long long nblocks, int B, const list_bwd::Args& a,
                       cudaStream_t stream) {
  const size_t smem = bwd_smem();
  auto kernel = bucket_conv_bwd_kernel<kDepthwise, kActive>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<dim3((unsigned)nblocks, B), list_bwd::kThreads, smem, stream>>>(
      static_cast<const float*>(smp_pos), static_cast<const int*>(smp_pts),
      static_cast<const int*>(smp_cnt), static_cast<const float*>(src_pos),
      static_cast<const int*>(src_pts), static_cast<const int*>(src_cnt),
      static_cast<const float*>(u), static_cast<const int*>(ids), nba, bz, R, capS, capP, npc,
      a);
  MCCNN_LAUNCH_RETURN();
}

template <bool kActive>
int bucket_conv_bwd_run(const void* smp_pos, const void* smp_pts, const void* smp_cnt,
                        const void* src_pos, const void* src_pts, const void* src_cnt,
                        const void* wf, const void* u, const void* dg, const void* w1,
                        const void* b1, const void* w2, const void* b2, const void* ids, int B,
                        int M, int N, int C, int KU, int H, int R, int capS, int capP, int npc,
                        int nba, int bz, float r2, float radius, int depthwise, void* out,
                        void* xs, void* w1part, void* w2part, void* stream) {
  if (H != 8 || C < 1 || KU < 1 || C > dense_pairs::kMaxC || KU > dense_pairs::kMaxC ||
      npc < 1 || (long long)kOwners * npc < capP || B < 1 || B > 65535 || R < 1 ||
      (depthwise && (KU != C || xs == nullptr)))
    return static_cast<int>(cudaErrorInvalidValue);
  if (kActive && (ids == nullptr || bz < 1 || R % 2 || R % bz || nba < 1 ||
                  nba > (R / 2) * (R / 2) * (R / bz)))
    return static_cast<int>(cudaErrorInvalidValue);
  const long long cells = kActive ? (long long)nba * 4 * bz : (long long)R * R * R;
  const long long nblocks = cells * npc;
  if (nblocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  const list_bwd::Args a{static_cast<const float*>(wf), static_cast<const float*>(dg),
                         static_cast<const float*>(w1), static_cast<const float*>(b1),
                         static_cast<const float*>(w2), static_cast<const float*>(b2),
                         N, M, C, KU, r2, radius, static_cast<float*>(out),
                         static_cast<float*>(xs), static_cast<float*>(w1part),
                         static_cast<float*>(w2part)};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  return depthwise ? bucket_conv_bwd_go<true, kActive>(smp_pos, smp_pts, smp_cnt, src_pos,
                                                       src_pts, src_cnt, u, ids, nba, bz, R,
                                                       capS, capP, npc, nblocks, B, a, st)
                   : bucket_conv_bwd_go<false, kActive>(smp_pos, smp_pts, smp_cnt, src_pos,
                                                        src_pts, src_cnt, u, ids, nba, bz, R,
                                                        capS, capP, npc, nblocks, B, a, st);
}

}  // namespace

// Layouts as bucket_conv_launch's. u: t (B, M, KU) in sample point order.
// dg: dG (B, M, H+1, C) for the full conv (unread when depthwise). out: d_f~
// (B, N, C) when depthwise, else X (B, N, H+1, KU), in source point order;
// rows of sources the layout does not keep are not written. xs: (B, N, H+1,
// C) scratch of a depthwise site (unread at the full one). A block is one of
// npc chunks of 32 kept slots of a cell (npc * 32 >= capP), R^3 * npc of them
// a cloud: w1part (B * R^3 * npc, 4, H) partials of [dW1; db1] and w2part
// (B * R^3 * npc, H+1, C) of [dW2; db2] (depthwise only).
extern "C" int bucket_conv_bwd_launch(const void* smp_pos, const void* smp_pts,
                                      const void* smp_cnt, const void* src_pos,
                                      const void* src_pts, const void* src_cnt, const void* wf,
                                      const void* u, const void* dg, const void* w1,
                                      const void* b1, const void* w2, const void* b2, int B,
                                      int M, int N, int C, int KU, int H, int R, int capS,
                                      int capP, int npc, float r2, float radius, int depthwise,
                                      void* out, void* xs, void* w1part, void* w2part,
                                      void* stream) {
  return bucket_conv_bwd_run<false>(smp_pos, smp_pts, smp_cnt, src_pos, src_pts, src_cnt, wf, u,
                                    dg, w1, b1, w2, b2, nullptr, B, M, N, C, KU, H, R, capS,
                                    capP, npc, 0, 0, r2, radius, depthwise, out, xs, w1part,
                                    w2part, stream);
}

// K10a: as bucket_conv_bwd_launch over the source cells of the bricks in ids
// (B, nba) int32, bricks of 2 x 2 x bz cells (R even, bz | R). The partials
// keep bucket_conv_bwd_launch's shapes and places; the rows of unvisited
// cells, and the out rows of their sources, are not written.
extern "C" int bucket_conv_bwd_active_launch(const void* smp_pos, const void* smp_pts,
                                             const void* smp_cnt, const void* src_pos,
                                             const void* src_pts, const void* src_cnt,
                                             const void* wf, const void* u, const void* dg,
                                             const void* w1, const void* b1, const void* w2,
                                             const void* b2, const void* ids, int B, int M,
                                             int N, int C, int KU, int H, int R, int capS,
                                             int capP, int npc, int nba, int bz, float r2,
                                             float radius, int depthwise, void* out, void* xs,
                                             void* w1part, void* w2part, void* stream) {
  return bucket_conv_bwd_run<true>(smp_pos, smp_pts, smp_cnt, src_pos, src_pts, src_cnt, wf, u,
                                   dg, w1, b1, w2, b2, ids, B, M, N, C, KU, H, R, capS, capP, npc,
                                   nba, bz, r2, radius, depthwise, out, xs, w1part, w2part,
                                   stream);
}
