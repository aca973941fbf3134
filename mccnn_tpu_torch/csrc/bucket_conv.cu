// K9: the Monte-Carlo convolution over cell-bucket layouts, forward.
//
// Replaces mccnn_tpu/ops/pallas/mcconv_kernel.py::_fwd_kernel (:293, called
// at :584 through _fwd_call from bucket_mc_conv). Both point sets are
// bucketized at cell edge = radius (mccnn_tpu_torch/core/buckets.py): an
// (R+2)^3 grid of cells with a ghost layer, `cap` slots a cell, the kept
// points of a cell in its first cell_count slots. For every kept sample i of
// a cell and every kept source j in the 27 cells around it with d2(i, j) <= r2:
//
//   G[b,i,h,c] = sum_j a_h(i,j) f~[b,j,c]   (a_h = relu(pre_h), h < H; a_H = 1)
//   cnt[b,i]   = the number of such j
//
// then out = sum_h G[.., h, c] W2[h, c] + G[.., H, c] b2[c] (depthwise, in this
// kernel's epilogue) or K1's projection GEMM (full conv, a second launch),
// times 1/cnt in mean mode.
//
// The TPU kernel sweeps 2x2xBZ bricks of sample cells in order, with their
// 4x4x(BZ+2) source windows double-buffered into VMEM in block-major order,
// and factorises pre_h into per-point projections for the MXU. On the H100 a
// block owns up to 32 kept samples of one (cloud, sample cell) (a cell with
// more takes several blocks); a block over an empty cell exits after one
// read, before any barrier. It gathers the 27 cells' kept source counts into
// a prefix table and stages the window's kept sources in window order (9
// z-runs of 3 cells, slot order; empty slots are never read), up to 1024 at
// once, with their point indices, and runs the body of list_fwd.cuh, which
// K5 runs too: one d2 test a candidate pair into each sample's list of
// in-radius sources (a_h with the expressions of K1, K2, K5, K6 and K10,
// common.cuh, for listed pairs alone: one a_h definition, not the
// reference's factorised cw_h - sw_h + b1_h, which rounds differently), then
// the contraction over all channels of its samples, f~ read from L2 by point
// index. The pass is sized to the samples the block really has: a thread
// holds 4 channels, so n samples take passes of 4 * floor(256 / n) channels
// (at the full conv of C <= 4 the 9 rows of each sample go to 9 threads).
// Outputs go to point order by point_of_slot: one writer per row, no
// atomics, and sums run in window order, so two calls are bit-identical, and
// out and cnt are bit for bit those of the kernel that formed an a_h plane
// for every window pair with a 64-channel block grid (its FMA chains minus
// their exact zeros).
//
// What bounds it on the H100: the in-radius pairs' arithmetic (8
// pre-activations and (H+1) FFMAs a channel) and their f~ rows read from L2;
// every other window pair (2.3-4.2x as many at MCSeg's sites) costs one d2
// test on staged positions. Everything is fp32 (the TPU kernel holds
// features in bf16). Limits: H == 8, C <= 1024.
//
// K9a (kActive) is the same kernel over a list of bricks: it replaces
// _fwd_kernel (:293) as called at :570 with a PrefetchScalarGridSpec, the
// reference's `max_active_bricks`, which sweeps only the first NBA bricks
// (2 x 2 x BZ sample cells) of each cloud's list, occupied bricks first. The
// TPU prefetches the list as scalars for its index maps; here each block reads
// its cell from the list (bucket_brick_cell) and runs K9's body unchanged,
// over the whole source layout as the reference's window DMAs fetch it. Its
// grid is (NBA x 4 BZ cells x slot chunks, clouds). A visited cell's outputs
// are K9's bit for bit; the rows of the other samples keep the zeros the
// wrapper allocated (the reference leaves them uninitialised and masks them
// afterwards). What bounds it: K9's pair arithmetic over the visited cells
// only; it saves the launches of the blocks of unvisited cells, each of
// which K9 retires after one read.

#include "list_fwd.cuh"

namespace {

constexpr int kOwners = list_fwd::kMaxOwners;  // kept samples a block

template <bool kActive, int HPT>
__global__ void __launch_bounds__(HPT == 1 ? list_fwd::kRowThreads : list_fwd::kThreads)
    bucket_conv_kernel(const float* __restrict__ smp_pos, const int* __restrict__ smp_pts,
                       const int* __restrict__ smp_cnt, const float* __restrict__ src_pos,
                       const int* __restrict__ src_pts, const int* __restrict__ src_cnt,
                       const float* __restrict__ wf, const int* __restrict__ ids, int nba,
                       int bz, int R, int capS, int capP, int nsc, int N,
                       const __grid_constant__ list_fwd::Args a) {
  const int Rp = R + 2;
  const size_t cells = (size_t)Rp * Rp * Rp;
  const int b = blockIdx.y;
  int cell, chunk;
  if (kActive) {
    cell = bucket_brick_cell(ids + (size_t)b * nba, blockIdx.x, nsc, R, bz, &chunk);
  } else {
    cell = blockIdx.x / nsc;
    chunk = blockIdx.x % nsc;
  }
  const int pid = bucket_padded_cell(cell, R);
  const int s0 = chunk * kOwners;
  const int ns = min(kOwners, smp_cnt[b * cells + pid] - s0);
  if (ns <= 0) return;  // the whole block leaves before any barrier

  extern __shared__ __align__(16) char smem[];
  const list_fwd::Smem S = list_fwd::carve(smem);
  const size_t sslots = cells * capS + 1;
  for (int s = threadIdx.x; s < ns; s += blockDim.x) {
    const size_t slot = b * sslots + (size_t)pid * capS + s0 + s;
    const float x = smp_pos[3 * slot], y = smp_pos[3 * slot + 1], z = smp_pos[3 * slot + 2];
    S.qpos[s] = make_float4(x, y, z, sq_norm_rn(x, y, z));
    S.qvalid[s] = 1;
    S.qrow[s] = smp_pts[slot];
  }
  int* wcell = reinterpret_cast<int*>(S.extra);  // [27]
  int* wstart = wcell + 27;                      // [28]
  const int total = bucket_window_prefix(src_cnt + b * cells, pid, Rp, wcell, wstart);
  dense_pairs::WindowWalk walk{src_pos, src_pts, wf, wcell, wstart, b * (cells * capP + 1),
                               (size_t)b * N, a.C, capP, 0, total};
  const int runs = (a.C + dense_pairs::kCpt - 1) / dense_pairs::kCpt;
  const int tps = HPT == 1 ? 1 : min(runs, list_fwd::kThreads / ns);
  const int passes = (runs + tps - 1) / tps;
  list_fwd::owner_forward<HPT, list_fwd::kProbeNone>(a, walk, S, b, ns, list_fwd::list_cap(ns),
                                                     tps, passes, 0, a.C, true);
}

constexpr size_t kSmem = list_fwd::smem_bytes() + sizeof(int) * (27 + 28);

template <bool kActive, int HPT>
int bucket_conv_go(const void* smp_pos, const void* smp_pts, const void* smp_cnt,
                   const void* src_pos, const void* src_pts, const void* src_cnt, const void* wf,
                   const void* ids, int nba, int bz, int R, int capS, int capP, int nsc, int N,
                   long long nblocks, int B, const list_fwd::Args& a, cudaStream_t stream) {
  auto kernel = bucket_conv_kernel<kActive, HPT>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kSmem);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<dim3((unsigned)nblocks, B), HPT == 1 ? list_fwd::kRowThreads : list_fwd::kThreads,
           kSmem, stream>>>(
      static_cast<const float*>(smp_pos), static_cast<const int*>(smp_pts),
      static_cast<const int*>(smp_cnt), static_cast<const float*>(src_pos),
      static_cast<const int*>(src_pts), static_cast<const int*>(src_cnt),
      static_cast<const float*>(wf), static_cast<const int*>(ids), nba, bz, R, capS, capP, nsc,
      N, a);
  MCCNN_LAUNCH_RETURN();
}

template <bool kActive>
int bucket_conv_run(const void* smp_pos, const void* smp_pts, const void* smp_cnt,
                    const void* src_pos, const void* src_pts, const void* src_cnt, const void* wf,
                    const void* w1, const void* b1, const void* w2, const void* b2,
                    const void* ids, int B, int M, int N, int C, int H, int R, int capS,
                    int capP, int nba, int bz, float r2, float radius, int mean, int depthwise,
                    void* out, void* cnt, void* stream) {
  if (H != 8 || C < 1 || C > dense_pairs::kMaxC || B < 1 || B > 65535 || R < 1 || capS < 1 ||
      capP < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  if (kActive && (ids == nullptr || bz < 1 || R % 2 || R % bz || nba < 1 ||
                  nba > (R / 2) * (R / 2) * (R / bz)))
    return static_cast<int>(cudaErrorInvalidValue);
  const int nsc = (capS + kOwners - 1) / kOwners;
  const long long cells = kActive ? (long long)nba * 4 * bz : (long long)R * R * R;
  const long long nblocks = cells * nsc;
  if (nblocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  const list_fwd::Args a{static_cast<const float*>(w1), static_cast<const float*>(b1),
                         static_cast<const float*>(w2), static_cast<const float*>(b2),
                         C, M, r2, radius, mean, depthwise, static_cast<float*>(out),
                         static_cast<float*>(cnt)};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool rows = !depthwise && C <= dense_pairs::kCpt;  // 9 rows of a sample on 9 threads
  return rows ? bucket_conv_go<kActive, 1>(smp_pos, smp_pts, smp_cnt, src_pos, src_pts, src_cnt,
                                           wf, ids, nba, bz, R, capS, capP, nsc, N, nblocks, B,
                                           a, st)
              : bucket_conv_go<kActive, dense_pairs::kHidden + 1>(
                    smp_pos, smp_pts, smp_cnt, src_pos, src_pts, src_cnt, wf, ids, nba, bz, R,
                    capS, capP, nsc, N, nblocks, B, a, st);
}

}  // namespace

// Layouts: *_pos (B, S+1, 3) slot positions, *_pts (B, S+1) point_of_slot,
// *_cnt (B, (R+2)^3) kept points per cell. wf (B, N, C) in source point order.
// out: (B, M, C) when depthwise, else G (B, M, H+1, C); cnt (B, M). Rows of
// samples the layout does not keep are not written.
extern "C" int bucket_conv_launch(const void* smp_pos, const void* smp_pts, const void* smp_cnt,
                                  const void* src_pos, const void* src_pts, const void* src_cnt,
                                  const void* wf, const void* w1, const void* b1,
                                  const void* w2, const void* b2, int B, int M, int N, int C,
                                  int H, int R, int capS, int capP, float r2, float radius,
                                  int mean, int depthwise, void* out, void* cnt, void* stream) {
  return bucket_conv_run<false>(smp_pos, smp_pts, smp_cnt, src_pos, src_pts, src_cnt, wf, w1, b1,
                                w2, b2, nullptr, B, M, N, C, H, R, capS, capP, 0, 0, r2, radius,
                                mean, depthwise, out, cnt, stream);
}

// K9a: as bucket_conv_launch over the sample cells of the bricks in ids (B,
// nba) int32, bricks of 2 x 2 x bz cells (R even, bz | R); the rows of the
// other samples are not written.
extern "C" int bucket_conv_active_launch(const void* smp_pos, const void* smp_pts,
                                         const void* smp_cnt, const void* src_pos,
                                         const void* src_pts, const void* src_cnt,
                                         const void* wf, const void* w1, const void* b1,
                                         const void* w2, const void* b2, const void* ids, int B,
                                         int M, int N, int C, int H, int R, int capS, int capP,
                                         int nba, int bz, float r2, float radius, int mean,
                                         int depthwise, void* out, void* cnt, void* stream) {
  return bucket_conv_run<true>(smp_pos, smp_pts, smp_cnt, src_pos, src_pts, src_cnt, wf, w1, b1,
                               w2, b2, ids, B, M, N, C, H, R, capS, capP, nba, bz, r2, radius,
                               mean, depthwise, out, cnt, stream);
}
