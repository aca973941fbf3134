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
// block takes one (cloud, sample cell, chunk of up to 128 of its slots,
// channel slice of CB): a block over an empty cell exits after one read. It
// gathers the 27 cells' kept source counts into a prefix table and walks the
// window's kept sources in chunks of 16 (9 z-runs of 3 cells in slot order;
// empty slots are never read), staging their positions (from the layout) and
// the CB-channel slice of f~ (by point index through point_of_slot). It fills
// the (16, H+1, TS) a_h plane with the expressions that K1, K2, K5 and K6 use
// (pair_d2_rn, mc_offset, mc_preact in common.cuh: one a_h definition, not
// the reference's factorised cw_h - sw_h + b1_h, which rounds differently),
// and each thread accumulates up to 8 (sample, channel) outputs for all H+1
// rows in registers. Outputs go to point order by point_of_slot: one writer
// per row, no atomics, and sums run in window order, so two calls are
// bit-identical.
//
// What bounds it on the H100: the pair arithmetic. Each candidate pair costs
// a d2 and H pre-activations (once per block, shared by its CB channels),
// then (H+1) FMAs per channel. Everything is fp32 (the TPU kernel holds
// features in bf16). Limits: H == 8, C <= 1024.
//
// K9a (kActive) is the same kernel over a list of bricks: it replaces
// _fwd_kernel (:293) as called at :570 with a PrefetchScalarGridSpec, the
// reference's `max_active_bricks`, which sweeps only the first NBA bricks
// (2 x 2 x BZ sample cells) of each cloud's list, occupied bricks first. The
// TPU prefetches the list as scalars for its index maps; here each block reads
// its brick id from the list (bucket_brick_cell) and runs K9's per-cell body
// unchanged, over the whole source layout as the reference's window DMAs
// fetch it. Its grid is (NBA x 4 BZ cells x slot chunks, channel slices,
// clouds). A visited cell's outputs are K9's bit for bit; the rows of the
// other samples keep the zeros the wrapper allocated (the reference leaves
// them uninitialised and masks them afterwards). What bounds it: K9's pair
// arithmetic over the visited cells only; it saves the launches of the
// blocks of unvisited cells, each of which K9 retires after one read.

#include "common.cuh"

namespace {

constexpr int kTS = 128;      // largest chunk of a sample cell's slots a block takes
constexpr int kTJ = 16;       // sources per shared-memory chunk
constexpr int kThreads = 256;
constexpr int kOut = 8;       // (sample, channel) outputs per thread
constexpr int kMaxCB = 64;    // channels per block

template <int H, bool kActive>
__global__ void __launch_bounds__(kThreads)
bucket_conv_kernel(const float* __restrict__ smp_pos, const int* __restrict__ smp_pts,
                   const int* __restrict__ smp_cnt, const float* __restrict__ src_pos,
                   const int* __restrict__ src_pts, const int* __restrict__ src_cnt,
                   const float* __restrict__ wf, const float* __restrict__ w1,
                   const float* __restrict__ b1, const float* __restrict__ w2,
                   const float* __restrict__ b2, const int* __restrict__ ids, int nba, int bz,
                   int M, int N, int C, int CB, int R, int capS, int capP, int TS, int nsc,
                   float r2, float radius, int mean, int depthwise, float* __restrict__ out,
                   float* __restrict__ cnt) {
  constexpr int H1 = H + 1;
  extern __shared__ float sm[];
  float* plane = sm;                      // [kTJ][H1][TS]
  float* sfeat = plane + kTJ * H1 * TS;   // [kTJ][kMaxCB]
  float* spos = sfeat + kTJ * kMaxCB;     // [kTJ][4]: x, y, z, |p|^2
  float* qpos = spos + kTJ * 4;           // [TS][4]
  float* sw1 = qpos + TS * 4;             // [3][H]
  float* sb1 = sw1 + 3 * H;               // [H]
  int* qidx = reinterpret_cast<int*>(sb1 + H);  // [TS]: the samples' point indices
  int* pidx = qidx + TS;                        // [kTJ]: the chunk's source point indices
  int* wcell = pidx + kTJ;                      // [27]
  int* wstart = wcell + 27;                     // [28]

  const int Rp = R + 2;
  const size_t cells = (size_t)Rp * Rp * Rp;
  const int cb = blockIdx.y, b = blockIdx.z;
  int cell, chunk;
  if (kActive) {
    cell = bucket_brick_cell(ids + (size_t)b * nba, blockIdx.x, nsc, R, bz, &chunk);
  } else {
    cell = blockIdx.x / nsc;
    chunk = blockIdx.x % nsc;
  }
  const int pid = bucket_padded_cell(cell, R);
  const int s0 = chunk * TS;
  const int ns = min(TS, smp_cnt[b * cells + pid] - s0);
  if (ns <= 0) return;  // the whole block leaves before any barrier
  const int c0 = cb * CB;
  const int nc = min(CB, C - c0);

  const size_t sslots = cells * capS + 1, pslots = cells * capP + 1;
  for (int s = threadIdx.x; s < ns; s += blockDim.x) {
    const size_t slot = b * sslots + (size_t)pid * capS + s0 + s;
    const float x = smp_pos[3 * slot], y = smp_pos[3 * slot + 1], z = smp_pos[3 * slot + 2];
    qpos[4 * s] = x;
    qpos[4 * s + 1] = y;
    qpos[4 * s + 2] = z;
    qpos[4 * s + 3] = sq_norm_rn(x, y, z);
    qidx[s] = smp_pts[slot];
  }
  for (int i = threadIdx.x; i < 3 * H; i += blockDim.x) sw1[i] = w1[i];
  for (int i = threadIdx.x; i < H; i += blockDim.x) sb1[i] = b1[i];
  const int total = bucket_window_prefix(src_cnt + b * cells, pid, Rp, wcell, wstart);

  float acc[kOut][H1];
  float count[kOut];
#pragma unroll
  for (int k = 0; k < kOut; ++k) {
    count[k] = 0.f;
#pragma unroll
    for (int h = 0; h < H1; ++h) acc[k][h] = 0.f;
  }
  const int nout = ns * CB;
  const float* F = wf + (size_t)b * N * C;

  for (int j0 = 0; j0 < total; j0 += kTJ) {
    const int nj = min(kTJ, total - j0);
    __syncthreads();  // the previous chunk's plane and rows are consumed
    for (int t = threadIdx.x; t < nj; t += blockDim.x) {
      const size_t slot = b * pslots + bucket_window_slot(wcell, wstart, j0 + t, capP);
      const float x = src_pos[3 * slot], y = src_pos[3 * slot + 1], z = src_pos[3 * slot + 2];
      spos[4 * t] = x;
      spos[4 * t + 1] = y;
      spos[4 * t + 2] = z;
      spos[4 * t + 3] = sq_norm_rn(x, y, z);
      pidx[t] = src_pts[slot];
    }
    __syncthreads();
    for (int i = threadIdx.x; i < nj * CB; i += blockDim.x) {
      const int j = i / CB, cl = i % CB;
      sfeat[j * kMaxCB + cl] = cl < nc ? F[(size_t)pidx[j] * C + c0 + cl] : 0.f;
    }
    for (int i = threadIdx.x; i < nj * ns; i += blockDim.x) {
      const int j = i / ns, s = i % ns;
      mc_ah_column<H>(plane + (size_t)j * H1 * TS + s, TS, qpos[4 * s], qpos[4 * s + 1],
                      qpos[4 * s + 2], qpos[4 * s + 3], spos[4 * j], spos[4 * j + 1],
                      spos[4 * j + 2], spos[4 * j + 3], sw1, sb1, r2, radius);
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < kOut; ++k) {
      const int q = threadIdx.x + k * kThreads;
      if (q < nout) {
        const int s = q / CB, cl = q % CB;
        for (int j = 0; j < nj; ++j) {
          const float f = sfeat[j * kMaxCB + cl];
          const float* pl = plane + (size_t)j * H1 * TS + s;
#pragma unroll
          for (int h = 0; h < H1; ++h) acc[k][h] += pl[h * TS] * f;
          count[k] += pl[H * TS];
        }
      }
    }
  }
#pragma unroll
  for (int k = 0; k < kOut; ++k) {
    const int q = threadIdx.x + k * kThreads;
    if (q >= nout) continue;
    const int s = q / CB, cl = q % CB;
    if (cl >= nc) continue;
    const int c = c0 + cl;
    const size_t r = (size_t)b * M + qidx[s];
    if (depthwise) {
      float o = 0.f;
#pragma unroll
      for (int h = 0; h < H; ++h) o += acc[k][h] * w2[h * C + c];
      o += acc[k][H] * b2[c];
      const float scale = mean ? 1.f / fmaxf(count[k], 1.f) : 1.f;
      out[r * C + c] = o * scale;
    } else {
#pragma unroll
      for (int h = 0; h < H1; ++h) out[(r * H1 + h) * C + c] = acc[k][h];
    }
    if (c == 0) cnt[r] = count[k];
  }
}

template <bool kActive>
int bucket_conv_run(const void* smp_pos, const void* smp_pts, const void* smp_cnt,
                    const void* src_pos, const void* src_pts, const void* src_cnt, const void* wf,
                    const void* w1, const void* b1, const void* w2, const void* b2,
                    const void* ids, int B, int M, int N, int C, int H, int R, int capS,
                    int capP, int nba, int bz, float r2, float radius, int mean, int depthwise,
                    void* out, void* cnt, void* stream) {
  if (H != 8 || C < 1 || C > 1024 || B < 1 || B > 65535 || R < 1 || capS < 1 || capP < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  if (kActive && (ids == nullptr || bz < 1 || R % 2 || R % bz || nba < 1 ||
                  nba > (R / 2) * (R / 2) * (R / bz)))
    return static_cast<int>(cudaErrorInvalidValue);
  const int TS = capS < kTS ? capS : kTS;
  const int nsc = (capS + TS - 1) / TS;
  int CB = kThreads * kOut / TS;
  if (CB > kMaxCB) CB = kMaxCB;
  if (CB > C) CB = C;
  const long long cells = kActive ? (long long)nba * 4 * bz : (long long)R * R * R;
  const long long nblocks = cells * nsc;
  if (nblocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = sizeof(float) * ((size_t)kTJ * (H + 1) * TS + kTJ * kMaxCB + kTJ * 4 +
                                       TS * 4 + 3 * H + H) +
                      sizeof(int) * (TS + kTJ + 27 + 28);
  cudaError_t err = cudaFuncSetAttribute(
      bucket_conv_kernel<8, kActive>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid((unsigned)nblocks, (C + CB - 1) / CB, B);
  bucket_conv_kernel<8, kActive><<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(smp_pos), static_cast<const int*>(smp_pts),
      static_cast<const int*>(smp_cnt), static_cast<const float*>(src_pos),
      static_cast<const int*>(src_pts), static_cast<const int*>(src_cnt),
      static_cast<const float*>(wf), static_cast<const float*>(w1),
      static_cast<const float*>(b1), static_cast<const float*>(w2),
      static_cast<const float*>(b2), static_cast<const int*>(ids), nba, bz, M, N, C, CB, R,
      capS, capP, TS, nsc, r2, radius, mean, depthwise, static_cast<float*>(out),
      static_cast<float*>(cnt));
  MCCNN_LAUNCH_RETURN();
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
