// K10: the Monte-Carlo convolution over cell-bucket layouts, backward.
//
// Replaces mccnn_tpu/ops/pallas/mcconv_kernel.py::_bwd_kernel (:366, called at
// :662 through _bwd_call from the custom_vjp of bucket_mc_conv). K9
// (bucket_conv.cu) forms G[b,i,h,c] = sum_j a_h(i,j) f~[b,j,c] over the kept
// sources of the 27 cells around each kept sample's cell, and out = s_i * (G .
// [W2; b2]). With t = s * dout (the cotangent of the projection) and
// dG[i,h,c] = sum_o t[i,o] Wcat[h,c,o], for every kept source j of a cell and
// every kept sample i in the 27 cells around it with d2(i, j) <= r2 (the same
// pairs: the windows are symmetric):
//
//   X[j,h,o]    = sum_i a_h(i,j) t[i,o]                 (a_H = 1)
//   dpre_h(i,j) = [pre_h(i,j) > 0] sum_c dG[i,h,c] f~[j,c]
//   dW1[k,h]    = sum dpre_h (p_j - x_i)_k / r,   db1[h] = sum dpre_h
//
// and from X: d_f~[j,c] = sum_{h,o} X[j,h,o] Wcat[h,c,o] and dWcat[h,c,o] =
// sum_j f~[j,c] X[j,h,o], as K6 (tile_conv_bwd.cu) forms them.
//
// The TPU kernel sweeps bricks of source cells in order, each with its window
// of sample cells, writes each source slot's d(wf) once and accumulates the
// parameter gradients across the sequential grid. On the H100 a block takes
// one (cloud, source cell, chunk of up to 128 of its slots, channel slice of
// 16): a block over an empty cell exits after one read. It stages its
// sources' positions (from the layout) and f~ slice (by point index), gathers
// the 27 sample cells' kept counts into a prefix table and walks the window's
// kept samples in chunks of 16, staging their positions, t and dG slices (by
// point index: dout is never scattered into slot order), then as K6:
//   - the (16, H+1, TP) a_h plane with the expressions of K1, K2, K5, K6 and
//     K9 (common.cuh), so a pair's a_h and ReLU step are K9's;
//   - each thread accumulates up to 8 (source, channel) outputs of X for all
//     H+1 rows in registers;
//   - dpre over the channel slice for each pair with a_h > 0 into four
//     registers of a fixed h = thread % H (a depthwise site forms dG = t W2
//     there from t and the block's W2 slice, staging no dG rows).
// Depthwise sites project X in the epilogue and write a per-block partial of
// [dW2; db2]; the full site writes X, and K2's GEMMs form d_f~ and dWcat from
// it, and dG before it. Every d_f~ / X row has one writer (point order by
// point_of_slot); per-block partials of dW1 / db1 / [dW2; db2] are summed in
// block order by K2's reduction kernel: no float atomics, two calls are
// bit-identical. A block over an empty cell writes no partial, so the wrapper
// zeroes them.
//
// What bounds it on the H100: the pair arithmetic, as K9 and K6. Everything is
// fp32 (the TPU kernel holds planes, features and the cotangent in bf16).
// Limits: H == 8, channel slices of at most 16, C and c_out <= 1024.
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

#include "common.cuh"

namespace {

constexpr int kTP = 128;      // largest chunk of a source cell's slots a block takes
constexpr int kTJ = 16;       // samples per shared-memory chunk
constexpr int kThreads = 256; // a multiple of H (see the dpre loop)
constexpr int kOut = 8;       // (source, channel) outputs per thread
constexpr int kMaxCB = 16;    // channels per block (== kTJ: the epilogue reuses the plane)

template <int H, bool kActive>
__global__ void __launch_bounds__(kThreads)
bucket_conv_bwd_kernel(const float* __restrict__ smp_pos, const int* __restrict__ smp_pts,
                       const int* __restrict__ smp_cnt, const float* __restrict__ src_pos,
                       const int* __restrict__ src_pts, const int* __restrict__ src_cnt,
                       const float* __restrict__ wf, const float* __restrict__ u,
                       const float* __restrict__ dg, const float* __restrict__ w1,
                       const float* __restrict__ b1, const float* __restrict__ w2,
                       const float* __restrict__ b2, const int* __restrict__ ids, int nba,
                       int bz, int M, int N, int C, int KU, int R,
                       int capS, int capP, int TP, int npc, int CB, float r2, float radius,
                       int depthwise, float* __restrict__ out, float* __restrict__ w1part,
                       float* __restrict__ w2part) {
  constexpr int H1 = H + 1;
  extern __shared__ float sm[];
  float* plane = sm;                         // [kTJ][H1][TP]; the epilogue's [TP][H1][kMaxCB]
  float* su = plane + kTJ * H1 * TP;         // [kTJ][kMaxCB]: t of the chunk's samples
  float* sdg = su + kTJ * kMaxCB;            // [kTJ][H][kMaxCB]: their dG
  float* sfeat = sdg + kTJ * H * kMaxCB;     // [TP][kMaxCB]: f~ of the block's sources
  float* ppos = sfeat + TP * kMaxCB;         // [TP][4]: x, y, z, |p|^2
  float* qpos = ppos + TP * 4;               // [kTJ][4]
  float* sw1 = qpos + kTJ * 4;               // [3][H]
  float* sb1 = sw1 + 3 * H;                  // [H]
  float* sw2 = sb1 + H;                      // [H][kMaxCB]: the W2 slice (depthwise)
  float* sred = sw2 + H * kMaxCB;            // [kThreads][4]
  int* pidx = reinterpret_cast<int*>(sred + 4 * kThreads);  // [TP]
  int* qidx = pidx + TP;                                    // [kTJ]
  int* wcell = qidx + kTJ;                                  // [27]
  int* wstart = wcell + 27;                                 // [28]

  const int Rp = R + 2;
  const size_t cells = (size_t)Rp * Rp * Rp;
  const int cb = blockIdx.y, b = blockIdx.z;
  int cell, chunk;
  if (kActive) {
    cell = bucket_brick_cell(ids + (size_t)b * nba, blockIdx.x, npc, R, bz, &chunk);
  } else {
    cell = blockIdx.x / npc;
    chunk = blockIdx.x % npc;
  }
  const int pid = bucket_padded_cell(cell, R);
  const int s0 = chunk * TP;
  const int np = min(TP, src_cnt[b * cells + pid] - s0);
  if (np <= 0) return;  // the whole block leaves before any barrier; its partials stay 0
  const int c0 = cb * CB;
  const int nx = min(CB, KU - c0);  // X channels of this block (may be <= 0)
  const int nd = min(CB, C - c0);   // dpre channels of this block (may be <= 0)

  const size_t sslots = cells * capS + 1, pslots = cells * capP + 1;
  for (int s = threadIdx.x; s < np; s += blockDim.x) {
    const size_t slot = b * pslots + (size_t)pid * capP + s0 + s;
    const float x = src_pos[3 * slot], y = src_pos[3 * slot + 1], z = src_pos[3 * slot + 2];
    ppos[4 * s] = x;
    ppos[4 * s + 1] = y;
    ppos[4 * s + 2] = z;
    ppos[4 * s + 3] = sq_norm_rn(x, y, z);
    pidx[s] = src_pts[slot];
  }
  for (int i = threadIdx.x; i < 3 * H; i += blockDim.x) sw1[i] = w1[i];
  for (int i = threadIdx.x; i < H; i += blockDim.x) sb1[i] = b1[i];
  for (int i = threadIdx.x; i < H * kMaxCB; i += blockDim.x) {
    const int h = i / kMaxCB, cl = i % kMaxCB;
    sw2[i] = depthwise && cl < nd ? w2[h * C + c0 + cl] : 0.f;
  }
  const int total = bucket_window_prefix(smp_cnt + b * cells, pid, Rp, wcell, wstart);
  for (int i = threadIdx.x; i < np * kMaxCB; i += blockDim.x) {
    const int s = i / kMaxCB, cl = i % kMaxCB;
    sfeat[i] = cl < nd ? wf[((size_t)b * N + pidx[s]) * C + c0 + cl] : 0.f;
  }
  __syncthreads();

  float acc[kOut][H1];
#pragma unroll
  for (int k = 0; k < kOut; ++k)
#pragma unroll
    for (int h = 0; h < H1; ++h) acc[k][h] = 0.f;
  // blockDim is a multiple of H, so this thread's dpre items all share h.
  float gx = 0.f, gy = 0.f, gz = 0.f, gb = 0.f;
  const int nout = np * CB;

  for (int j0 = 0; j0 < total; j0 += kTJ) {
    const int nj = min(kTJ, total - j0);
    __syncthreads();  // the previous chunk's plane and slices are consumed
    for (int t = threadIdx.x; t < nj; t += blockDim.x) {
      const size_t slot = b * sslots + bucket_window_slot(wcell, wstart, j0 + t, capS);
      const float x = smp_pos[3 * slot], y = smp_pos[3 * slot + 1], z = smp_pos[3 * slot + 2];
      qpos[4 * t] = x;
      qpos[4 * t + 1] = y;
      qpos[4 * t + 2] = z;
      qpos[4 * t + 3] = sq_norm_rn(x, y, z);
      qidx[t] = smp_pts[slot];
    }
    __syncthreads();
    for (int i = threadIdx.x; i < nj * kMaxCB; i += blockDim.x) {
      const int j = i / kMaxCB, cl = i % kMaxCB;
      su[i] = cl < nx ? u[((size_t)b * M + qidx[j]) * KU + c0 + cl] : 0.f;
    }
    // dG rows of the full conv; a depthwise dG is t * W2, formed in the dpre
    // loop from su and the block's W2 slice
    for (int i = threadIdx.x; !depthwise && i < nj * H * kMaxCB; i += blockDim.x) {
      const int j = i / (H * kMaxCB), h = (i / kMaxCB) % H, cl = i % kMaxCB;
      const size_t row = (size_t)b * M + qidx[j];
      sdg[i] = cl < nd ? dg[(row * H1 + h) * C + c0 + cl] : 0.f;
    }
    for (int i = threadIdx.x; i < nj * np; i += blockDim.x) {
      const int j = i / np, s = i % np;
      mc_ah_column<H>(plane + (size_t)j * H1 * TP + s, TP, qpos[4 * j], qpos[4 * j + 1],
                      qpos[4 * j + 2], qpos[4 * j + 3], ppos[4 * s], ppos[4 * s + 1],
                      ppos[4 * s + 2], ppos[4 * s + 3], sw1, sb1, r2, radius);
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < kOut; ++k) {
      const int q = threadIdx.x + k * kThreads;
      if (q < nout) {
        const int s = q / CB, cl = q % CB;
        for (int j = 0; j < nj; ++j) {
          const float tv = su[j * kMaxCB + cl];
          const float* pl = plane + (size_t)j * H1 * TP + s;
#pragma unroll
          for (int h = 0; h < H1; ++h) acc[k][h] += pl[h * TP] * tv;
        }
      }
    }
    if (nd > 0) {
      for (int q = threadIdx.x; q < nj * np * H; q += blockDim.x) {
        const int h = q % H, pr = q / H;
        const int j = pr / np, s = pr % np;
        if (plane[((size_t)j * H1 + h) * TP + s] > 0.f) {
          const float* fp = sfeat + (size_t)s * kMaxCB;
          float d = 0.f;
          if (depthwise) {
            const float* tq = su + (size_t)j * kMaxCB;
            const float* wq = sw2 + (size_t)h * kMaxCB;
            for (int cl = 0; cl < nd; ++cl) d += (tq[cl] * wq[cl]) * fp[cl];
          } else {
            const float* gq = sdg + ((size_t)j * H + h) * kMaxCB;
            for (int cl = 0; cl < nd; ++cl) d += gq[cl] * fp[cl];
          }
          gx += d * mc_offset(ppos[4 * s], qpos[4 * j], radius);
          gy += d * mc_offset(ppos[4 * s + 1], qpos[4 * j + 1], radius);
          gz += d * mc_offset(ppos[4 * s + 2], qpos[4 * j + 2], radius);
          gb += d;
        }
      }
    }
  }

  __syncthreads();  // the plane becomes the epilogue's reduction buffer
  float* red = plane;  // [TP][H1][kMaxCB]
#pragma unroll
  for (int k = 0; k < kOut; ++k) {
    const int q = threadIdx.x + k * kThreads;
    if (q >= nout) continue;
    const int s = q / CB, cl = q % CB;
    if (cl >= nx) continue;
    const int c = c0 + cl;
    const size_t r = (size_t)b * N + pidx[s];
    if (depthwise) {
      float o = 0.f;
#pragma unroll
      for (int h = 0; h < H; ++h) o += acc[k][h] * w2[h * C + c];
      o += acc[k][H] * b2[c];
      out[r * C + c] = o;
      const float f = sfeat[s * kMaxCB + cl];
#pragma unroll
      for (int h = 0; h < H1; ++h) red[((size_t)s * H1 + h) * kMaxCB + cl] = f * acc[k][h];
    } else {
#pragma unroll
      for (int h = 0; h < H1; ++h) out[(r * H1 + h) * KU + c] = acc[k][h];
    }
  }
  float* rw = sred + 4 * threadIdx.x;
  rw[0] = gx;
  rw[1] = gy;
  rw[2] = gz;
  rw[3] = gb;
  __syncthreads();
  const size_t block_id = ((size_t)b * R * R * R + cell) * npc + chunk;
  if (threadIdx.x < 4 * H) {
    const int kk = threadIdx.x / H, h = threadIdx.x % H;
    float s = 0.f;
    for (int i = h; i < (int)blockDim.x; i += H) s += sred[4 * i + kk];
    w1part[((block_id * gridDim.y + cb) * 4 + kk) * H + h] = s;
  }
  if (depthwise) {
    for (int i = threadIdx.x; i < H1 * nx; i += blockDim.x) {
      const int h = i / nx, cl = i % nx;
      float s = 0.f;
      for (int p = 0; p < np; ++p) s += red[((size_t)p * H1 + h) * kMaxCB + cl];
      w2part[(block_id * H1 + h) * C + c0 + cl] = s;
    }
  }
}

size_t bwd_smem(int H, int TP) {
  return sizeof(float) * ((size_t)kTJ * (H + 1) * TP + kTJ * kMaxCB + (size_t)kTJ * H * kMaxCB +
                          (size_t)TP * kMaxCB + TP * 4 + kTJ * 4 + 3 * H + H + H * kMaxCB +
                          4 * kThreads) +
         sizeof(int) * (TP + kTJ + 27 + 28);
}

template <bool kActive>
int bucket_conv_bwd_run(const void* smp_pos, const void* smp_pts, const void* smp_cnt,
                        const void* src_pos, const void* src_pts, const void* src_cnt,
                        const void* wf, const void* u, const void* dg, const void* w1,
                        const void* b1, const void* w2, const void* b2, const void* ids, int B,
                        int M, int N, int C, int KU, int H, int R, int capS, int capP, int TP,
                        int npc, int CB, int nba, int bz, float r2, float radius, int depthwise,
                        void* out, void* w1part, void* w2part, void* stream) {
  const int wide = C > KU ? C : KU;
  if (H != 8 || C < 1 || KU < 1 || C > 1024 || KU > 1024 || CB < 1 || CB > kMaxCB ||
      TP < 1 || TP > kTP || (long long)TP * npc < capP || TP * CB > kThreads * kOut || B < 1 ||
      B > 65535 || R < 1 || (depthwise && KU != C))
    return static_cast<int>(cudaErrorInvalidValue);
  if (kActive && (ids == nullptr || bz < 1 || R % 2 || R % bz || nba < 1 ||
                  nba > (R / 2) * (R / 2) * (R / bz)))
    return static_cast<int>(cudaErrorInvalidValue);
  const long long cells = kActive ? (long long)nba * 4 * bz : (long long)R * R * R;
  const long long nblocks = cells * npc;
  if (nblocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = bwd_smem(H, TP);
  cudaError_t err = cudaFuncSetAttribute(
      bucket_conv_bwd_kernel<8, kActive>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid((unsigned)nblocks, (wide + CB - 1) / CB, B);
  bucket_conv_bwd_kernel<8, kActive><<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(smp_pos), static_cast<const int*>(smp_pts),
      static_cast<const int*>(smp_cnt), static_cast<const float*>(src_pos),
      static_cast<const int*>(src_pts), static_cast<const int*>(src_cnt),
      static_cast<const float*>(wf), static_cast<const float*>(u),
      static_cast<const float*>(dg), static_cast<const float*>(w1),
      static_cast<const float*>(b1), static_cast<const float*>(w2),
      static_cast<const float*>(b2), static_cast<const int*>(ids), nba, bz, M, N, C, KU, R, capS,
      capP, TP, npc, CB, r2, radius, depthwise, static_cast<float*>(out),
      static_cast<float*>(w1part), static_cast<float*>(w2part));
  MCCNN_LAUNCH_RETURN();
}

}  // namespace

// Layouts as bucket_conv_launch's. u: t (B, M, KU) in sample point order.
// dg: dG (B, M, H+1, C) for the full conv (unread when depthwise). out: d_f~
// (B, N, C) when depthwise, else X (B, N, H+1, KU), in source point order;
// rows of sources the layout does not keep are not written. A block is
// (R^3 * npc cell chunks) x (ceil(max(C, KU) / CB) channel slices) x B;
// w1part: (B * R^3 * npc * slices, 4, H) partials of [dW1; db1]; w2part:
// (B * R^3 * npc, H+1, C) partials of [dW2; db2] (depthwise only).
extern "C" int bucket_conv_bwd_launch(const void* smp_pos, const void* smp_pts,
                                      const void* smp_cnt, const void* src_pos,
                                      const void* src_pts, const void* src_cnt, const void* wf,
                                      const void* u, const void* dg, const void* w1,
                                      const void* b1, const void* w2, const void* b2, int B,
                                      int M, int N, int C, int KU, int H, int R, int capS,
                                      int capP, int TP, int npc, int CB, float r2, float radius,
                                      int depthwise, void* out, void* w1part, void* w2part,
                                      void* stream) {
  return bucket_conv_bwd_run<false>(smp_pos, smp_pts, smp_cnt, src_pos, src_pts, src_cnt, wf, u,
                                    dg, w1, b1, w2, b2, nullptr, B, M, N, C, KU, H, R, capS,
                                    capP, TP, npc, CB, 0, 0, r2, radius, depthwise, out, w1part,
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
                                             int capP, int TP, int npc, int CB, int nba, int bz,
                                             float r2, float radius, int depthwise, void* out,
                                             void* w1part, void* w2part, void* stream) {
  return bucket_conv_bwd_run<true>(smp_pos, smp_pts, smp_cnt, src_pos, src_pts, src_cnt, wf, u,
                                   dg, w1, b1, w2, b2, ids, B, M, N, C, KU, H, R, capS, capP, TP,
                                   npc, CB, nba, bz, r2, radius, depthwise, out, w1part, w2part,
                                   stream);
}
