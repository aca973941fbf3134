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
// minors ib[b, :, k] (Tm sorted samples each, Tm in {8, 16, 32, 64, 128}, a
// template parameter; the id n_minor marks none). With t = s * dout (the
// cotangent of the projection) and dG[i,h,c] = sum_o t[i,o] Wcat[h,c,o], for
// every valid pair (sample i, source j) of those tiles with d2(i, j) <= r2:
//
//   X[j,h,o]    = sum_i a_h(i,j) t[i,o]                 (a_H = 1)
//   dpre_h(i,j) = [pre_h(i,j) > 0] sum_c dG[i,h,c] f~[j,c]
//   dW1[k,h]    = sum dpre_h (p_j - x_i)_k / r,   db1[h] = sum dpre_h
//
// and from X: d_f~[j,c] = sum_{h,o} X[j,h,o] Wcat[h,c,o] and dWcat[h,c,o] =
// sum_j f~[j,c] X[j,h,o] (the reference's X_h = a_h^T ivd, then dfeat from
// X_h w2_h and dw2 from sum_p fz * X_h). Forming dW2 from X, over the pairs
// the backward list reaches, and not from the forward's G keeps the
// reference's semantics when a budget is short and the two lists drop
// different pairs; it also means K5 need not keep G at the depthwise sites.
//
// The TPU kernel runs one grid step per list step and carries dfeat across a
// tile's consecutive steps in VMEM and the parameter gradients across the
// whole grid. On the H100 a block takes one (cloud, source tile, block of CB
// channels) and walks that tile's contiguous run of steps, run[b, t] to
// run[b, t+1]: every X / d_f~ row has one writer and the sums run in step
// order. Per chunk of min(Tm, 16) samples the block stages their positions,
// flags and the CB-channel slices of t and dG, fills the (chunk, H+1, 128)
// a_h plane with the expressions of K1, K2 and K5 (pair_d2_rn, mc_offset,
// mc_preact in common.cuh, so all four agree bit for bit on a_h), and then
//   - each thread accumulates up to 8 (source, channel) outputs of X for all
//     H+1 rows in registers, as K5 does for G;
//   - dpre over the block's channel slice, for each pair with a_h > 0 (the
//     ReLU step at pre == 0 is 0), into four registers of a fixed h = thread
//     % H. dpre is linear in c, so per-block partials of dW1 and db1 over
//     channel slices sum to the whole.
// Depthwise sites project X in the epilogue (d_f~[j,c] = sum_h X[j,h,c]
// W2[h,c] + X[j,H,c] b2[c]) and write a per-block partial of [dW2; db2]
// (summed over the tile's 128 sources in a fixed order); the full site (the
// stem) writes X, and K2's GEMMs (dense_conv_bwd.cu) form d_f~ and dWcat
// from it, and dG before it. Per-block partials are summed in block order by
// K2's reduction kernel: no float atomics, two calls are bit-identical.
//
// K6p reads each sample minor from one contiguous record: Tm rows of (x, y,
// z, validity) and then the minor's Tm x KU cotangent t, fp32 (the TPU record
// bit-casts bf16); dG of the full conv stays a buffer of its own. It stages
// the values K6 stages and sums in the same order: the two are bit-equal.
//
// What bounds it on the H100: the pair arithmetic, as K5. Each candidate pair
// costs a d2 and H pre-activations, then (H+1) FMAs per channel for X and,
// within the radius, H dot products over the channel slice. The step list
// hands it about 10x more candidate than in-radius pairs. Everything is fp32
// (the TPU kernel holds planes, features and the cotangent in bf16). Invalid
// rows are masked by their flags. Limits: H == 8, T == 128, G * Tm <= 2048,
// channel blocks of at most 16.
//
// The bwd_noop probe (template parameter kNoop; tile_conv_bwd_probe.cu builds
// it) replaces the roofline probe of the TPU kernel's backward (spec.probe ==
// "bwd_noop", :718-726, MCCNN_TILE_PROBE): it walks the same steps, stages
// the same chunks (positions, flags, t and dG slices, the source tile's f~)
// and forms every pair's d2 and radius test, then writes 0 x the number of
// in-radius pairs it met (the TPU's jnp.sum(pen) * 0.0) as every output and
// partial, so every gradient is 0 and the distance work stays in the kernel.
#pragma once

#include "common.cuh"

namespace {
namespace k6 {

constexpr int kT = 128;       // sources per major tile
constexpr int kThreads = 256; // a multiple of H (see the dpre loop)
constexpr int kOut = 8;       // (source, channel) outputs per thread
constexpr int kMaxCB = kThreads * kOut / kT;  // 16 channels per block
constexpr int kMaxRows = 2048;  // candidate rows a step: G * Tm
// Rows of the a_h plane, at least the chunk: the epilogue reuses it as its
// [kT][H1][kMaxCB] reduction buffer.
constexpr int kPlaneRows = kMaxCB;

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
  int NS, NP, C, KU, CB, S, G, n_tiles, sentinel;
  float r2, radius;
  int depthwise;
  float* out;     // d_f~ (B, NP, C) when depthwise, else X (B, NP, H+1, KU)
  float* w1part;  // (B * n_tiles * channel blocks, 4, H)
  float* w2part;  // (B * n_tiles, H+1, C), depthwise only
};

template <int TM>
size_t tile_bwd_smem(int H) {
  constexpr int kTJ = TM < 16 ? TM : 16;
  return sizeof(float) * ((size_t)kPlaneRows * (H + 1) * kT + kTJ * kMaxCB +
                          (size_t)kTJ * H * kMaxCB +
                          kT * kMaxCB + kT * 4 + kTJ * 4 + 3 * H + H + 4 * kThreads) +
         sizeof(int) * (kMaxRows / TM) + kT + kTJ;
}

template <int H, int TM, bool kPacked, bool kNoop>
__global__ void __launch_bounds__(kThreads) tile_conv_bwd_kernel(const TileBwdArgs a) {
  constexpr int H1 = H + 1;
  constexpr int kTJ = TM < 16 ? TM : 16;  // samples per shared-memory chunk
  extern __shared__ float sm[];
  float* plane = sm;                         // [kTJ][H1][kT]; the epilogue's [kT][H1][kMaxCB]
  float* su = plane + kPlaneRows * H1 * kT;  // [kTJ][kMaxCB]: t of the chunk's samples
  float* sdg = su + kTJ * kMaxCB;            // [kTJ][H][kMaxCB]: their dG
  float* sfeat = sdg + kTJ * H * kMaxCB;     // [kT][kMaxCB]: f~ of the tile's sources
  float* ppos = sfeat + kT * kMaxCB;         // [kT][4]: x, y, z, |p|^2
  float* qpos = ppos + kT * 4;               // [kTJ][4]
  float* sw1 = qpos + kTJ * 4;               // [3][H]
  float* sb1 = sw1 + 3 * H;                  // [H]
  float* sred = sb1 + H;                     // [kThreads][4]
  int* sj = reinterpret_cast<int*>(sred + 4 * kThreads);          // [kMaxRows / TM]
  uint8_t* pvld = reinterpret_cast<uint8_t*>(sj + kMaxRows / TM);  // [kT]
  uint8_t* qvld = pvld + kT;                                       // [kTJ]

  const int C = a.C, KU = a.KU, CB = a.CB, G = a.G;
  const float radius = a.radius;
  const int cb = blockIdx.x, t = blockIdx.y, b = blockIdx.z;
  const int c0 = cb * CB;
  const int nx = min(CB, KU - c0);  // X channels of this block (may be <= 0)
  const int nd = min(CB, C - c0);   // dpre channels of this block (may be <= 0)
  const size_t prow0 = (size_t)b * a.NP + (size_t)t * kT;

  for (int s = threadIdx.x; s < kT; s += blockDim.x) {
    const float* p = a.src + 3 * (prow0 + s);
    ppos[4 * s] = p[0];
    ppos[4 * s + 1] = p[1];
    ppos[4 * s + 2] = p[2];
    ppos[4 * s + 3] = sq_norm_rn(p[0], p[1], p[2]);
    pvld[s] = a.pvalid[prow0 + s];
  }
  for (int i = threadIdx.x; i < kT * kMaxCB; i += blockDim.x) {
    const int s = i / kMaxCB, cl = i % kMaxCB;
    sfeat[i] = cl < nd ? a.wf[(prow0 + s) * C + c0 + cl] : 0.f;
  }
  for (int i = threadIdx.x; i < 3 * H; i += blockDim.x) sw1[i] = a.w1[i];
  for (int i = threadIdx.x; i < H; i += blockDim.x) sb1[i] = a.b1[i];

  float acc[kOut][H1];
#pragma unroll
  for (int k = 0; k < kOut; ++k)
#pragma unroll
    for (int h = 0; h < H1; ++h) acc[k][h] = 0.f;
  // blockDim is a multiple of H, so this thread's dpre items all share h.
  float gx = 0.f, gy = 0.f, gz = 0.f, gb = 0.f;
  float met = 0.f;  // bwd_noop: the in-radius pairs this thread met
  const int nout = kT * CB;
  const int k0 = a.run[(size_t)b * (a.n_tiles + 1) + t];
  const int k1 = a.run[(size_t)b * (a.n_tiles + 1) + t + 1];

  for (int step = k0; step < k1; ++step) {
    __syncthreads();  // the previous step's minor ids and chunks are consumed
    for (int g = threadIdx.x; g < G; g += blockDim.x)
      sj[g] = a.j_ids[((size_t)b * G + g) * a.S + step];
    __syncthreads();
    for (int g = 0; g < G; ++g) {
      const int m = sj[g];
      if (m == a.sentinel) break;  // a step's real minors come first
      for (int r0 = 0; r0 < TM; r0 += kTJ) {
        const size_t qrow0 = (size_t)b * a.NS + (size_t)m * TM + r0;
        // this chunk's positions (stride 4 packed, 3 not) and t rows (stride KU)
        const float* pos;
        const float* urow;
        if constexpr (kPacked) {
          const float* R = a.rec + ((size_t)b * a.sentinel + m) * ((size_t)TM * (4 + KU));
          pos = R + 4 * r0;
          urow = R + 4 * TM + (size_t)r0 * KU;
        } else {
          pos = a.smp + 3 * qrow0;
          urow = a.u + qrow0 * KU;
        }
        constexpr int ps = kPacked ? 4 : 3;
        __syncthreads();  // the previous chunk's plane and slices are consumed
        for (int i = threadIdx.x; i < kTJ; i += blockDim.x) {
          const float* q = pos + ps * i;
          qpos[4 * i] = q[0];
          qpos[4 * i + 1] = q[1];
          qpos[4 * i + 2] = q[2];
          qpos[4 * i + 3] = sq_norm_rn(q[0], q[1], q[2]);
          if constexpr (kPacked)
            qvld[i] = q[3] != 0.f;
          else
            qvld[i] = a.svalid[qrow0 + i];
        }
        for (int i = threadIdx.x; i < kTJ * kMaxCB; i += blockDim.x) {
          const int j = i / kMaxCB, cl = i % kMaxCB;
          su[i] = cl < nx ? urow[(size_t)j * KU + c0 + cl] : 0.f;
        }
        for (int i = threadIdx.x; i < kTJ * H * kMaxCB; i += blockDim.x) {
          const int j = i / (H * kMaxCB), h = (i / kMaxCB) % H, cl = i % kMaxCB;
          float v = 0.f;
          if (cl < nd) {
            const int c = c0 + cl;
            v = a.depthwise ? urow[(size_t)j * KU + c] * a.w2[h * C + c]
                            : a.dg[((qrow0 + j) * H1 + h) * C + c];
          }
          sdg[i] = v;
        }
        __syncthreads();
        if constexpr (kNoop) {
          for (int i = threadIdx.x; i < kTJ * kT; i += blockDim.x) {
            const int j = i / kT, s = i % kT;
            const float d2 = pair_d2_rn(qpos[4 * j], qpos[4 * j + 1], qpos[4 * j + 2],
                                        qpos[4 * j + 3], ppos[4 * s], ppos[4 * s + 1],
                                        ppos[4 * s + 2], ppos[4 * s + 3]);
            met += qvld[j] && pvld[s] && d2 <= a.r2 ? 1.f : 0.f;
          }
        } else {
          for (int i = threadIdx.x; i < kTJ * kT; i += blockDim.x) {
            const int j = i / kT, s = i % kT;
            const float px = ppos[4 * s], py = ppos[4 * s + 1], pz = ppos[4 * s + 2];
            const float qx = qpos[4 * j], qy = qpos[4 * j + 1], qz = qpos[4 * j + 2];
            const float d2 = pair_d2_rn(qx, qy, qz, qpos[4 * j + 3], px, py, pz, ppos[4 * s + 3]);
            const bool in = qvld[j] && pvld[s] && d2 <= a.r2;
            const float ox = mc_offset(px, qx, radius), oy = mc_offset(py, qy, radius),
                        oz = mc_offset(pz, qz, radius);
            float* pl = plane + (size_t)j * H1 * kT + s;
#pragma unroll
            for (int h = 0; h < H; ++h) {
              const float pre = mc_preact(ox, oy, oz, sw1, sb1, H, h);
              pl[h * kT] = in ? fmaxf(pre, 0.f) : 0.f;
            }
            pl[H * kT] = in ? 1.f : 0.f;
          }
          __syncthreads();
#pragma unroll
          for (int k = 0; k < kOut; ++k) {
            const int q = threadIdx.x + k * kThreads;
            if (q < nout) {
              const int s = q / CB, cl = q % CB;
              for (int j = 0; j < kTJ; ++j) {
                const float tv = su[j * kMaxCB + cl];
                const float* pl = plane + (size_t)j * H1 * kT + s;
#pragma unroll
                for (int h = 0; h < H1; ++h) acc[k][h] += pl[h * kT] * tv;
              }
            }
          }
          if (nd > 0) {
            for (int q = threadIdx.x; q < kTJ * kT * H; q += blockDim.x) {
              const int h = q % H, pr = q / H;
              const int j = pr / kT, s = pr % kT;
              if (plane[((size_t)j * H1 + h) * kT + s] > 0.f) {
                const float* gq = sdg + ((size_t)j * H + h) * kMaxCB;
                const float* fp = sfeat + (size_t)s * kMaxCB;
                float d = 0.f;
                for (int cl = 0; cl < nd; ++cl) d += gq[cl] * fp[cl];
                gx += d * mc_offset(ppos[4 * s], qpos[4 * j], radius);
                gy += d * mc_offset(ppos[4 * s + 1], qpos[4 * j + 1], radius);
                gz += d * mc_offset(ppos[4 * s + 2], qpos[4 * j + 2], radius);
                gb += d;
              }
            }
          }
        }  // the noop probe stops after the radius test
      }
    }
  }

  if constexpr (kNoop) {
    const float zero = 0.f * met;  // 0, and it depends on every d2 this thread formed
    const size_t tile_id = (size_t)b * a.n_tiles + t;
#pragma unroll
    for (int k = 0; k < kOut; ++k) {
      const int q = threadIdx.x + k * kThreads;
      const int s = q / CB, cl = q % CB;
      if (q >= nout || cl >= nx) continue;
      const size_t r = prow0 + s;
      if (a.depthwise)
        a.out[r * C + c0 + cl] = zero;
      else
        for (int h = 0; h < H1; ++h) a.out[(r * H1 + h) * KU + c0 + cl] = zero;
    }
    if (threadIdx.x < 4 * H) a.w1part[(tile_id * gridDim.x + cb) * 4 * H + threadIdx.x] = zero;
    if (a.depthwise)
      for (int i = threadIdx.x; i < H1 * nx; i += blockDim.x)
        a.w2part[(tile_id * H1 + i / nx) * C + c0 + i % nx] = zero;
    return;
  }
  __syncthreads();  // the plane becomes the epilogue's reduction buffer
  float* red = plane;  // [kT][H1][kMaxCB]: kPlaneRows rows of the plane
#pragma unroll
  for (int k = 0; k < kOut; ++k) {
    const int q = threadIdx.x + k * kThreads;
    if (q >= nout) continue;
    const int s = q / CB, cl = q % CB;
    if (cl >= nx) continue;
    const int c = c0 + cl;
    const size_t r = prow0 + s;
    if (a.depthwise) {
      float o = 0.f;
#pragma unroll
      for (int h = 0; h < H; ++h) o += acc[k][h] * a.w2[h * C + c];
      o += acc[k][H] * a.b2[c];
      a.out[r * C + c] = o;
      const float f = sfeat[s * kMaxCB + cl];
#pragma unroll
      for (int h = 0; h < H1; ++h) red[((size_t)s * H1 + h) * kMaxCB + cl] = f * acc[k][h];
    } else {
#pragma unroll
      for (int h = 0; h < H1; ++h) a.out[(r * H1 + h) * KU + c] = acc[k][h];
    }
  }
  float* rw = sred + 4 * threadIdx.x;
  rw[0] = gx;
  rw[1] = gy;
  rw[2] = gz;
  rw[3] = gb;
  __syncthreads();
  const size_t tile_id = (size_t)b * a.n_tiles + t;
  if (threadIdx.x < 4 * H) {
    const int kk = threadIdx.x / H, h = threadIdx.x % H;
    float s = 0.f;
    for (int i = h; i < (int)blockDim.x; i += H) s += sred[4 * i + kk];
    a.w1part[((tile_id * gridDim.x + cb) * 4 + kk) * H + h] = s;
  }
  if (a.depthwise) {
    for (int i = threadIdx.x; i < H1 * nx; i += blockDim.x) {
      const int h = i / nx, cl = i % nx;
      float s = 0.f;
      for (int p = 0; p < kT; ++p) s += red[((size_t)p * H1 + h) * kMaxCB + cl];
      a.w2part[(tile_id * H1 + h) * C + c0 + cl] = s;
    }
  }
}

template <int TM, bool kPacked, bool kNoop>
int tile_bwd_launch_tm(const TileBwdArgs& a, int B, cudaStream_t stream) {
  const size_t smem = tile_bwd_smem<TM>(8);
  cudaError_t err = cudaFuncSetAttribute(tile_conv_bwd_kernel<8, TM, kPacked, kNoop>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int wide = a.C > a.KU ? a.C : a.KU;
  dim3 grid((wide + a.CB - 1) / a.CB, a.n_tiles, B);
  tile_conv_bwd_kernel<8, TM, kPacked, kNoop><<<grid, kThreads, smem, stream>>>(a);
  MCCNN_LAUNCH_RETURN();
}

// Checks the shapes and launches the instance built for Tm (8, 16, 32, 64 or
// 128); any other Tm, or a shape the kernel does not take, is refused.
template <bool kPacked, bool kNoop = false>
int tile_bwd_dispatch(const TileBwdArgs& a, int B, int H, int Tm, cudaStream_t stream) {
  if (H != 8 || a.C < 1 || a.KU < 1 || a.CB < 1 || a.CB > kMaxCB || a.G < 1 || Tm < 8 ||
      (size_t)a.G * Tm > kMaxRows || B < 1 || a.n_tiles < 1 || a.NP != a.n_tiles * kT ||
      a.NS < a.sentinel * Tm || (a.depthwise && a.KU != a.C))
    return static_cast<int>(cudaErrorInvalidValue);
  switch (Tm) {
    case 8: return tile_bwd_launch_tm<8, kPacked, kNoop>(a, B, stream);
    case 16: return tile_bwd_launch_tm<16, kPacked, kNoop>(a, B, stream);
    case 32: return tile_bwd_launch_tm<32, kPacked, kNoop>(a, B, stream);
    case 64: return tile_bwd_launch_tm<64, kPacked, kNoop>(a, B, stream);
    case 128: return tile_bwd_launch_tm<128, kPacked, kNoop>(a, B, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace k6
}  // namespace
