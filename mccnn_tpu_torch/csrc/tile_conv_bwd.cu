// K6: the Monte-Carlo convolution over Hilbert tile pairs, backward.
//
// Replaces mccnn_tpu/ops/pallas/tile_conv.py::_bwd_kernel (:658, called at
// :1057 through _bwd_call from the custom_vjp of tile_mc_conv). K5
// (tile_conv.cu) forms G[b,i,h,c] = sum_j a_h(i,j) f~[b,j,c] over the forward
// step list (sample majors x source minors) and out = s_i * (G . [W2; b2]).
// The backward walks its own list, as the reference's does: step k of cloud b
// pairs the source tile jb[b, k] (T = 128 sorted sources; the list is
// non-decreasing in it) with up to G sample minors ib[b, :, k] (Tm = 32
// sorted samples each; the id n_minor marks none). With t = s * dout (the
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
// order. Per half-minor of 16 samples the block stages their positions, flags
// and the CB-channel slices of t and dG, fills the (16, H+1, 128) a_h plane
// with the expressions of K1, K2 and K5 (pair_d2_rn, mc_offset, mc_preact in
// common.cuh, so all four agree bit for bit on a_h), and then
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
// What bounds it on the H100: the pair arithmetic, as K5. Each candidate pair
// costs a d2 and H pre-activations, then (H+1) FMAs per channel for X and,
// within the radius, H dot products over the channel slice. The step list
// hands it about 10x more candidate than in-radius pairs. Everything is fp32
// (the TPU kernel holds planes, features and the cotangent in bf16). Invalid
// rows are masked by their flags. Limits: H == 8, T == 128, Tm == 32,
// G <= 64, channel blocks of at most 16.

#include "common.cuh"

namespace {

constexpr int kT = 128;       // sources per major tile
constexpr int kTm = 32;       // samples per candidate minor
constexpr int kTJ = 16;       // samples per shared-memory chunk
constexpr int kThreads = 256; // a multiple of H (see the dpre loop)
constexpr int kOut = 8;       // (source, channel) outputs per thread
constexpr int kMaxCB = kThreads * kOut / kT;  // 16 channels per block
constexpr int kMaxG = 64;

template <int H>
__global__ void __launch_bounds__(kThreads)
tile_conv_bwd_kernel(const float* __restrict__ smp, const uint8_t* __restrict__ svalid,
                     const float* __restrict__ src, const uint8_t* __restrict__ pvalid,
                     const float* __restrict__ wf, const float* __restrict__ u,
                     const float* __restrict__ dg, const int* __restrict__ j_ids,
                     const int* __restrict__ run, const float* __restrict__ w1,
                     const float* __restrict__ b1, const float* __restrict__ w2,
                     const float* __restrict__ b2, int NS, int NP, int C, int KU, int CB,
                     int S, int G, int n_tiles, int sentinel, float r2, float radius,
                     int depthwise, float* __restrict__ out, float* __restrict__ w1part,
                     float* __restrict__ w2part) {
  constexpr int H1 = H + 1;
  extern __shared__ float sm[];
  float* plane = sm;                         // [kTJ][H1][kT]; the epilogue's [kT][H1][kMaxCB]
  float* su = plane + kTJ * H1 * kT;         // [kTJ][kMaxCB]: t of the chunk's samples
  float* sdg = su + kTJ * kMaxCB;            // [kTJ][H][kMaxCB]: their dG
  float* sfeat = sdg + kTJ * H * kMaxCB;     // [kT][kMaxCB]: f~ of the tile's sources
  float* ppos = sfeat + kT * kMaxCB;         // [kT][4]: x, y, z, |p|^2
  float* qpos = ppos + kT * 4;               // [kTJ][4]
  float* sw1 = qpos + kTJ * 4;               // [3][H]
  float* sb1 = sw1 + 3 * H;                  // [H]
  float* sred = sb1 + H;                     // [kThreads][4]
  int* sj = reinterpret_cast<int*>(sred + 4 * kThreads);        // [kMaxG]
  uint8_t* pvld = reinterpret_cast<uint8_t*>(sj + kMaxG);       // [kT]
  uint8_t* qvld = pvld + kT;                                     // [kTJ]

  const int cb = blockIdx.x, t = blockIdx.y, b = blockIdx.z;
  const int c0 = cb * CB;
  const int nx = min(CB, KU - c0);  // X channels of this block (may be <= 0)
  const int nd = min(CB, C - c0);   // dpre channels of this block (may be <= 0)
  const size_t prow0 = (size_t)b * NP + (size_t)t * kT;

  for (int s = threadIdx.x; s < kT; s += blockDim.x) {
    const float* p = src + 3 * (prow0 + s);
    ppos[4 * s] = p[0];
    ppos[4 * s + 1] = p[1];
    ppos[4 * s + 2] = p[2];
    ppos[4 * s + 3] = sq_norm_rn(p[0], p[1], p[2]);
    pvld[s] = pvalid[prow0 + s];
  }
  for (int i = threadIdx.x; i < kT * kMaxCB; i += blockDim.x) {
    const int s = i / kMaxCB, cl = i % kMaxCB;
    sfeat[i] = cl < nd ? wf[(prow0 + s) * C + c0 + cl] : 0.f;
  }
  for (int i = threadIdx.x; i < 3 * H; i += blockDim.x) sw1[i] = w1[i];
  for (int i = threadIdx.x; i < H; i += blockDim.x) sb1[i] = b1[i];

  float acc[kOut][H1];
#pragma unroll
  for (int k = 0; k < kOut; ++k)
#pragma unroll
    for (int h = 0; h < H1; ++h) acc[k][h] = 0.f;
  // blockDim is a multiple of H, so this thread's dpre items all share h.
  float gx = 0.f, gy = 0.f, gz = 0.f, gb = 0.f;
  const int nout = kT * CB;
  const int k0 = run[(size_t)b * (n_tiles + 1) + t];
  const int k1 = run[(size_t)b * (n_tiles + 1) + t + 1];

  for (int step = k0; step < k1; ++step) {
    __syncthreads();  // the previous step's minor ids and chunks are consumed
    for (int g = threadIdx.x; g < G; g += blockDim.x)
      sj[g] = j_ids[((size_t)b * G + g) * S + step];
    __syncthreads();
    for (int g = 0; g < G; ++g) {
      const int m = sj[g];
      if (m == sentinel) break;  // a step's real minors come first
      for (int half = 0; half < kTm / kTJ; ++half) {
        const size_t qrow0 = (size_t)b * NS + (size_t)m * kTm + half * kTJ;
        __syncthreads();  // the previous chunk's plane and slices are consumed
        for (int i = threadIdx.x; i < kTJ; i += blockDim.x) {
          const float* q = smp + 3 * (qrow0 + i);
          qpos[4 * i] = q[0];
          qpos[4 * i + 1] = q[1];
          qpos[4 * i + 2] = q[2];
          qpos[4 * i + 3] = sq_norm_rn(q[0], q[1], q[2]);
          qvld[i] = svalid[qrow0 + i];
        }
        for (int i = threadIdx.x; i < kTJ * kMaxCB; i += blockDim.x) {
          const int j = i / kMaxCB, cl = i % kMaxCB;
          su[i] = cl < nx ? u[(qrow0 + j) * KU + c0 + cl] : 0.f;
        }
        for (int i = threadIdx.x; i < kTJ * H * kMaxCB; i += blockDim.x) {
          const int j = i / (H * kMaxCB), h = (i / kMaxCB) % H, cl = i % kMaxCB;
          float v = 0.f;
          if (cl < nd) {
            const int c = c0 + cl;
            v = depthwise ? u[(qrow0 + j) * KU + c] * w2[h * C + c]
                          : dg[((qrow0 + j) * H1 + h) * C + c];
          }
          sdg[i] = v;
        }
        __syncthreads();
        for (int i = threadIdx.x; i < kTJ * kT; i += blockDim.x) {
          const int j = i / kT, s = i % kT;
          const float px = ppos[4 * s], py = ppos[4 * s + 1], pz = ppos[4 * s + 2];
          const float qx = qpos[4 * j], qy = qpos[4 * j + 1], qz = qpos[4 * j + 2];
          const float d2 = pair_d2_rn(qx, qy, qz, qpos[4 * j + 3], px, py, pz, ppos[4 * s + 3]);
          const bool in = qvld[j] && pvld[s] && d2 <= r2;
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
      }
    }
  }

  __syncthreads();  // the plane becomes the epilogue's reduction buffer
  float* red = plane;  // [kT][H1][kMaxCB]
#pragma unroll
  for (int k = 0; k < kOut; ++k) {
    const int q = threadIdx.x + k * kThreads;
    if (q >= nout) continue;
    const int s = q / CB, cl = q % CB;
    if (cl >= nx) continue;
    const int c = c0 + cl;
    const size_t r = prow0 + s;
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
  const size_t tile_id = (size_t)b * n_tiles + t;
  if (threadIdx.x < 4 * H) {
    const int kk = threadIdx.x / H, h = threadIdx.x % H;
    float s = 0.f;
    for (int i = h; i < (int)blockDim.x; i += H) s += sred[4 * i + kk];
    w1part[((tile_id * gridDim.x + cb) * 4 + kk) * H + h] = s;
  }
  if (depthwise) {
    for (int i = threadIdx.x; i < H1 * nx; i += blockDim.x) {
      const int h = i / nx, cl = i % nx;
      float s = 0.f;
      for (int p = 0; p < kT; ++p) s += red[((size_t)p * H1 + h) * kMaxCB + cl];
      w2part[(tile_id * H1 + h) * C + c0 + cl] = s;
    }
  }
}

size_t bwd_smem(int H) {
  return sizeof(float) * ((size_t)kTJ * (H + 1) * kT + kTJ * kMaxCB + (size_t)kTJ * H * kMaxCB +
                          kT * kMaxCB + kT * 4 + kTJ * 4 + 3 * H + H + 4 * kThreads) +
         sizeof(int) * kMaxG + kT + kTJ;
}

}  // namespace

// out: d_f~ (B, NP, C) when depthwise, else X (B, NP, H+1, KU). u: t (B, NS,
// KU). dg: dG (B, NS, H+1, C) for the full conv (unread when depthwise).
// w1part: (B * n_tiles * ceil(max(C, KU) / CB), 4, H) partials of [dW1; db1];
// w2part: (B * n_tiles, H+1, C) partials of [dW2; db2] (depthwise only).
extern "C" int tile_conv_bwd_launch(const void* smp, const void* svalid, const void* src,
                                    const void* pvalid, const void* wf, const void* u,
                                    const void* dg, const void* j_ids, const void* run,
                                    const void* w1, const void* b1, const void* w2,
                                    const void* b2, int B, int NS, int NP, int C, int KU,
                                    int CB, int H, int S, int G, int n_tiles, int sentinel,
                                    float r2, float radius, int depthwise, void* out,
                                    void* w1part, void* w2part, void* stream) {
  if (H != 8 || C < 1 || KU < 1 || CB < 1 || CB > kMaxCB || G < 1 || G > kMaxG || B < 1 ||
      n_tiles < 1 || NP != n_tiles * kT || NS < sentinel * kTm || (depthwise && KU != C))
    return static_cast<int>(cudaErrorInvalidValue);
  const int wide = C > KU ? C : KU;
  const size_t smem = bwd_smem(H);
  cudaError_t err = cudaFuncSetAttribute(
      tile_conv_bwd_kernel<8>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid((wide + CB - 1) / CB, n_tiles, B);
  tile_conv_bwd_kernel<8><<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(smp), static_cast<const uint8_t*>(svalid),
      static_cast<const float*>(src), static_cast<const uint8_t*>(pvalid),
      static_cast<const float*>(wf), static_cast<const float*>(u),
      static_cast<const float*>(dg), static_cast<const int*>(j_ids),
      static_cast<const int*>(run), static_cast<const float*>(w1),
      static_cast<const float*>(b1), static_cast<const float*>(w2),
      static_cast<const float*>(b2), NS, NP, C, KU, CB, S, G, n_tiles, sentinel, r2, radius,
      depthwise, static_cast<float*>(out), static_cast<float*>(w1part),
      static_cast<float*>(w2part));
  MCCNN_LAUNCH_RETURN();
}
