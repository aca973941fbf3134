// K6v1: the Monte-Carlo convolution over Hilbert tile pairs, backward, in the
// per-h form.
//
// Replaces mccnn_tpu/ops/pallas/tile_conv.py::_bwd_kernel_v1 (:825), which
// MCCNN_TILE_BWD_V1=1 selects (:1036) and _bwd_call runs (:1057) over the same
// source-major backward list as K6 (jb_ids / ib_ids, :1089): step k of cloud b
// pairs the source tile jb[b, k] (T = 128 sorted sources; the list is
// non-decreasing in it) with up to G sample minors ib[b, :, k] (Tm sorted
// samples each, Tm in {8, 16, 32, 64, 128}, a template parameter; the id
// n_minor marks none). It computes K6's gradients (tile_conv_bwd.cuh) in the
// reference's v1 form. With t = s * dout (the cotangent of the projection),
// t_h = t * W2_h (depthwise) or t . W2_h^T (full; h = H takes b2), and for
// every valid pair (sample i, source j) with d2(i, j) <= r2 the plane a_h(i,
// j) (relu(pre_h) for h < H, 1 at h = H), per h:
//
//   d_f~[j,c]  += sum_i a_h(i,j) t_h[i,c]
//   g_h[i,c]    = sum_j a_h(i,j) f~[j,c]      (over the block's sources)
//   dW2_h      += sum_i t[i,.] g_h[i,c]       (over the sample rows)
//   dpre_h(i,j) = [pre_h > 0] sum_c t_h[i,c] f~[j,c]   -> dW1, db1
//
// The TPU kernel forms 3H+2 matrix products a step and keeps no plane
// scratch; K6 (v2) forms X = a^T t once and projects it. On the H100 a block
// takes one (cloud, source tile, block of CB <= 16 input channels) and walks
// the tile's run of steps, run[b, t] to run[b, t+1], so every d_f~ row has one
// writer and its sums run in step order. Per chunk of min(Tm, 16) samples the
// block stages their positions, flags and t_h slices (the full conv's t_h is
// dG, from K2's GEMM as in K6), fills the (chunk, H+1, 128) a_h plane with
// K1's, K5's and K6's expressions (pair_d2_rn, mc_offset, mc_preact in
// common.cuh: a_h is theirs bit for bit), then
//   - each thread accumulates up to 8 (source, channel) outputs of d_f~;
//   - dpre as K6, into four registers of a fixed h = thread % H;
//   - g_h of the chunk's samples over the tile's 128 sources into shared
//     memory, and the tile's [dW2; db2] partial from it: each element has one
//     owner thread, which adds the chunk's sum over its samples in order.
// Per-tile partials of [dW2; db2] and per-block partials of [dW1; db1] are
// summed in block order by K2's reduction kernel: no float atomics, two calls
// are bit-identical.
//
// What bounds it on the H100: the pair arithmetic, as K6, with H+1 more FMAs
// per pair and channel for g_h. Everything is fp32 (the TPU kernel holds the
// features in bf16). Invalid rows are masked by their flags. Limits: H == 8,
// T == 128, G * Tm <= 2048.

#include "common.cuh"

namespace {

constexpr int kT = 128;        // sources per major tile
constexpr int kThreads = 256;  // a multiple of H (see the dpre loop)
constexpr int kOut = 8;        // (source, channel) outputs per thread
constexpr int kMaxCB = kThreads * kOut / kT;  // 16 channels per block
constexpr int kMaxRows = 2048;  // candidate rows a step: G * Tm

template <int TM>
size_t bwd_v1_smem(int H) {
  constexpr int kTJ = TM < 16 ? TM : 16;
  return sizeof(float) * ((size_t)kTJ * (H + 1) * kT + 2 * (size_t)kTJ * (H + 1) * kMaxCB +
                          kTJ * kMaxCB + kT * kMaxCB + kT * 4 + kTJ * 4 + 3 * H + H +
                          4 * kThreads) +
         sizeof(int) * (kMaxRows / TM) + kT + kTJ;
}

template <int H, int TM>
__global__ void __launch_bounds__(kThreads)
tile_conv_bwd_v1_kernel(const float* __restrict__ smp, const uint8_t* __restrict__ svalid,
                        const float* __restrict__ src, const uint8_t* __restrict__ pvalid,
                        const float* __restrict__ wf, const float* __restrict__ u,
                        const float* __restrict__ dg, const int* __restrict__ j_ids,
                        const int* __restrict__ run, const float* __restrict__ w1,
                        const float* __restrict__ b1, const float* __restrict__ w2,
                        const float* __restrict__ b2, int NS, int NP, int C, int CO, int CB,
                        int S, int G, int n_tiles, int sentinel, float r2, float radius,
                        int depthwise, float* __restrict__ dwf, float* __restrict__ w1part,
                        float* __restrict__ w2part) {
  constexpr int H1 = H + 1;
  constexpr int kTJ = TM < 16 ? TM : 16;  // samples per shared-memory chunk
  extern __shared__ float sm[];
  float* plane = sm;                        // [kTJ][H1][kT]: a_h, the radius mask at h = H
  float* sth = plane + kTJ * H1 * kT;       // [kTJ][H1][kMaxCB]: t_h of the chunk's samples
  float* sg = sth + kTJ * H1 * kMaxCB;      // [kTJ][H1][kMaxCB]: g_h = a_h f~
  float* sdo = sg + kTJ * H1 * kMaxCB;      // [kTJ][kMaxCB]: t (depthwise dW2)
  float* sfeat = sdo + kTJ * kMaxCB;        // [kT][kMaxCB]: f~ of the tile's sources
  float* ppos = sfeat + kT * kMaxCB;        // [kT][4]: x, y, z, |p|^2
  float* qpos = ppos + kT * 4;              // [kTJ][4]
  float* sw1 = qpos + kTJ * 4;              // [3][H]
  float* sb1 = sw1 + 3 * H;                 // [H]
  float* sred = sb1 + H;                    // [kThreads][4]
  int* sj = reinterpret_cast<int*>(sred + 4 * kThreads);           // [kMaxRows / TM]
  uint8_t* pvld = reinterpret_cast<uint8_t*>(sj + kMaxRows / TM);  // [kT]
  uint8_t* qvld = pvld + kT;                                       // [kTJ]

  const int cb = blockIdx.x, t = blockIdx.y, b = blockIdx.z;
  const int c0 = cb * CB;
  const int nd = min(CB, C - c0);  // channels of this block (>= 1)
  const size_t prow0 = (size_t)b * NP + (size_t)t * kT;
  const size_t tile_id = (size_t)b * n_tiles + t;
  // This source tile's [dW2; db2] partial, (H1, C) depthwise or (H1, C, CO)
  // full; the block owns the slice of its channels, element e = (h, cl, o).
  const int KO = depthwise ? 1 : CO;
  float* part = w2part + tile_id * (size_t)H1 * C * KO;
  const int nw = H1 * nd * KO;
  for (int e = threadIdx.x; e < nw; e += blockDim.x) {
    const int h = e / (nd * KO), cl = (e / KO) % nd, o = e % KO;
    part[((size_t)h * C + c0 + cl) * KO + o] = 0.f;
  }
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

  float acc[kOut];  // d_f~ of this thread's (source, channel) outputs
#pragma unroll
  for (int k = 0; k < kOut; ++k) acc[k] = 0.f;
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
      for (int r0 = 0; r0 < TM; r0 += kTJ) {
        const size_t qrow0 = (size_t)b * NS + (size_t)m * TM + r0;
        __syncthreads();  // the previous chunk's planes and slices are consumed
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
          sdo[i] = depthwise && cl < nd ? u[(qrow0 + j) * C + c0 + cl] : 0.f;
        }
        for (int i = threadIdx.x; i < kTJ * H1 * kMaxCB; i += blockDim.x) {
          const int j = i / (H1 * kMaxCB), h = (i / kMaxCB) % H1, cl = i % kMaxCB;
          float v = 0.f;
          if (cl < nd) {
            const int c = c0 + cl;
            v = depthwise ? u[(qrow0 + j) * C + c] * (h < H ? w2[h * C + c] : b2[c])
                          : dg[((qrow0 + j) * H1 + h) * C + c];
          }
          sth[i] = v;
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
        // d_f~[s, c] += sum_h a_h(j, s) t_h[j, c]
#pragma unroll
        for (int k = 0; k < kOut; ++k) {
          const int q = threadIdx.x + k * kThreads;
          if (q < nout) {
            const int s = q / CB, cl = q % CB;
            for (int j = 0; j < kTJ; ++j) {
              const float* pl = plane + (size_t)j * H1 * kT + s;
              const float* th = sth + (size_t)j * H1 * kMaxCB + cl;
#pragma unroll
              for (int h = 0; h < H1; ++h) acc[k] += pl[h * kT] * th[h * kMaxCB];
            }
          }
        }
        // dpre_h = [a_h > 0] t_h . f~ over the block's channels
        for (int q = threadIdx.x; q < kTJ * kT * H; q += blockDim.x) {
          const int h = q % H, pr = q / H;
          const int j = pr / kT, s = pr % kT;
          if (plane[((size_t)j * H1 + h) * kT + s] > 0.f) {
            const float* th = sth + ((size_t)j * H1 + h) * kMaxCB;
            const float* fp = sfeat + (size_t)s * kMaxCB;
            float d = 0.f;
            for (int cl = 0; cl < nd; ++cl) d += th[cl] * fp[cl];
            gx += d * mc_offset(ppos[4 * s], qpos[4 * j], radius);
            gy += d * mc_offset(ppos[4 * s + 1], qpos[4 * j + 1], radius);
            gz += d * mc_offset(ppos[4 * s + 2], qpos[4 * j + 2], radius);
            gb += d;
          }
        }
        // g_h[j, c] = sum_s a_h(j, s) f~[s, c] over the tile's sources
        for (int i = threadIdx.x; i < kTJ * H1 * nd; i += blockDim.x) {
          const int j = i / (H1 * nd), h = (i / nd) % H1, cl = i % nd;
          const float* pl = plane + ((size_t)j * H1 + h) * kT;
          float s = 0.f;
          for (int p = 0; p < kT; ++p) s += pl[p] * sfeat[p * kMaxCB + cl];
          sg[((size_t)j * H1 + h) * kMaxCB + cl] = s;
        }
        __syncthreads();
        // [dW2; db2] += sum_j g_h[j, c] t[j, c | o], one owner per element
        for (int e = threadIdx.x; e < nw; e += blockDim.x) {
          const int h = e / (nd * KO), cl = (e / KO) % nd, o = e % KO;
          float* dst = part + ((size_t)h * C + c0 + cl) * KO + o;
          float v = *dst;
          for (int j = 0; j < kTJ; ++j) {
            const float tv = depthwise ? sdo[j * kMaxCB + cl] : u[(qrow0 + j) * CO + o];
            v += sg[((size_t)j * H1 + h) * kMaxCB + cl] * tv;
          }
          *dst = v;
        }
      }
    }
  }

#pragma unroll
  for (int k = 0; k < kOut; ++k) {
    const int q = threadIdx.x + k * kThreads;
    if (q >= nout) continue;
    const int s = q / CB, cl = q % CB;
    if (cl < nd) dwf[(prow0 + s) * C + c0 + cl] = acc[k];
  }
  float* rw = sred + 4 * threadIdx.x;
  rw[0] = gx;
  rw[1] = gy;
  rw[2] = gz;
  rw[3] = gb;
  __syncthreads();
  if (threadIdx.x < 4 * H) {
    const int kk = threadIdx.x / H, h = threadIdx.x % H;
    float s = 0.f;
    for (int i = h; i < (int)blockDim.x; i += H) s += sred[4 * i + kk];
    w1part[((tile_id * gridDim.x + cb) * 4 + kk) * H + h] = s;
  }
}

template <int TM>
int bwd_v1_launch_tm(dim3 grid, cudaStream_t stream, const float* smp, const uint8_t* svalid,
                     const float* src, const uint8_t* pvalid, const float* wf, const float* u,
                     const float* dg, const int* j_ids, const int* run, const float* w1,
                     const float* b1, const float* w2, const float* b2, int NS, int NP, int C,
                     int CO, int CB, int S, int G, int n_tiles, int sentinel, float r2,
                     float radius, int depthwise, float* dwf, float* w1part, float* w2part) {
  const size_t smem = bwd_v1_smem<TM>(8);
  cudaError_t err = cudaFuncSetAttribute(tile_conv_bwd_v1_kernel<8, TM>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  tile_conv_bwd_v1_kernel<8, TM><<<grid, kThreads, smem, stream>>>(
      smp, svalid, src, pvalid, wf, u, dg, j_ids, run, w1, b1, w2, b2, NS, NP, C, CO, CB, S, G,
      n_tiles, sentinel, r2, radius, depthwise, dwf, w1part, w2part);
  MCCNN_LAUNCH_RETURN();
}

}  // namespace

// u: t (B, NS, CO). dg: t_h = dG (B, NS, H+1, C) for the full conv (unread when
// depthwise). dwf: d_f~ (B, NP, C). w1part: (B * n_tiles * ceil(C / CB), 4, H)
// partials of [dW1; db1]; w2part: (B * n_tiles, H+1, C) depthwise or (B *
// n_tiles, H+1, C, CO) full, partials of [dW2; db2].
extern "C" int tile_conv_bwd_v1_launch(const void* smp, const void* svalid, const void* src,
                                       const void* pvalid, const void* wf, const void* u,
                                       const void* dg, const void* j_ids, const void* run,
                                       const void* w1, const void* b1, const void* w2,
                                       const void* b2, int B, int NS, int NP, int C, int CO,
                                       int CB, int H, int S, int G, int n_tiles, int sentinel,
                                       int Tm, float r2, float radius, int depthwise, void* dwf,
                                       void* w1part, void* w2part, void* stream) {
  if (H != 8 || C < 1 || CO < 1 || CB < 1 || CB > kMaxCB || G < 1 || Tm < 8 ||
      (size_t)G * Tm > kMaxRows || B < 1 || n_tiles < 1 || NP != n_tiles * kT ||
      NS < sentinel * Tm || (depthwise && CO != C))
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((C + CB - 1) / CB, n_tiles, B);
  auto go = [&](auto launch) {
    return launch(grid, static_cast<cudaStream_t>(stream), static_cast<const float*>(smp),
                  static_cast<const uint8_t*>(svalid), static_cast<const float*>(src),
                  static_cast<const uint8_t*>(pvalid), static_cast<const float*>(wf),
                  static_cast<const float*>(u), static_cast<const float*>(dg),
                  static_cast<const int*>(j_ids), static_cast<const int*>(run),
                  static_cast<const float*>(w1), static_cast<const float*>(b1),
                  static_cast<const float*>(w2), static_cast<const float*>(b2), NS, NP, C, CO,
                  CB, S, G, n_tiles, sentinel, r2, radius, depthwise,
                  static_cast<float*>(dwf), static_cast<float*>(w1part),
                  static_cast<float*>(w2part));
  };
  switch (Tm) {
    case 8: return go(bwd_v1_launch_tm<8>);
    case 16: return go(bwd_v1_launch_tm<16>);
    case 32: return go(bwd_v1_launch_tm<32>);
    case 64: return go(bwd_v1_launch_tm<64>);
    case 128: return go(bwd_v1_launch_tm<128>);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
