// K2v1: the dense Monte-Carlo convolution, backward, in one launch.
//
// Replaces mccnn_tpu/ops/pallas/dense_conv.py::_bwd_kernel, the per-h variant
// of the fused backward that MCCNN_DENSE_V1=1 selects (reached through
// _bwd_call, dense_conv.py:607-647, from _core_bwd :758-769). It computes
// K2's function (dense_conv_bwd.cu) without the forward's G: from the
// forward's inputs, its count and dout it forms t = s * dout (s = 1/count in
// mean mode, 1 otherwise, 0 for a masked sample) and, per h,
//
//   t_h[i, c]  = t[i, c] W2[h, c]  (depthwise)  |  sum_o t[i, o] W2[h, c, o]  (full)
//   d_f~[j, c] = sum_i sum_{h<=H} a_h(i,j) t_h[i, c]          (t_H uses b2)
//   dpre_h(i,j) = [pre_h > 0] [in radius] sum_c t_h[i, c] f~[j, c]
//   dW1[k, h]  = sum dpre_h(i,j) (p_j - x_i)_k / r,   db1[h] = sum dpre_h
//   [dW2; db2][h, c, o] = sum_i g_h[i, c] t[i, o],   g_h = a_h f~  (G's row h).
//
// The TPU kernel walks source tiles on a sequential grid and adds its
// parameter gradients into outputs that stay in VMEM from step to step. On
// the H100 blocks run in no order, so a block walks a run of (cloud, source
// tile of TJ sources) units, u = blockIdx.x, + gridDim.x, ..., and keeps its
// own partials: dW1 / db1 in registers (a fixed h per thread, as K2's pair
// kernel), [dW2; db2] in a partial of (H+1) * C * (CO or 1) floats in device
// memory that only this block touches. K2's reduction kernel sums the
// partials in block order. For a unit the block walks all M samples in
// tiles of TI: it stages t, forms t_h for the tile (the full conv's by one
// warp per (h, c) row, lanes over o, a butterfly sum), builds the a_h plane
// with K1's expressions (pair_d2_rn, mc_offset, mc_preact: the same ReLU
// steps as K1 / K2 / K1v1), and then, as K2's pair kernel, accumulates the
// unit's d_f~ rows (one writer each) and the dpre dot products. The dW2
// term of a unit is sum_i (a_h^T f~)[i, c] t[i, o] = sum_j f~[j, c] X_h[j, o]
// with X_h = a_h^T t: the block keeps X (TJ, H+1, CO | C) in shared memory
// over the sample tiles and adds f~^T X into its partial once per unit.
//
// What bounds it on the H100: the pair arithmetic (per pair 8
// pre-activations, (H+1) C FMAs for d_f~, H C for dpre, (H+1) CW for X), and
// at a wide full conv the forming of t_h, which every unit repeats for all M
// samples (M (H+1) C CO FMAs a unit, Wcat read from L2), and the partial's
// read-modify-write once a unit. A simple first design: fp32 FMAs from
// shared memory, no tensor cores. No float atomics; fixed summation orders:
// two calls give bit-identical gradients.
//
// Limits: H == 8 and C <= 1024, as K2.

#include "common.cuh"

namespace {

constexpr int kHidden = 8;
constexpr int kThreads = 256;  // a multiple of kHidden and of the warp
constexpr int kOutPerThread = 4;
constexpr int kMaxOut = kThreads * kOutPerThread;  // TJ * C
constexpr int kTileFloats = 9600;  // the t_h tile, TI * (H+1) * (C|1) floats
constexpr int kMaxX = 18432;       // X, TJ * (H+1) * CW floats
constexpr int kMaxTI = 16;
constexpr int kMaxTJ = 64;
constexpr size_t kMaxSmem = 232448;

template <int H>
__global__ void mcconv_v1_bwd_kernel(const float* __restrict__ smp,
                                     const uint8_t* __restrict__ smask,
                                     const float* __restrict__ src,
                                     const uint8_t* __restrict__ srcmask,
                                     const float* __restrict__ wf,
                                     const float* __restrict__ w1,
                                     const float* __restrict__ b1,
                                     const float* __restrict__ w2,
                                     const float* __restrict__ b2,
                                     const float* __restrict__ cnt,
                                     const float* __restrict__ dout, int B, int M, int N,
                                     int C, int CO, int mean, int TJ, int TI, float r2,
                                     float radius, float* __restrict__ dwf,
                                     float* __restrict__ part_w, float* __restrict__ part_p) {
  constexpr int H1 = H + 1;
  const bool full = CO > 0;
  const int CW = full ? CO : C;  // the width of a t row and of X's last axis
  const int Cs = C | 1, CWs = CW | 1;  // odd row strides: rows read across threads
  extern __shared__ float sm[];
  float* sdg = sm;                          // [TI][H1][Cs]: t_h rows
  float* st = sdg + TI * H1 * Cs;           // [TI][CWs]: t rows
  float* sfeat = st + TI * CWs;             // [TJ][Cs]
  float* sx = sfeat + TJ * Cs;              // [TJ][H1][CW]: X
  float* plane = sx + TJ * H1 * CW;         // [TI][H1][TJ]
  float* spos = plane + TI * H1 * TJ;       // [TJ][4]: x, y, z, |p|^2
  float* qpos = spos + TJ * 4;              // [TI][4]
  float* sw1 = qpos + TI * 4;               // [3][H]
  float* sb1 = sw1 + 3 * H;                 // [H]
  float* sred = sb1 + H;                    // [blockDim][4]
  uint8_t* svalid = reinterpret_cast<uint8_t*>(sred + 4 * blockDim.x);  // [TJ]
  uint8_t* qvalid = svalid + TJ;                                        // [TI]

  const int tiles = (N + TJ - 1) / TJ;
  const int nout = TJ * C;
  const int nx = TJ * H1 * CW;
  float* pw = part_w + (size_t)blockIdx.x * H1 * C * (full ? CO : 1);
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32, nwarps = blockDim.x / 32;

  for (int t = threadIdx.x; t < 3 * H; t += blockDim.x) sw1[t] = w1[t];
  for (int t = threadIdx.x; t < H; t += blockDim.x) sb1[t] = b1[t];
  // blockDim is a multiple of H, so this thread's dpre items all share h = tid % H.
  float gx = 0.f, gy = 0.f, gz = 0.f, gb = 0.f;

  for (int u = blockIdx.x; u < B * tiles; u += gridDim.x) {
    const int b = u / tiles;
    const int j0 = (u % tiles) * TJ;
    const int nj = min(TJ, N - j0);
    __syncthreads();  // the previous unit is consumed (and the prologue stored)
    for (int t = threadIdx.x; t < TJ; t += blockDim.x) {
      float x = 0.f, y = 0.f, z = 0.f;
      uint8_t v = 0;
      if (t < nj) {
        const float* p = src + ((size_t)b * N + j0 + t) * 3;
        x = p[0];
        y = p[1];
        z = p[2];
        v = srcmask[(size_t)b * N + j0 + t];
      }
      spos[4 * t] = x;
      spos[4 * t + 1] = y;
      spos[4 * t + 2] = z;
      spos[4 * t + 3] = sq_norm_rn(x, y, z);
      svalid[t] = v;
    }
    for (int t = threadIdx.x; t < nout; t += blockDim.x) {
      const int j = t / C, c = t % C;
      sfeat[j * Cs + c] = j < nj ? wf[((size_t)b * N + j0 + j) * C + c] : 0.f;
    }
    for (int t = threadIdx.x; t < nx; t += blockDim.x) sx[t] = 0.f;
    float acc[kOutPerThread];
#pragma unroll
    for (int k = 0; k < kOutPerThread; ++k) acc[k] = 0.f;

    for (int i0 = 0; i0 < M; i0 += TI) {
      const int ni = min(TI, M - i0);
      __syncthreads();  // the previous sample tile is consumed
      for (int t = threadIdx.x; t < TI; t += blockDim.x) {
        float x = 0.f, y = 0.f, z = 0.f;
        uint8_t v = 0;
        if (t < ni) {
          const float* q = smp + ((size_t)b * M + i0 + t) * 3;
          x = q[0];
          y = q[1];
          z = q[2];
          v = smask[(size_t)b * M + i0 + t];
        }
        qpos[4 * t] = x;
        qpos[4 * t + 1] = y;
        qpos[4 * t + 2] = z;
        qpos[4 * t + 3] = sq_norm_rn(x, y, z);
        qvalid[t] = v;
      }
      for (int t = threadIdx.x; t < ni * CW; t += blockDim.x) {
        const int i = t / CW, w = t % CW;
        const size_t row = (size_t)b * M + i0 + i;
        float s = 0.f;
        if (smask[row]) s = mean ? __fdiv_rn(1.f, fmaxf(cnt[row], 1.f)) : 1.f;
        st[i * CWs + w] = __fmul_rn(dout[row * CW + w], s);
      }
      __syncthreads();
      // t_h for the tile's samples.
      if (full) {
        for (int r = warp; r < H1 * C; r += nwarps) {
          const float* wrow = r < H * C ? w2 + (size_t)r * CO : b2 + (size_t)(r - H * C) * CO;
          float a[kMaxTI];
#pragma unroll
          for (int i = 0; i < kMaxTI; ++i) a[i] = 0.f;
          for (int o = lane; o < CO; o += 32) {
            const float w = wrow[o];
#pragma unroll
            for (int i = 0; i < kMaxTI; ++i)
              if (i < ni) a[i] += st[i * CWs + o] * w;
          }
#pragma unroll
          for (int i = 0; i < kMaxTI; ++i) {
#pragma unroll
            for (int m = 16; m > 0; m >>= 1) a[i] += __shfl_xor_sync(0xffffffffu, a[i], m);
          }
          if (lane == 0) {
            const int h = r / C, c = r % C;
#pragma unroll
            for (int i = 0; i < kMaxTI; ++i)
              if (i < ni) sdg[((size_t)i * H1 + h) * Cs + c] = a[i];
          }
        }
      } else {
        for (int t = threadIdx.x; t < ni * H1 * C; t += blockDim.x) {
          const int c = t % C, h = (t / C) % H1, i = t / (H1 * C);
          const float w = h < H ? w2[h * C + c] : b2[c];
          sdg[((size_t)i * H1 + h) * Cs + c] = st[i * CWs + c] * w;
        }
      }
      for (int t = threadIdx.x; t < ni * TJ; t += blockDim.x) {
        const int i = t / TJ, j = t % TJ;
        const float px = spos[4 * j], py = spos[4 * j + 1], pz = spos[4 * j + 2];
        const float qx = qpos[4 * i], qy = qpos[4 * i + 1], qz = qpos[4 * i + 2];
        const float d2 = pair_d2_rn(qx, qy, qz, qpos[4 * i + 3], px, py, pz, spos[4 * j + 3]);
        const bool in = qvalid[i] && svalid[j] && d2 <= r2;
        const float ox = mc_offset(px, qx, radius), oy = mc_offset(py, qy, radius),
                    oz = mc_offset(pz, qz, radius);
        float* pl = plane + (size_t)i * H1 * TJ + j;
#pragma unroll
        for (int h = 0; h < H; ++h) {
          const float pre = mc_preact(ox, oy, oz, sw1, sb1, H, h);
          pl[h * TJ] = in ? fmaxf(pre, 0.f) : 0.f;
        }
        pl[H * TJ] = in ? 1.f : 0.f;
      }
      __syncthreads();
      // d_f~ rows of the unit.
#pragma unroll
      for (int k = 0; k < kOutPerThread; ++k) {
        const int q = threadIdx.x + k * blockDim.x;
        if (q < nout) {
          const int j = q / C, c = q % C;
          float s = acc[k];
          for (int i = 0; i < ni; ++i) {
            const float* pl = plane + (size_t)i * H1 * TJ + j;
            const float* g = sdg + (size_t)i * H1 * Cs + c;
#pragma unroll
            for (int h = 0; h < H1; ++h) s += pl[h * TJ] * g[h * Cs];
          }
          acc[k] = s;
        }
      }
      // X[j, h, w] += sum_i a_h(i, j) t[i, w].
      for (int e = threadIdx.x; e < nx; e += blockDim.x) {
        const int w = e % CW, h = (e / CW) % H1, j = e / (CW * H1);
        float s = sx[e];
        for (int i = 0; i < ni; ++i) s += plane[((size_t)i * H1 + h) * TJ + j] * st[i * CWs + w];
        sx[e] = s;
      }
      // dpre dot products, against the offsets: dW1[:, h] and db1[h].
      const int items = ni * TJ * H;
      for (int q = threadIdx.x; q < items; q += blockDim.x) {
        const int h = q % H, p = q / H;
        const int i = p / TJ, j = p % TJ;
        if (plane[((size_t)i * H1 + h) * TJ + j] > 0.f) {
          const float* g = sdg + ((size_t)i * H1 + h) * Cs;
          const float* f = sfeat + (size_t)j * Cs;
          float d = 0.f;
          for (int c = 0; c < C; ++c) d += g[c] * f[c];
          gx += d * mc_offset(spos[4 * j], qpos[4 * i], radius);
          gy += d * mc_offset(spos[4 * j + 1], qpos[4 * i + 1], radius);
          gz += d * mc_offset(spos[4 * j + 2], qpos[4 * i + 2], radius);
          gb += d;
        }
      }
    }
#pragma unroll
    for (int k = 0; k < kOutPerThread; ++k) {
      const int q = threadIdx.x + k * blockDim.x;
      if (q < nout) {
        const int j = q / C, c = q % C;
        if (j < nj) dwf[((size_t)b * N + j0 + j) * C + c] = acc[k];
      }
    }
    __syncthreads();  // X is complete
    // The unit's [dW2; db2]: partial[h, c, o] += sum_j f~[j, c] X[j, h, o] for
    // the full conv, partial[h, c] += sum_j f~[j, c] X[j, h, c] for the
    // depthwise one. Element r * W + o of row r = h * C + c (W = CO, or 1),
    // walked in steps of blockDim with the row and column carried along (no
    // division by W in the loop).
    const int W = full ? CO : 1;
    const int dr = blockDim.x / W, dw = blockDim.x % W;
    for (int r = threadIdx.x / W, o = threadIdx.x % W; r < H1 * C; r += dr, o += dw) {
      if (o >= W) {
        o -= W;
        if (++r >= H1 * C) break;
      }
      const int h = r / C, c = r - h * C;
      const float* xrow = sx + (size_t)h * CW + (full ? o : c);
      float v = 0.f;
      for (int j = 0; j < nj; ++j) v += sfeat[j * Cs + c] * xrow[(size_t)j * H1 * CW];
      pw[(size_t)r * W + o] += v;
    }
  }
  float* red = sred + 4 * threadIdx.x;
  red[0] = gx;
  red[1] = gy;
  red[2] = gz;
  red[3] = gb;
  __syncthreads();
  if (threadIdx.x < 4 * H) {
    const int k = threadIdx.x / H, h = threadIdx.x % H;
    float s = 0.f;
    for (int t = h; t < (int)blockDim.x; t += H) s += sred[4 * t + k];
    part_p[(size_t)blockIdx.x * 4 * H + k * H + h] = s;
  }
}

size_t v1_bwd_smem(int C, int CW, int TJ, int TI) {
  const int H1 = kHidden + 1;
  return sizeof(float) * ((size_t)TI * H1 * (C | 1) + (size_t)TI * (CW | 1) +
                          (size_t)TJ * (C | 1) + (size_t)TJ * H1 * CW +
                          (size_t)TI * H1 * TJ + TJ * 4 + TI * 4 + 4 * kHidden +
                          4 * kThreads) +
         TJ + TI;
}

// Tile sizes for (C, CO | 0, M): 1 on success, 0 if the shape is refused.
int v1_bwd_tiles(int C, int CO, int M, int* TJ, int* TI) {
  const int H1 = kHidden + 1;
  const int CW = CO > 0 ? CO : C;
  if (C < 1 || C > kMaxOut || CW > kMaxX / H1 || M < 1) return 0;
  int tj = kMaxOut / C;
  if (tj > kMaxTJ) tj = kMaxTJ;
  if (tj > kMaxX / (H1 * CW)) tj = kMaxX / (H1 * CW);
  int ti = kTileFloats / (H1 * (C | 1));
  if (ti > kMaxTI) ti = kMaxTI;
  if (ti > M) ti = M;
  while (ti > 1 && v1_bwd_smem(C, CW, tj, ti) > kMaxSmem) --ti;
  if (tj < 1 || ti < 1 || v1_bwd_smem(C, CW, tj, ti) > kMaxSmem) return 0;
  *TJ = tj;
  *TI = ti;
  return 1;
}

}  // namespace

// Source tiles per cloud of K2v1 (the caller picks the number of blocks and
// sizes the partials), or 0 if the shape is refused. CO == 0: depthwise.
extern "C" int mcconv_v1_bwd_tiles(int N, int M, int C, int CO) {
  int TJ, TI;
  if (N < 1 || CO < 0 || !v1_bwd_tiles(C, CO, M, &TJ, &TI)) return 0;
  return (N + TJ - 1) / TJ;
}

// d_wf (B, N, C); part_w (blocks, (H+1) * C * (CO | 1)) zeroed by the caller;
// part_p (blocks, 4, H). CO == 0 selects the depthwise conv.
extern "C" int mcconv_v1_bwd_launch(const void* smp, const void* smask, const void* src,
                                    const void* srcmask, const void* wf, const void* w1,
                                    const void* b1, const void* w2, const void* b2,
                                    const void* cnt, const void* dout, int B, int M, int N,
                                    int C, int CO, int H, int mean, float r2, float radius,
                                    int blocks, void* dwf, void* part_w, void* part_p,
                                    void* stream) {
  int TJ, TI;
  if (H != kHidden || B < 1 || N < 1 || blocks < 1 || CO < 0 ||
      !v1_bwd_tiles(C, CO, M, &TJ, &TI))
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = v1_bwd_smem(C, CO > 0 ? CO : C, TJ, TI);
  cudaError_t err = cudaFuncSetAttribute(
      mcconv_v1_bwd_kernel<kHidden>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  mcconv_v1_bwd_kernel<kHidden><<<blocks, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(smp), static_cast<const uint8_t*>(smask),
      static_cast<const float*>(src), static_cast<const uint8_t*>(srcmask),
      static_cast<const float*>(wf), static_cast<const float*>(w1),
      static_cast<const float*>(b1), static_cast<const float*>(w2),
      static_cast<const float*>(b2), static_cast<const float*>(cnt),
      static_cast<const float*>(dout), B, M, N, C, CO, mean, TJ, TI, r2, radius,
      static_cast<float*>(dwf), static_cast<float*>(part_w), static_cast<float*>(part_p));
  MCCNN_LAUNCH_RETURN();
}
