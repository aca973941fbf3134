// K2: the dense Monte-Carlo convolution, backward.
//
// Replaces mccnn_tpu/ops/pallas/dense_conv.py::_bwd_kernel_b (reached through
// _bwd_call_b from the custom_vjp of dense_mc_conv). K1 (dense_conv.cu) writes
// G[b,i,h,c] = sum_j a_h(i,j) f~[b,j,c] and out = s_i * (G . [W2; b2]); given
// t = s * dout (s = 1/count in mean mode, 0 for masked samples), this computes
// the gradients with respect to f~, W1, b1, W2 and b2:
//
//   dG[i,h,c]  = sum_o t[i,o] Wcat[h*C+c, o]        (Wcat = [W2 as (H*C, CO); b2])
//   dWcat      = G^T t                               (-> dW2, db2)
//   d_f~[j,c]  = sum_i sum_{h<=H} a_h(i,j) dG[i,h,c]
//   dpre_h(i,j) = [pre_h > 0] [in radius] sum_c dG[i,h,c] f~[j,c]
//   dW1[k,h]   = sum_{i,j} dpre_h(i,j) (p_j - x_i)_k / r,   db1[h] = sum dpre_h.
//
// The TPU kernel walks source tiles on a sequential grid and carries dW1..db2
// in scratch from step to step, with bf16 planes and features. Blocks on the
// H100 run in no order, so the port splits the work into kernels that each
// give every output one writer, all in fp32:
//
//   1. dG: a 64x64x16 tiled GEMM (t @ Wcat^T) whose B operand reads W2 and b2
//      in place; the depthwise form is elementwise.
//   2. dWcat: the same tiled GEMM in its transposed form (G^T t), split over
//      the rows of the batch (R = B*M up to 16k at conv_0_1) into chunks
//      whose partial products a third kernel sums in chunk order.
//   3. the pair kernel: a block owns TJ sources of one cloud and walks all
//      samples in tiles of TI. Per tile it stages dG and the sample positions
//      in shared memory and builds the (TI, H+1, TJ) plane of a_h values with
//      the same expressions as K1's pair kernel (d2 with __fmul_rn/__fadd_rn,
//      so a pair at the radius boundary is in or out on both passes). Each
//      thread then accumulates up to four (source, channel) outputs of d_f~,
//      and, for a fixed h = thread % H, the dpre dot products of its pairs into
//      four registers (dW1[:, h], db1[h]). The block sums those in thread order
//      and writes one partial per block; the reduction kernel sums the
//      partials in block order.
//
// No float atomics anywhere: two calls give bit-identical gradients, as the
// reference's do (tests/test_pallas_mcconv.py:82). The ReLU step is taken as
// a_h > 0, i.e. pre_h > 0 in fp32, so pre_h == 0 takes the step value 0 as
// jnp.where(pre > 0, ...) does.
//
// What bounds it on the H100: the pair kernel's arithmetic (per pair, 8
// pre-activations, (H+1)*C FMAs for d_f~ and H*C for dpre) and, at the global
// site, the bytes of W2 and dW2 (9.4 MB each at C=256, CO=1024). A simple
// first design: fp32 FMAs from shared memory, no tensor cores.
//
// Limits: H == 8 (KERNEL_HIDDEN) and C <= 1024, as K1.

#include "common.cuh"

namespace {

constexpr int kHidden = 8;  // H, as K1's KERNEL_HIDDEN
constexpr int kThreads = 256;  // a multiple of kHidden (see the pair kernel)
constexpr int kOutPerThread = 4;
constexpr int kMaxOut = kThreads * kOutPerThread;
constexpr int kTileFloats = 9600;  // the staged dG tile, TI * (H+1) * (C|1) floats
constexpr int kMaxTI = 16;
constexpr int kMaxTJ = 64;

constexpr int kBM = 64, kBN = 64, kBK = 16;

// dG[r, n] = sum_o t[r, o] * Wcat[n, o]; rows n < KW of Wcat are w2 (KW, CO),
// the rest b2 (NC - KW, CO).
__global__ void mcconv_bwd_dg_full_kernel(const float* __restrict__ t,
                                          const float* __restrict__ w2,
                                          const float* __restrict__ b2, int R, int CO,
                                          int KW, int NC, float* __restrict__ dG) {
  __shared__ float As[kBK][kBM + 4];
  __shared__ float Bs[kBK][kBN + 4];
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const int r0 = blockIdx.y * kBM, n0 = blockIdx.x * kBN;
  float acc[4][4] = {};
  for (int k0 = 0; k0 < CO; k0 += kBK) {
    for (int i = threadIdx.x; i < kBM * kBK; i += blockDim.x) {
      const int rr = i / kBK, kk = i % kBK;
      const int r = r0 + rr, k = k0 + kk;
      As[kk][rr] = (r < R && k < CO) ? t[(size_t)r * CO + k] : 0.f;
    }
    for (int i = threadIdx.x; i < kBN * kBK; i += blockDim.x) {
      const int nn = i / kBK, kk = i % kBK;
      const int n = n0 + nn, k = k0 + kk;
      float w = 0.f;
      if (n < NC && k < CO)
        w = n < KW ? w2[(size_t)n * CO + k] : b2[(size_t)(n - KW) * CO + k];
      Bs[kk][nn] = w;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kBK; ++kk) {
      float a[4], w[4];
#pragma unroll
      for (int u = 0; u < 4; ++u) a[u] = As[kk][ty + 16 * u];
#pragma unroll
      for (int v = 0; v < 4; ++v) w[v] = Bs[kk][tx + 16 * v];
#pragma unroll
      for (int u = 0; u < 4; ++u)
#pragma unroll
        for (int v = 0; v < 4; ++v) acc[u][v] += a[u] * w[v];
    }
    __syncthreads();
  }
#pragma unroll
  for (int u = 0; u < 4; ++u) {
    const int r = r0 + ty + 16 * u;
    if (r >= R) continue;
#pragma unroll
    for (int v = 0; v < 4; ++v) {
      const int n = n0 + tx + 16 * v;
      if (n < NC) dG[(size_t)r * NC + n] = acc[u][v];
    }
  }
}

// part[z, m, n] = sum over rows r of chunk z of A[r, m] * t[r, n]
// (A = G as (R, MA), t as (R, CO)); chunk z covers rows [z*rchunk, (z+1)*rchunk).
__global__ void mcconv_bwd_dw2_full_kernel(const float* __restrict__ A,
                                           const float* __restrict__ t, int R, int MA,
                                           int CO, int rchunk, float* __restrict__ part) {
  __shared__ float As[kBK][kBM];
  __shared__ float Bs[kBK][kBN];
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const int m0 = blockIdx.y * kBM, n0 = blockIdx.x * kBN;
  const int rb = blockIdx.z * rchunk;
  const int re = min(R, rb + rchunk);
  float acc[4][4] = {};
  for (int k0 = rb; k0 < re; k0 += kBK) {
    for (int i = threadIdx.x; i < kBK * kBM; i += blockDim.x) {
      const int kk = i / kBM, mm = i % kBM;
      const int r = k0 + kk, m = m0 + mm;
      As[kk][mm] = (r < re && m < MA) ? A[(size_t)r * MA + m] : 0.f;
    }
    for (int i = threadIdx.x; i < kBK * kBN; i += blockDim.x) {
      const int kk = i / kBN, nn = i % kBN;
      const int r = k0 + kk, n = n0 + nn;
      Bs[kk][nn] = (r < re && n < CO) ? t[(size_t)r * CO + n] : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kBK; ++kk) {
      float a[4], w[4];
#pragma unroll
      for (int u = 0; u < 4; ++u) a[u] = As[kk][ty + 16 * u];
#pragma unroll
      for (int v = 0; v < 4; ++v) w[v] = Bs[kk][tx + 16 * v];
#pragma unroll
      for (int u = 0; u < 4; ++u)
#pragma unroll
        for (int v = 0; v < 4; ++v) acc[u][v] += a[u] * w[v];
    }
    __syncthreads();
  }
  float* out = part + (size_t)blockIdx.z * MA * CO;
#pragma unroll
  for (int u = 0; u < 4; ++u) {
    const int m = m0 + ty + 16 * u;
    if (m >= MA) continue;
#pragma unroll
    for (int v = 0; v < 4; ++v) {
      const int n = n0 + tx + 16 * v;
      if (n < CO) out[(size_t)m * CO + n] = acc[u][v];
    }
  }
}

// dG[r, h, c] = t[r, c] * (h < H ? w2[h, c] : b2[c]).
__global__ void mcconv_bwd_dg_depthwise_kernel(const float* __restrict__ t,
                                               const float* __restrict__ w2,
                                               const float* __restrict__ b2, int R, int H,
                                               int C, float* __restrict__ dG) {
  const size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  const size_t total = (size_t)R * (H + 1) * C;
  if (i >= total) return;
  const int c = i % C;
  const int h = (i / C) % (H + 1);
  const size_t r = i / ((size_t)(H + 1) * C);
  const float w = h < H ? w2[h * C + c] : b2[c];
  dG[i] = t[r * C + c] * w;
}

// part[z, h, c] = sum over rows r of chunk z of G[r, h, c] * t[r, c].
__global__ void mcconv_bwd_dw2_depthwise_kernel(const float* __restrict__ G,
                                                const float* __restrict__ t, int R, int H1,
                                                int C, int rchunk, float* __restrict__ part) {
  const int l = blockIdx.x * blockDim.x + threadIdx.x;
  if (l >= H1 * C) return;
  const int c = l % C;
  const int rb = blockIdx.y * rchunk;
  const int re = min(R, rb + rchunk);
  float acc = 0.f;
  for (int r = rb; r < re; ++r) acc += G[(size_t)r * H1 * C + l] * t[(size_t)r * C + c];
  part[(size_t)blockIdx.y * H1 * C + l] = acc;
}

// out[l] = sum_{z < Z} part[z * L + l], summed in z order.
__global__ void mcconv_bwd_reduce_kernel(const float* __restrict__ part, int Z, int L,
                                         float* __restrict__ out) {
  const int l = blockIdx.x * blockDim.x + threadIdx.x;
  if (l >= L) return;
  float acc = 0.f;
  for (int z = 0; z < Z; ++z) acc += part[(size_t)z * L + l];
  out[l] = acc;
}

template <int H>
__global__ void mcconv_bwd_pair_kernel(const float* __restrict__ smp,
                                       const uint8_t* __restrict__ smask,
                                       const float* __restrict__ src,
                                       const uint8_t* __restrict__ srcmask,
                                       const float* __restrict__ wf,
                                       const float* __restrict__ w1,
                                       const float* __restrict__ b1,
                                       const float* __restrict__ dG, int M, int N, int C,
                                       int TJ, int TI, float r2, float radius,
                                       float* __restrict__ dwf, float* __restrict__ part) {
  constexpr int H1 = H + 1;
  const int Cs = C | 1;  // odd row stride: strided reads across rows hit distinct banks
  extern __shared__ float sm[];
  float* sdg = sm;                          // [TI][H1][Cs]
  float* sfeat = sdg + TI * H1 * Cs;        // [TJ][Cs]
  float* plane = sfeat + TJ * Cs;           // [TI][H1][TJ]
  float* spos = plane + TI * H1 * TJ;       // [TJ][4]: x, y, z, |p|^2
  float* qpos = spos + TJ * 4;              // [TI][4]
  float* sw1 = qpos + TI * 4;               // [3][H]
  float* sb1 = sw1 + 3 * H;                 // [H]
  float* sred = sb1 + H;                    // [blockDim][4]
  uint8_t* svalid = reinterpret_cast<uint8_t*>(sred + 4 * blockDim.x);  // [TJ]
  uint8_t* qvalid = svalid + TJ;                                        // [TI]

  const int b = blockIdx.y;
  const int j0 = blockIdx.x * TJ;
  const int nj = min(TJ, N - j0);
  const int nout = TJ * C;

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
  for (int t = threadIdx.x; t < 3 * H; t += blockDim.x) sw1[t] = w1[t];
  for (int t = threadIdx.x; t < H; t += blockDim.x) sb1[t] = b1[t];

  float acc[kOutPerThread];
#pragma unroll
  for (int k = 0; k < kOutPerThread; ++k) acc[k] = 0.f;
  // blockDim is a multiple of H, so this thread's items all share h = tid % H.
  float gx = 0.f, gy = 0.f, gz = 0.f, gb = 0.f;

  for (int i0 = 0; i0 < M; i0 += TI) {
    const int ni = min(TI, M - i0);
    __syncthreads();  // the previous tile is consumed (and the prologue stored)
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
    const float* gtile = dG + ((size_t)b * M + i0) * H1 * C;
    for (int t = threadIdx.x; t < ni * H1 * C; t += blockDim.x) {
      const int row = t / C, c = t % C;  // row = i * H1 + h
      sdg[row * Cs + c] = gtile[t];
    }
    __syncthreads();
    for (int t = threadIdx.x; t < ni * TJ; t += blockDim.x) {
      const int i = t / TJ, j = t % TJ;
      const float px = spos[4 * j], py = spos[4 * j + 1], pz = spos[4 * j + 2];
      const float qx = qpos[4 * i], qy = qpos[4 * i + 1], qz = qpos[4 * i + 2];
      const float d2 = pair_d2_rn(qx, qy, qz, qpos[4 * i + 3], px, py, pz, spos[4 * j + 3]);
      const bool in = qvalid[i] && svalid[j] && d2 <= r2;
      // the offsets and pre-activations exactly as K1's pair kernel forms them
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
    part[((size_t)b * gridDim.x + blockIdx.x) * 4 * H + k * H + h] = s;
  }
}

int pair_tiles(int C, int M, int* TJ, int* TI) {
  const int Cs = C | 1;
  int tj = kMaxOut / C;
  if (tj > kMaxTJ) tj = kMaxTJ;
  int ti = kTileFloats / ((kHidden + 1) * Cs);
  if (ti > kMaxTI) ti = kMaxTI;
  if (ti > M) ti = M;
  if (tj < 1 || ti < 1) return 0;
  *TJ = tj;
  *TI = ti;
  return 1;
}

size_t pair_smem(int C, int TJ, int TI, int H) {
  const int Cs = C | 1;
  return sizeof(float) * ((size_t)TI * (H + 1) * Cs + (size_t)TJ * Cs +
                          (size_t)TI * (H + 1) * TJ + TJ * 4 + TI * 4 + 3 * H + H +
                          4 * kThreads) +
         TJ + TI;
}

}  // namespace

// Number of source blocks per cloud of the pair kernel (the caller sizes the
// partial buffer as B * blocks * 4 * H floats), or 0 if the shape is refused.
extern "C" int mcconv_bwd_pair_blocks(int N, int M, int C) {
  int TJ, TI;
  if (C < 1 || C > kMaxOut || N < 1 || M < 1 || !pair_tiles(C, M, &TJ, &TI)) return 0;
  return (N + TJ - 1) / TJ;
}

extern "C" int mcconv_bwd_pair_launch(const void* smp, const void* smask, const void* src,
                                      const void* srcmask, const void* wf, const void* w1,
                                      const void* b1, const void* dG, int B, int M, int N,
                                      int C, int H, float r2, float radius, void* dwf,
                                      void* part, void* stream) {
  int TJ, TI;
  if (H != kHidden || C < 1 || C > kMaxOut || M < 1 || N < 1 || B < 1 ||
      !pair_tiles(C, M, &TJ, &TI))
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = pair_smem(C, TJ, TI, H);
  cudaError_t err = cudaFuncSetAttribute(
      mcconv_bwd_pair_kernel<kHidden>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid((N + TJ - 1) / TJ, B);
  mcconv_bwd_pair_kernel<kHidden><<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(smp), static_cast<const uint8_t*>(smask),
      static_cast<const float*>(src), static_cast<const uint8_t*>(srcmask),
      static_cast<const float*>(wf), static_cast<const float*>(w1),
      static_cast<const float*>(b1), static_cast<const float*>(dG), M, N, C, TJ, TI, r2,
      radius, static_cast<float*>(dwf), static_cast<float*>(part));
  MCCNN_LAUNCH_RETURN();
}

extern "C" int mcconv_bwd_dg_full_launch(const void* t, const void* w2, const void* b2,
                                         int R, int CO, int KW, int NC, void* dG,
                                         void* stream) {
  dim3 grid((NC + kBN - 1) / kBN, (R + kBM - 1) / kBM);
  mcconv_bwd_dg_full_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(t), static_cast<const float*>(w2),
      static_cast<const float*>(b2), R, CO, KW, NC, static_cast<float*>(dG));
  MCCNN_LAUNCH_RETURN();
}

extern "C" int mcconv_bwd_dw2_full_launch(const void* G, const void* t, int R, int MA,
                                          int CO, int splits, int rchunk, void* part,
                                          void* stream) {
  dim3 grid((CO + kBN - 1) / kBN, (MA + kBM - 1) / kBM, splits);
  mcconv_bwd_dw2_full_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(G), static_cast<const float*>(t), R, MA, CO, rchunk,
      static_cast<float*>(part));
  MCCNN_LAUNCH_RETURN();
}

extern "C" int mcconv_bwd_dg_depthwise_launch(const void* t, const void* w2, const void* b2,
                                              int R, int H, int C, void* dG, void* stream) {
  const size_t total = (size_t)R * (H + 1) * C;
  const unsigned blocks = (unsigned)((total + kThreads - 1) / kThreads);
  mcconv_bwd_dg_depthwise_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(t), static_cast<const float*>(w2),
      static_cast<const float*>(b2), R, H, C, static_cast<float*>(dG));
  MCCNN_LAUNCH_RETURN();
}

extern "C" int mcconv_bwd_dw2_depthwise_launch(const void* G, const void* t, int R, int H1,
                                               int C, int splits, int rchunk, void* part,
                                               void* stream) {
  dim3 grid((H1 * C + kThreads - 1) / kThreads, splits);
  mcconv_bwd_dw2_depthwise_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(G), static_cast<const float*>(t), R, H1, C, rchunk,
      static_cast<float*>(part));
  MCCNN_LAUNCH_RETURN();
}

extern "C" int mcconv_bwd_reduce_launch(const void* part, int Z, int L, void* out,
                                        void* stream) {
  const unsigned blocks = (unsigned)((L + kThreads - 1) / kThreads);
  mcconv_bwd_reduce_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(part), Z, L, static_cast<float*>(out));
  MCCNN_LAUNCH_RETURN();
}
