// K1p: the dense Monte-Carlo convolution, forward, with its pair planes formed
// on the tensor cores.
//
// Replaces mccnn_tpu/ops/pallas/dense_conv.py::_plane_fill_mxu (:314), which
// MCCNN_DENSE_PLANES=mxu (:357) puts in place of _plane_fill inside the v2
// forward _fwd_kernel_b (:409, called at :656). The TPU variant forms each
// pre-activation plane by a K = 2 matmul, [cw_h | 1] @ [1 ; -sw_h], instead of
// a broadcast subtract, and keeps the penalty, the ReLU and the cast on the
// vector unit; its docstring (:320-329) records that it bought nothing there.
// This kernel asks the same question of the H100.
//
// It computes K1's function (csrc/dense_conv.cu: G[b,i,h,c] = sum_j a_h(i,j)
// f~[b,j,c] and the in-radius count, then K1's projection kernel) with the
// pre-activations in the reference's factored form
//
//   pre_h(i, j) = (cw_h(j) - sw_h(i)) + b1_h,  cw = (p_j . W1) / r,  sw = (x_i . W1) / r,
//
// and not K1's offset form ((p_j - x_i) / r) . W1 + b1. A block takes TS
// samples of one cloud and walks the sources in tiles of 32, as K1 does. Per
// tile:
//   1. the CUDA cores stage positions and f~, form cw for the tile's rows and
//      the in-radius mask plane (d2 as pair_d2_rn forms it, the a_H row);
//   2. the tensor cores form every (32 sources x TS samples) pre_h plane: one
//      mma.sync.aligned.m16n8k8 TF32 product per (h, 16 sources, 8 samples),
//      A[j] = [c1 c2 c3 1 1 1 0 0] and B[s] = [1 1 1 -s1 -s2 -s3 0 0], with
//      cw = c1 + c2 + c3 and sw = s1 + s2 + s3 split exactly into TF32
//      pieces (11 significant bits each: three hold fp32's 24), and b1_h in
//      the accumulator. Every product is exact (a piece times 1), so the plane
//      is the fp32 sum of cw, -sw and b1, within the tensor core's fp32
//      accumulation of the factored form;
//   3. the CUDA cores apply the mask and the ReLU to each accumulator in
//      registers and store the plane, then contract it with f~ into G as K1
//      does, fp32, in source order.
// No atomics: two calls are bit-identical. The projection is K1's kernel.
//
// What bounds it on the H100: as K1, the contraction's (H+1) FMAs per pair
// and channel on the CUDA cores and their shared-memory reads; the plane's
// 8 MMAs per tile and h are a small part (16 H TF32 FLOPs a pair against K1's
// 6 H fp32 ones). Limits: H == 8, C <= 1024.

#include "common.cuh"

namespace {

constexpr int kThreads = 256;    // 8 warps
constexpr int kTJ = 32;          // sources per tile: two 16-row MMA blocks
constexpr int kPairsPerThread = 4;
constexpr int kMaxPairs = kThreads * kPairsPerThread;
constexpr uint32_t kOne = 0x3f800000u;  // 1.0f, exact in TF32

__device__ __forceinline__ uint32_t to_tf32(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(x));
  return r;
}

// x = hi + mid + lo exactly, each piece a TF32 value: x - hi and its residual
// are exact in fp32, and the third piece has at most 3 significant bits.
__device__ __forceinline__ void split_tf32(float x, uint32_t* out) {
  const uint32_t hi = to_tf32(x);
  const float r1 = __fsub_rn(x, __uint_as_float(hi));
  const uint32_t mid = to_tf32(r1);
  out[0] = hi;
  out[1] = mid;
  out[2] = to_tf32(__fsub_rn(r1, __uint_as_float(mid)));
}

__device__ __forceinline__ void mma_tf32(float* d, const uint32_t* a, const uint32_t* b,
                                         float c) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%10,%11,%12,%13};\n"
      : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]), "f"(c), "f"(c),
        "f"(c), "f"(c));
}

template <int H>
__global__ void __launch_bounds__(kThreads)
    mcconv_planes_pair_kernel(const float* __restrict__ smp, const uint8_t* __restrict__ smask,
                              const float* __restrict__ src, const uint8_t* __restrict__ srcmask,
                              const float* __restrict__ wf, const float* __restrict__ w1,
                              const float* __restrict__ b1, int M, int N, int C, int TS,
                              int TSP, float r2, float radius, float* __restrict__ G,
                              float* __restrict__ cnt) {
  constexpr int H1 = H + 1;
  extern __shared__ float sm[];
  float* plane = sm;                         // [kTJ][H1][TSP]
  float* sfeat = plane + kTJ * H1 * TSP;     // [kTJ][C]
  float* spos = sfeat + kTJ * C;             // [kTJ][4]: x, y, z, |p|^2
  float* qpos = spos + kTJ * 4;              // [TSP][4]
  float* sw1 = qpos + TSP * 4;               // [3][H]
  float* sb1 = sw1 + 3 * H;                  // [H]
  uint32_t* cws = reinterpret_cast<uint32_t*>(sb1 + H);  // [kTJ][H][3]: cw's pieces
  uint32_t* sws = cws + kTJ * H * 3;                      // [TSP][H][3]: -sw's pieces
  uint8_t* svalid = reinterpret_cast<uint8_t*>(sws + TSP * H * 3);  // [kTJ]
  uint8_t* qvalid = svalid + kTJ;                                     // [TSP]

  const int b = blockIdx.y;
  const int i0 = blockIdx.x * TS;
  const int ms = min(TS, M - i0);
  const float* S = src + (size_t)b * N * 3;
  const float* F = wf + (size_t)b * N * C;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int grp = lane / 4, tig = lane % 4;

  for (int t = threadIdx.x; t < TSP; t += blockDim.x) {
    float x = 0.f, y = 0.f, z = 0.f;
    uint8_t v = 0;
    if (t < ms) {
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
  for (int t = threadIdx.x; t < 3 * H; t += blockDim.x) sw1[t] = w1[t];
  for (int t = threadIdx.x; t < H; t += blockDim.x) sb1[t] = b1[t];
  __syncthreads();
  for (int t = threadIdx.x; t < TSP * H; t += blockDim.x) {
    const int s = t / H, h = t % H;
    uint32_t* piece = sws + 3 * t;
    split_tf32(mc_w1_proj(qpos[4 * s], qpos[4 * s + 1], qpos[4 * s + 2], sw1, H, h, radius), piece);
#pragma unroll
    for (int k = 0; k < 3; ++k) piece[k] ^= 0x80000000u;  // -sw: the sign bit, exact
  }

  float acc[kPairsPerThread][H1];
  float count[kPairsPerThread];
#pragma unroll
  for (int k = 0; k < kPairsPerThread; ++k) {
    count[k] = 0.f;
#pragma unroll
    for (int h = 0; h < H1; ++h) acc[k][h] = 0.f;
  }
  const int npairs = TS * C;
  const int ntiles = H * (kTJ / 16) * (TSP / 8);  // MMA tiles a source tile

  for (int j0 = 0; j0 < N; j0 += kTJ) {
    const int nj = min(kTJ, N - j0);
    __syncthreads();  // the previous tile is consumed (and the prologue stored)
    for (int t = threadIdx.x; t < kTJ; t += blockDim.x) {
      float x = 0.f, y = 0.f, z = 0.f;
      uint8_t v = 0;
      if (t < nj) {
        x = S[3 * (j0 + t)];
        y = S[3 * (j0 + t) + 1];
        z = S[3 * (j0 + t) + 2];
        v = srcmask[(size_t)b * N + j0 + t];
      }
      spos[4 * t] = x;
      spos[4 * t + 1] = y;
      spos[4 * t + 2] = z;
      spos[4 * t + 3] = sq_norm_rn(x, y, z);
      svalid[t] = v;
    }
    for (int t = threadIdx.x; t < nj * C; t += blockDim.x) sfeat[t] = F[(size_t)j0 * C + t];
    __syncthreads();
    for (int t = threadIdx.x; t < kTJ * H; t += blockDim.x) {
      const int j = t / H, h = t % H;
      split_tf32(mc_w1_proj(spos[4 * j], spos[4 * j + 1], spos[4 * j + 2], sw1, H, h, radius),
                 cws + 3 * t);
    }
    for (int t = threadIdx.x; t < kTJ * TSP; t += blockDim.x) {
      const int j = t / TSP, s = t % TSP;
      const float d2 = pair_d2_rn(qpos[4 * s], qpos[4 * s + 1], qpos[4 * s + 2], qpos[4 * s + 3],
                                  spos[4 * j], spos[4 * j + 1], spos[4 * j + 2], spos[4 * j + 3]);
      plane[((size_t)j * H1 + H) * TSP + s] = (qvalid[s] && svalid[j] && d2 <= r2) ? 1.f : 0.f;
    }
    __syncthreads();
    // The a_h planes on the tensor cores: tile (h, 16 sources, 8 samples) per
    // warp iteration (warp-uniform, as mma.sync.aligned requires).
    for (int tile = warp; tile < ntiles; tile += kThreads / 32) {
      const int h = tile % H;
      const int jb = (tile / H) % (kTJ / 16), sb = tile / (H * (kTJ / 16));
      const int ja = jb * 16 + grp, jc = ja + 8, s = sb * 8 + grp;
      const uint32_t* ca = cws + (ja * H + h) * 3;
      const uint32_t* cc = cws + (jc * H + h) * 3;
      const uint32_t* sp = sws + (s * H + h) * 3;
      // A row j: [c1 c2 c3 1 | 1 1 0 0]; B column s: [1 1 1 -s1 | -s2 -s3 0 0]
      const uint32_t a[4] = {tig < 3 ? ca[tig] : kOne, tig < 3 ? cc[tig] : kOne,
                             tig < 2 ? kOne : 0u, tig < 2 ? kOne : 0u};
      const uint32_t bf[2] = {tig < 3 ? kOne : sp[0], tig < 2 ? sp[1 + tig] : 0u};
      float d[4];
      mma_tf32(d, a, bf, sb1[h]);
      const int sc = sb * 8 + 2 * tig;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int j = e < 2 ? ja : jc, se = sc + (e & 1);
        const size_t row = (size_t)j * H1;
        const bool in = plane[(row + H) * TSP + se] != 0.f;
        plane[(row + h) * TSP + se] = in ? fmaxf(d[e], 0.f) : 0.f;
      }
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < kPairsPerThread; ++k) {
      const int q = threadIdx.x + k * blockDim.x;
      if (q < npairs) {
        const int s = q / C, c = q % C;
        for (int j = 0; j < nj; ++j) {
          const float f = sfeat[j * C + c];
          const float* pl = plane + (size_t)j * H1 * TSP + s;
#pragma unroll
          for (int h = 0; h < H1; ++h) acc[k][h] += pl[h * TSP] * f;
        }
        if (c == 0)
          for (int j = 0; j < nj; ++j) count[k] += plane[((size_t)j * H1 + H) * TSP + s];
      }
    }
  }
#pragma unroll
  for (int k = 0; k < kPairsPerThread; ++k) {
    const int q = threadIdx.x + k * blockDim.x;
    if (q < npairs) {
      const int s = q / C, c = q % C;
      if (s < ms) {
        float* g = G + ((size_t)b * M + i0 + s) * H1 * C + c;
#pragma unroll
        for (int h = 0; h < H1; ++h) g[(size_t)h * C] = acc[k][h];
        if (c == 0) cnt[(size_t)b * M + i0 + s] = count[k];
      }
    }
  }
}

}  // namespace

// The arguments of mcconv_pair_launch (csrc/dense_conv.cu): G (B, M, H+1, C)
// and cnt (B, M) for K1's projection kernel.
extern "C" int mcconv_planes_pair_launch(const void* smp, const void* smask, const void* src,
                                         const void* srcmask, const void* wf, const void* w1,
                                         const void* b1, int B, int M, int N, int C, int H,
                                         float r2, float radius, void* G, void* cnt,
                                         void* stream) {
  if (H != 8 || C < 1 || C > kMaxPairs || M < 1 || N < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  int TS = kMaxPairs / C;
  if (TS > 64) TS = 64;
  if (TS > M) TS = M;
  const int TSP = (TS + 7) / 8 * 8;  // the MMA's 8-sample columns
  const size_t smem = sizeof(float) * ((size_t)kTJ * (H + 1) * TSP + (size_t)kTJ * C + kTJ * 4 +
                                       TSP * 4 + 3 * H + H) +
                      sizeof(uint32_t) * ((size_t)kTJ * H * 3 + (size_t)TSP * H * 3) + kTJ + TSP;
  cudaError_t err = cudaFuncSetAttribute(mcconv_planes_pair_kernel<8>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid((M + TS - 1) / TS, B);
  mcconv_planes_pair_kernel<8><<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(smp), static_cast<const uint8_t*>(smask),
      static_cast<const float*>(src), static_cast<const uint8_t*>(srcmask),
      static_cast<const float*>(wf), static_cast<const float*>(w1),
      static_cast<const float*>(b1), M, N, C, TS, TSP, r2, radius, static_cast<float*>(G),
      static_cast<float*>(cnt));
  MCCNN_LAUNCH_RETURN();
}
