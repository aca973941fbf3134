// K5: the Monte-Carlo convolution over Hilbert tile pairs, forward.
//
// Replaces mccnn_tpu/ops/pallas/tile_conv.py::_fwd_kernel (:525, called at
// :982 through _fwd_call from tile_mc_conv). Samples and sources are sorted
// along a Hilbert curve; the host builds a chunked step list in which step k
// of cloud b pairs the sample tile i_ids[b, k] (T = 128 sorted samples; the
// list is non-decreasing in it) with up to G candidate minor tiles
// j_ids[b, :, k] (Tm = 32 sorted sources each; the id n_minor marks none).
// For every sample i of the tile and every valid source j of those minors
// with d2(i, j) <= r2:
//
//   G[b,i,h,c] = sum_j a_h(i,j) f~[b,j,c]   (a_h = relu(pre_h), h < H; a_H = 1)
//   cnt[b,i]   = the number of such j
//
// then out = sum_h G[.., h, c] W2[h, c] + G[.., H, c] b2[c] (depthwise, in
// this kernel's epilogue) or K1's projection GEMM (full conv, a second
// launch), times 1/cnt in mean mode and 0 for an invalid sample.
//
// The TPU kernel runs one grid step per list step in order and accumulates
// each output tile across its consecutive steps in VMEM. On the H100 a block
// takes one (cloud, sample tile, block of CB channels) and walks that tile's
// contiguous run of steps, run[b, t] to run[b, t+1] (built on the host with
// searchsorted), so every output row has one writer and the sums run in step
// order: no atomics, two calls bit-identical.
//
// What bounds it on the H100: the pair arithmetic. Each candidate pair costs
// a d2 and H pre-activations (formed once per block in a shared-memory plane
// and reused by its CB channels), then (H+1) FMAs per channel. The simple
// design: per half-minor of 16 sources the block stages positions and the
// CB-channel slice of f~, fills the (16, H+1, 128) a_h plane with the exact
// expressions of K1 (pair_d2_rn, mc_offset, mc_preact in common.cuh, so a
// tile site and a dense site agree bit for bit on a_h), and each thread
// accumulates up to 8 (sample, channel) outputs for all H+1 rows in
// registers. Invalid rows are masked by their flags (the TPU kernel parks
// them at a far sentinel coordinate, whose expanded d2 against another
// sentinel cancels to ~0). Everything is fp32 (the TPU kernel holds features
// in bf16). Limits: H == 8 and T == 128, Tm == 32, G <= 64. The source rows
// may run past the last minor (the layout keeps them in the major tiling the
// backward, K6, reads).

#include "common.cuh"

namespace {

constexpr int kT = 128;       // samples per tile
constexpr int kTm = 32;       // sources per candidate minor
constexpr int kTJ = 16;       // sources per shared-memory chunk
constexpr int kThreads = 256;
constexpr int kOut = 8;       // (sample, channel) outputs per thread
constexpr int kMaxCB = kThreads * kOut / kT;  // 16 channels per block
constexpr int kMaxG = 64;

template <int H>
__global__ void __launch_bounds__(kThreads)
tile_conv_kernel(const float* __restrict__ smp, const uint8_t* __restrict__ svalid,
                 const float* __restrict__ src, const uint8_t* __restrict__ pvalid,
                 const float* __restrict__ wf, const int* __restrict__ j_ids,
                 const int* __restrict__ run, const float* __restrict__ w1,
                 const float* __restrict__ b1, const float* __restrict__ w2,
                 const float* __restrict__ b2, int NS, int NP, int C, int CB, int S, int G,
                 int n_tiles, int sentinel, float r2, float radius, int mean, int depthwise,
                 float* __restrict__ out, float* __restrict__ cnt) {
  constexpr int H1 = H + 1;
  extern __shared__ float sm[];
  float* plane = sm;                      // [kTJ][H1][kT]
  float* sfeat = plane + kTJ * H1 * kT;   // [kTJ][CB]
  float* spos = sfeat + kTJ * kMaxCB;     // [kTJ][4]: x, y, z, |p|^2
  float* qpos = spos + kTJ * 4;           // [kT][4]
  float* sw1 = qpos + kT * 4;             // [3][H]
  float* sb1 = sw1 + 3 * H;               // [H]
  int* sj = reinterpret_cast<int*>(sb1 + H);                       // [kMaxG]
  uint8_t* svld = reinterpret_cast<uint8_t*>(sj + kMaxG);          // [kTJ]
  uint8_t* qvld = svld + kTJ;                                      // [kT]

  const int cb = blockIdx.x, t = blockIdx.y, b = blockIdx.z;
  const int c0 = cb * CB;
  const float* P = src + (size_t)b * NP * 3;
  const uint8_t* PV = pvalid + (size_t)b * NP;
  const float* F = wf + (size_t)b * NP * C;

  for (int s = threadIdx.x; s < kT; s += blockDim.x) {
    const size_t row = (size_t)b * NS + (size_t)t * kT + s;
    const float x = smp[3 * row], y = smp[3 * row + 1], z = smp[3 * row + 2];
    qpos[4 * s] = x;
    qpos[4 * s + 1] = y;
    qpos[4 * s + 2] = z;
    qpos[4 * s + 3] = sq_norm_rn(x, y, z);
    qvld[s] = svalid[row];
  }
  for (int i = threadIdx.x; i < 3 * H; i += blockDim.x) sw1[i] = w1[i];
  for (int i = threadIdx.x; i < H; i += blockDim.x) sb1[i] = b1[i];

  float acc[kOut][H1];
  float count[kOut];
#pragma unroll
  for (int k = 0; k < kOut; ++k) {
    count[k] = 0.f;
#pragma unroll
    for (int h = 0; h < H1; ++h) acc[k][h] = 0.f;
  }
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
        const int j0 = m * kTm + half * kTJ;
        __syncthreads();  // the previous chunk's plane is consumed
        for (int i = threadIdx.x; i < kTJ; i += blockDim.x) {
          const float* p = P + 3 * (size_t)(j0 + i);
          spos[4 * i] = p[0];
          spos[4 * i + 1] = p[1];
          spos[4 * i + 2] = p[2];
          spos[4 * i + 3] = sq_norm_rn(p[0], p[1], p[2]);
          svld[i] = PV[j0 + i];
        }
        for (int i = threadIdx.x; i < kTJ * CB; i += blockDim.x) {
          const int j = i / CB, c = c0 + i % CB;
          sfeat[j * CB + i % CB] = c < C ? F[(size_t)(j0 + j) * C + c] : 0.f;
        }
        __syncthreads();
        for (int i = threadIdx.x; i < kTJ * kT; i += blockDim.x) {
          const int j = i / kT, s = i % kT;
          const float px = spos[4 * j], py = spos[4 * j + 1], pz = spos[4 * j + 2];
          const float qx = qpos[4 * s], qy = qpos[4 * s + 1], qz = qpos[4 * s + 2];
          const float d2 = pair_d2_rn(qx, qy, qz, qpos[4 * s + 3], px, py, pz, spos[4 * j + 3]);
          const bool in = qvld[s] && svld[j] && d2 <= r2;
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
              const float f = sfeat[j * CB + cl];
              const float* pl = plane + (size_t)j * H1 * kT + s;
#pragma unroll
              for (int h = 0; h < H1; ++h) acc[k][h] += pl[h * kT] * f;
              count[k] += pl[H * kT];
            }
          }
        }
      }
    }
  }
#pragma unroll
  for (int k = 0; k < kOut; ++k) {
    const int q = threadIdx.x + k * kThreads;
    if (q >= nout) continue;
    const int s = q / CB, cl = q % CB, c = c0 + cl;
    if (c >= C) continue;
    const size_t r = (size_t)b * NS + (size_t)t * kT + s;
    if (depthwise) {
      float o = 0.f;
#pragma unroll
      for (int h = 0; h < H; ++h) o += acc[k][h] * w2[h * C + c];
      o += acc[k][H] * b2[c];
      const float scale = qvld[s] ? (mean ? 1.f / fmaxf(count[k], 1.f) : 1.f) : 0.f;
      out[r * C + c] = o * scale;
    } else {
#pragma unroll
      for (int h = 0; h < H1; ++h) out[(r * H1 + h) * C + c] = acc[k][h];
    }
    if (c == 0) cnt[r] = count[k];
  }
}

}  // namespace

// out: (B, NS, C) when depthwise, else G (B, NS, H+1, C); cnt (B, NS).
extern "C" int tile_conv_launch(const void* smp, const void* svalid, const void* src,
                                const void* pvalid, const void* wf, const void* j_ids,
                                const void* run, const void* w1, const void* b1,
                                const void* w2, const void* b2, int B, int NS, int NP, int C,
                                int H, int S, int G, int n_tiles, int sentinel, float r2,
                                float radius, int mean, int depthwise, void* out, void* cnt,
                                void* stream) {
  if (H != 8 || C < 1 || G < 1 || G > kMaxG || NS != n_tiles * kT || NP < sentinel * kTm ||
      B < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const int CB = C < kMaxCB ? C : kMaxCB;
  const size_t smem = sizeof(float) * ((size_t)kTJ * (H + 1) * kT + kTJ * kMaxCB + kTJ * 4 +
                                       kT * 4 + 3 * H + H) +
                      sizeof(int) * kMaxG + kTJ + kT;
  cudaError_t err = cudaFuncSetAttribute(
      tile_conv_kernel<8>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid((C + CB - 1) / CB, n_tiles, B);
  tile_conv_kernel<8><<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(smp), static_cast<const uint8_t*>(svalid),
      static_cast<const float*>(src), static_cast<const uint8_t*>(pvalid),
      static_cast<const float*>(wf), static_cast<const int*>(j_ids),
      static_cast<const int*>(run), static_cast<const float*>(w1),
      static_cast<const float*>(b1), static_cast<const float*>(w2),
      static_cast<const float*>(b2), NS, NP, C, CB, S, G, n_tiles, sentinel, r2, radius, mean,
      depthwise, static_cast<float*>(out), static_cast<float*>(cnt));
  MCCNN_LAUNCH_RETURN();
}
