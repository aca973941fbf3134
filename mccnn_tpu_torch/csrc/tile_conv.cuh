// K5 and K5p: the Monte-Carlo convolution over Hilbert tile pairs, forward.
//
// Replace mccnn_tpu/ops/pallas/tile_conv.py::_fwd_kernel (:525, called at
// :982 through _fwd_call from tile_mc_conv), K5p its packed-record mode
// (spec.pack, :553-557, records from _pack_minor :487, chosen at :1354-1368
// by MCCNN_TILE_PACK=1). Samples and sources are sorted along a Hilbert (or,
// under MCCNN_TILE_ORDER=morton, Morton) curve; the host builds a chunked step
// list in which step k of cloud b pairs the sample tile i_ids[b, k] (T = 128
// sorted samples; the list is non-decreasing in it) with up to G candidate
// minor tiles j_ids[b, :, k] (Tm sorted sources each, Tm in {8, 16, 32, 64,
// 128}, a template parameter; the id n_minor marks none). For every sample i
// of the tile and every valid source j of those minors with d2(i, j) <= r2:
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
// design: per chunk of min(Tm, 16) sources the block stages positions and the
// CB-channel slice of f~, fills the (chunk, H+1, 128) a_h plane with the
// exact expressions of K1 (pair_d2_rn, mc_offset, mc_preact in common.cuh, so
// a tile site and a dense site agree bit for bit on a_h), and each thread
// accumulates up to 8 (sample, channel) outputs for all H+1 rows in
// registers. The sums run over the sources in list order whatever the chunk,
// so K5 gives one result at every Tm for one step list.
//
// K5p reads each candidate minor from one contiguous record (the TPU kernel's
// single DMA a minor instead of two): Tm rows of (x, y, z, validity) and then
// the minor's Tm x C payload f~, fp32 (the TPU record bit-casts bf16). It
// stages the same values as K5 and sums in the same order, so the two are
// bit-equal.
//
// Invalid rows are masked by their flags (the TPU kernel parks them at a far
// sentinel coordinate, whose expanded d2 against another sentinel cancels to
// ~0). Everything is fp32 (the TPU kernel holds features in bf16). Limits:
// H == 8, T == 128, G * Tm <= 2048. The source rows may run past the last
// minor (the layout keeps them in the major tiling the backward, K6, reads).
//
// The probes (template parameter kProbe; tile_conv_probe.cu and
// tile_conv_packed_probe.cu build them) replace the roofline probes of the
// TPU kernel's forward (spec.probe, :575-608, MCCNN_TILE_PROBE), which strip
// K5 to its parts for tools/exp_tile_roofline.py. Each walks the same steps,
// stages the same chunks (positions, flags and the f~ slice) and forms d2 and
// the count, then keeps one part:
//   kProbeNoop:   nothing more; it writes 0 (0 x the f~ it staged, so the
//                 loads stay) as the sample's value;
//   kProbePlanes: the H pre-activation planes in the factored form
//                 (cw_h(j) - sw_h(i)) + b1_h (mc_w1_proj, as the TPU probe
//                 forms them, :578-591), ReLU'd and masked, summed over h
//                 into one plane and over the step's sources into the
//                 sample's value (the TPU probe's sum of a_h, no matmul);
//   kProbeMm:     the raw d2 of every valid pair as each of the H planes (the
//                 mask as the last) and K5's whole contraction and epilogue
//                 (the TPU probe's d2 fed to the 9 feature matmuls, :595-607).
// noop and planes write the value to out (B, NS), the same for every channel
// (the wrapper broadcasts and scales it); mm writes what K5 writes. Every
// probe writes K5's count.
#pragma once

#include "common.cuh"

namespace {
namespace k5 {

constexpr int kT = 128;       // samples per tile
constexpr int kThreads = 256;
constexpr int kOut = 8;       // (sample, channel) outputs per thread
constexpr int kMaxCB = kThreads * kOut / kT;  // 16 channels per block
constexpr int kMaxRows = 2048;  // candidate rows a step: G * Tm
constexpr int kProbeNone = 0, kProbeNoop = 1, kProbePlanes = 2, kProbeMm = 3;

struct TileConvArgs {
  const float* smp;       // (B, NS, 3) sorted samples
  const uint8_t* svalid;  // (B, NS)
  const float* src;       // (B, NP, 3) sorted sources (K5)
  const uint8_t* pvalid;  // (B, NP) (K5)
  const float* wf;        // (B, NP, C) f~ (K5)
  const float* rec;       // (B, n_minor, Tm * (4 + C)) packed source minors (K5p)
  const int* j_ids;       // (B, G, S)
  const int* run;         // (B, n_tiles + 1)
  const float* w1;        // (3, H)
  const float* b1;        // (H,)
  const float* w2;        // (H, C) depthwise
  const float* b2;        // (C,) depthwise
  int NS, NP, C, CB, S, G, n_tiles, sentinel;
  float r2, radius;
  int mean, depthwise;
  float* out;  // (B, NS, C) depthwise, else G (B, NS, H+1, C); a noop or planes probe's (B, NS)
  float* cnt;  // (B, NS)
};

template <int TM, int kProbe>
size_t tile_conv_smem(int H) {
  constexpr int kTJ = TM < 16 ? TM : 16;
  const size_t proj = kProbe == kProbePlanes ? (size_t)(kT + kTJ) * H : 0;  // sw, cw
  return sizeof(float) * ((size_t)kTJ * (H + 1) * kT + kTJ * kMaxCB + kTJ * 4 + kT * 4 + 3 * H +
                          H + proj) +
         sizeof(int) * (kMaxRows / TM) + kTJ + kT;
}

template <int H, int TM, bool kPacked, int kProbe>
__global__ void __launch_bounds__(kThreads) tile_conv_kernel(const TileConvArgs a) {
  constexpr int H1 = H + 1;
  constexpr int kTJ = TM < 16 ? TM : 16;  // sources per shared-memory chunk
  extern __shared__ float sm[];
  float* plane = sm;                      // [kTJ][H1][kT]
  float* sfeat = plane + kTJ * H1 * kT;   // [kTJ][CB]
  float* spos = sfeat + kTJ * kMaxCB;     // [kTJ][4]: x, y, z, |p|^2
  float* qpos = spos + kTJ * 4;           // [kT][4]
  float* sw1 = qpos + kT * 4;             // [3][H]
  float* sb1 = sw1 + 3 * H;               // [H]
  int* sj = reinterpret_cast<int*>(sb1 + H);                       // [kMaxRows / TM]
  uint8_t* svld = reinterpret_cast<uint8_t*>(sj + kMaxRows / TM);  // [kTJ]
  uint8_t* qvld = svld + kTJ;                                      // [kT]
  float* sproj = reinterpret_cast<float*>(qvld + kT);  // planes probe: [kT][H] sw, [kTJ][H] cw
  float* cproj = sproj + kT * H;

  const int C = a.C, CB = a.CB, G = a.G;
  const int cb = blockIdx.x, t = blockIdx.y, b = blockIdx.z;
  const int c0 = cb * CB;

  for (int s = threadIdx.x; s < kT; s += blockDim.x) {
    const size_t row = (size_t)b * a.NS + (size_t)t * kT + s;
    const float x = a.smp[3 * row], y = a.smp[3 * row + 1], z = a.smp[3 * row + 2];
    qpos[4 * s] = x;
    qpos[4 * s + 1] = y;
    qpos[4 * s + 2] = z;
    qpos[4 * s + 3] = sq_norm_rn(x, y, z);
    qvld[s] = a.svalid[row];
  }
  for (int i = threadIdx.x; i < 3 * H; i += blockDim.x) sw1[i] = a.w1[i];
  for (int i = threadIdx.x; i < H; i += blockDim.x) sb1[i] = a.b1[i];
  if constexpr (kProbe == kProbePlanes) {
    __syncthreads();
    for (int i = threadIdx.x; i < kT * H; i += blockDim.x) {
      const int s = i / H, h = i % H;
      sproj[i] = mc_w1_proj(qpos[4 * s], qpos[4 * s + 1], qpos[4 * s + 2], sw1, H, h, a.radius);
    }
  }

  float acc[kOut][H1];
  float count[kOut];
#pragma unroll
  for (int k = 0; k < kOut; ++k) {
    count[k] = 0.f;
#pragma unroll
    for (int h = 0; h < H1; ++h) acc[k][h] = 0.f;
  }
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
        // this chunk's positions (stride 4 packed, 3 not) and f~ rows (stride C)
        const float* pos;
        const float* feat;
        const uint8_t* vld = nullptr;
        if constexpr (kPacked) {
          const float* R = a.rec + ((size_t)b * a.sentinel + m) * ((size_t)TM * (4 + C));
          pos = R + 4 * r0;
          feat = R + 4 * TM + (size_t)r0 * C;
        } else {
          const size_t j0 = (size_t)b * a.NP + (size_t)m * TM + r0;
          pos = a.src + 3 * j0;
          feat = a.wf + j0 * C;
          vld = a.pvalid + j0;
        }
        constexpr int ps = kPacked ? 4 : 3;
        __syncthreads();  // the previous chunk's plane is consumed
        for (int i = threadIdx.x; i < kTJ; i += blockDim.x) {
          const float* p = pos + ps * i;
          spos[4 * i] = p[0];
          spos[4 * i + 1] = p[1];
          spos[4 * i + 2] = p[2];
          spos[4 * i + 3] = sq_norm_rn(p[0], p[1], p[2]);
          if constexpr (kPacked)
            svld[i] = p[3] != 0.f;
          else
            svld[i] = vld[i];
          if constexpr (kProbe == kProbePlanes)
            for (int h = 0; h < H; ++h)
              cproj[i * H + h] = mc_w1_proj(p[0], p[1], p[2], a.w1, H, h, a.radius);
        }
        for (int i = threadIdx.x; i < kTJ * CB; i += blockDim.x) {
          const int j = i / CB, c = c0 + i % CB;
          sfeat[j * CB + i % CB] = c < C ? feat[(size_t)j * C + c] : 0.f;
        }
        __syncthreads();
        for (int i = threadIdx.x; i < kTJ * kT; i += blockDim.x) {
          const int j = i / kT, s = i % kT;
          const float px = spos[4 * j], py = spos[4 * j + 1], pz = spos[4 * j + 2];
          const float qx = qpos[4 * s], qy = qpos[4 * s + 1], qz = qpos[4 * s + 2];
          const float d2 = pair_d2_rn(qx, qy, qz, qpos[4 * s + 3], px, py, pz, spos[4 * j + 3]);
          const bool in = qvld[s] && svld[j] && d2 <= a.r2;
          float* pl = plane + (size_t)j * H1 * kT + s;
          if constexpr (kProbe == kProbeNone) {
            const float ox = mc_offset(px, qx, a.radius), oy = mc_offset(py, qy, a.radius),
                        oz = mc_offset(pz, qz, a.radius);
#pragma unroll
            for (int h = 0; h < H; ++h) {
              const float pre = mc_preact(ox, oy, oz, sw1, sb1, H, h);
              pl[h * kT] = in ? fmaxf(pre, 0.f) : 0.f;
            }
          } else if constexpr (kProbe == kProbePlanes) {
            float sum = 0.f;
#pragma unroll
            for (int h = 0; h < H; ++h) {
              const float pre = __fadd_rn(__fsub_rn(cproj[j * H + h], sproj[s * H + h]), sb1[h]);
              sum += in ? fmaxf(pre, 0.f) : 0.f;
            }
            pl[0] = sum;
          } else if constexpr (kProbe == kProbeMm) {
            const float v = qvld[s] && svld[j] ? d2 : 0.f;
#pragma unroll
            for (int h = 0; h < H; ++h) pl[h * kT] = v;
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
              if constexpr (kProbe == kProbeNoop) {
                acc[k][0] += f;  // the staged f~ stays read
              } else if constexpr (kProbe == kProbePlanes) {
                acc[k][0] += pl[0];
              } else {
#pragma unroll
                for (int h = 0; h < H1; ++h) acc[k][h] += pl[h * kT] * f;
              }
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
    const size_t r = (size_t)b * a.NS + (size_t)t * kT + s;
    if constexpr (kProbe == kProbeNoop || kProbe == kProbePlanes) {
      // one value a sample: 0 x the staged f~ (noop), the plane sum (planes)
      if (c == 0) {
        a.out[r] = kProbe == kProbeNoop ? 0.f * acc[k][0] : acc[k][0];
        a.cnt[r] = count[k];
      }
      continue;
    }
    if (a.depthwise) {
      float o = 0.f;
#pragma unroll
      for (int h = 0; h < H; ++h) o += acc[k][h] * a.w2[h * C + c];
      o += acc[k][H] * a.b2[c];
      const float scale = qvld[s] ? (a.mean ? 1.f / fmaxf(count[k], 1.f) : 1.f) : 0.f;
      a.out[r * C + c] = o * scale;
    } else {
#pragma unroll
      for (int h = 0; h < H1; ++h) a.out[(r * H1 + h) * C + c] = acc[k][h];
    }
    if (c == 0) a.cnt[r] = count[k];
  }
}

template <int TM, bool kPacked, int kProbe>
int tile_conv_launch_tm(const TileConvArgs& a, int B, cudaStream_t stream) {
  const size_t smem = tile_conv_smem<TM, kProbe>(8);
  cudaError_t err = cudaFuncSetAttribute(tile_conv_kernel<8, TM, kPacked, kProbe>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid((a.C + a.CB - 1) / a.CB, a.n_tiles, B);
  tile_conv_kernel<8, TM, kPacked, kProbe><<<grid, kThreads, smem, stream>>>(a);
  MCCNN_LAUNCH_RETURN();
}

// Checks the shapes and launches the instance built for Tm (8, 16, 32, 64 or
// 128); any other Tm, or a shape the kernel does not take, is refused.
template <bool kPacked, int kProbe = kProbeNone>
int tile_conv_dispatch(TileConvArgs a, int B, int H, int Tm, cudaStream_t stream) {
  if (H != 8 || a.C < 1 || a.G < 1 || Tm < 8 || (size_t)a.G * Tm > kMaxRows ||
      a.NS != a.n_tiles * kT || B < 1 || (!kPacked && a.NP < a.sentinel * Tm))
    return static_cast<int>(cudaErrorInvalidValue);
  a.CB = a.C < kMaxCB ? a.C : kMaxCB;
  switch (Tm) {
    case 8: return tile_conv_launch_tm<8, kPacked, kProbe>(a, B, stream);
    case 16: return tile_conv_launch_tm<16, kPacked, kProbe>(a, B, stream);
    case 32: return tile_conv_launch_tm<32, kPacked, kProbe>(a, B, stream);
    case 64: return tile_conv_launch_tm<64, kPacked, kProbe>(a, B, stream);
    case 128: return tile_conv_launch_tm<128, kPacked, kProbe>(a, B, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// The probe instances: kProbe picked at run time (1 noop, 2 planes, 3 mm).
template <bool kPacked>
int tile_conv_probe_dispatch(const TileConvArgs& a, int B, int H, int Tm, int probe,
                             cudaStream_t stream) {
  switch (probe) {
    case kProbeNoop: return tile_conv_dispatch<kPacked, kProbeNoop>(a, B, H, Tm, stream);
    case kProbePlanes: return tile_conv_dispatch<kPacked, kProbePlanes>(a, B, H, Tm, stream);
    case kProbeMm: return tile_conv_dispatch<kPacked, kProbeMm>(a, B, H, Tm, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace k5
}  // namespace
