// K7 and K8: per-sample sums over the candidates of a Hilbert tile step list,
// one point set against itself.
//
// K7 replaces mccnn_tpu/ops/pallas/tile_conv.py::_kde_kernel (:1401, called at
// :1505 from tile_kde): the exact big-scene KDE,
//   dens[b, i] = sum_{valid j, d2(i,j) <= r2} exp(-0.5 d2 / h^2)
// (normalisation and the unsort stay in torch). K8 replaces _cover_kernel
// (:1553, called at :1633 from TileCoverSweep.counts): the cover count of the
// big-scene Poisson sampler,
//   cover[b, i] = #{valid j with flag[j], d2(i,j) <= r2},
// launched 27 times per sampler call, once per colour. Rows are in the
// sampler's or the curve's sorted order; the host's step list pairs each
// sample tile (T = 128 rows) with up to G candidate minors (Tm rows, Tm in
// {8, 16, 32, 64, 128}, a template parameter; the id n_minor marks none) in
// runs run[b, t] to run[b, t+1].
//
// The TPU kernels accumulate each sample tile across its consecutive grid
// steps, and fold the cover flag into a candidate's |p|^2 (a huge value
// pushes an unflagged candidate out of range). Here a block takes one
// (cloud, sample tile), 128 threads a group, one thread of each group a
// sample, and walks the tile's steps. One writer per output and a fixed
// order: two calls are bit-identical. d2 is pair_d2_rn, the expression of every kernel and plain
// version of the port, so K8's counts equal its plain version's exactly.
//
// Both walk only the real steps of their run: the step list is padded to
// its budget with inert all-sentinel steps, all in the last tile's run (588
// of the 40960 scene's 1032 steps at r = 0.05), which a walk step by step
// paid ~0.23 us each, in series (real_steps_end finds the first one). Both
// compact before any d2: they list the real minors of a pass of steps, take
// a ballot over the rows' predicate bytes and append the rows that pass to
// shared memory at a popc prefix, in row order, as float4 (x, y, z, |p|^2).
// K7 keeps the valid rows; K8 the flagged valid rows, and a colour flags at
// most one point of each of its cells: at ScanNet's block batch about 40 of
// a cloud's 8192 rows a launch. An integer count does not depend on the
// order, and stays the plain version's bit for bit.
//
// K7 then splits each round's kept rows over kKdeGroups groups of 128
// threads, one thread a sample in each, their partial sums added in group
// order: the terms are the TPU kernel's, the order of their sum is not (two
// calls are bit-identical; within 2.1e-6 of the one-group sum at the
// scene). One group alone leaves the real steps' sweep to ~10 warps an SM at
// the 40960 scene (320 blocks). Device times there (tools.dense_ab --sweeps,
// an H100 80GB HBM3 at 700 W), r = 0.05 / 0.1, 439 / 792 real steps of 1032:
//   the parent (every step walked, one group)   0.1425 / 0.2673 ms
//   1 group (real steps, valid rows)             0.0921 / 0.2293
//   2 groups                                     0.0626 / 0.1597
//   4 groups (kKdeGroups)                        0.0530 / 0.1220
//   8 groups                                     0.0536 / 0.1199
// 8 gain 1% over 4 with twice the threads, so 4; only 4 is built now (the
// parent's one-group bits come from the parent's library, dense_ab --sweeps).
//
// What bounds them on the H100: K7 the candidate pairs (a d2, a compare and
// an exp each; 56x its bound at the scene); K8 the step list's minor ids
// and flag bytes and its launches, the flagged pairs being few. The bytes (positions in, one value out) are
// small. Limits: T == 128, G * Tm <= 2048.

#include "common.cuh"

namespace {

constexpr int kT = 128;
constexpr int kMaxRows = 2048;  // candidate rows a step: G * Tm
constexpr int kKdeGroups = 4;   // K7's groups of kT threads a sample tile (see above)
constexpr unsigned kFull = 0xffffffffu;

// The end of a block's real steps in its run [k0, k1) of the step list: the
// first step whose slot 0 holds the sentinel, else k1. The host pads the
// list to its budget with inert all-sentinel steps, all in the last tile's
// run and after its real steps (ops/cuda/tile_conv.py::_chunked_pair_lists),
// and a real step's minors come first. Every thread calls it (two barriers).
__device__ __forceinline__ int real_steps_end(const int* __restrict__ J, int k0, int k1,
                                              int sentinel, int* kend) {
  if (threadIdx.x == 0) *kend = k1;
  __syncthreads();
  for (int k = k0 + threadIdx.x; k < k1; k += blockDim.x)
    if (J[k] == sentinel) atomicMin(kend, k);
  __syncthreads();
  return *kend;
}

// K7 (kKde) and K8 over the compacted candidate rows, kT * NG threads: NG
// groups of kT (kKdeGroups for K7, one for K8), group g's thread s on sample
// s. A block first finds where
// its run's real steps end. Then, a pass at a time, it lists the real minor
// ids of up to kEntries (step, slot) entries, and takes their rows in rounds
// of kMaxRows: every row's predicate bytes (validity, and K8's flag; all
// loads issued before any ballot), then the positions of the rows that
// pass. Each warp compacts a contiguous slice into its own region, so the
// lists are in entry and row order, the order of the TPU kernel's sum. A
// pass costs a few dependent loads however many steps it spans. Group g
// sweeps the g-th of NG equal slices of a round's kept rows, in order; the
// groups' partial sums are added in group order at the end.
template <int TM, bool kKde>
__global__ void __launch_bounds__(kT * (kKde ? kKdeGroups : 1))
tile_sweep_kernel(const float* __restrict__ pts, const uint8_t* __restrict__ valid,
                  const uint8_t* __restrict__ flags, const int* __restrict__ j_ids,
                  const int* __restrict__ run, int NR, int S, int G, int n_tiles,
                  int sentinel, float r2, float neg_half_inv_h2, float* __restrict__ dens,
                  int* __restrict__ cover) {
  constexpr int NG = kKde ? kKdeGroups : 1;
  constexpr int kWarps = kT * NG / 32;
  constexpr int kEntries = 1024;              // (step, slot) entries a pass
  constexpr int kEPer = kEntries / kWarps;    // a warp's entries of a pass
  constexpr int kRPer = kMaxRows / kWarps;    // a warp's rows of a round
  __shared__ float4 cand[kMaxRows];  // warp w's kept rows from cand[w * kRPer]
  __shared__ int mins[kEntries];     // warp w's real minor ids from mins[w * kEPer]
  __shared__ int nmin[kWarps + 1];   // prefix of the warps' minor counts
  __shared__ int ncand[kWarps];
  __shared__ int kend;
  __shared__ float part[NG][kT];     // the groups' partial sums (K7, NG > 1)

  const int t = blockIdx.x, b = blockIdx.y;
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  const int g = threadIdx.x / kT;  // this thread's group
  const size_t row = (size_t)b * NR + (size_t)t * kT + threadIdx.x % kT;
  const float qx = pts[3 * row], qy = pts[3 * row + 1], qz = pts[3 * row + 2];
  const float qsq = sq_norm_rn(qx, qy, qz);
  const float* P = pts + (size_t)b * NR * 3;
  const uint8_t* V = valid + (size_t)b * NR;
  const uint8_t* FL = kKde ? nullptr : flags + (size_t)b * NR;
  const int* J = j_ids + (size_t)b * G * S;

  const int k0 = run[(size_t)b * (n_tiles + 1) + t];
  const int k1 = run[(size_t)b * (n_tiles + 1) + t + 1];
  const int entries = (real_steps_end(J, k0, k1, sentinel, &kend) - k0) * G;
  // entry e: step k0 + e / G, slot e % G

  float acc = 0.f;  // K7
  int count = 0;    // K8
  for (int e0 = 0; e0 < entries; e0 += kEntries) {
    __syncthreads();  // the previous pass's lists are consumed
    int ids[kEPer / 32];
#pragma unroll
    for (int c = 0; c < kEPer / 32; ++c) {
      const int e = e0 + w * kEPer + 32 * c + lane;
      ids[c] = e < entries ? J[(size_t)(e % G) * S + k0 + e / G] : sentinel;
    }
    int nm = 0;
#pragma unroll
    for (int c = 0; c < kEPer / 32; ++c) {
      const unsigned bal = __ballot_sync(kFull, ids[c] != sentinel);
      if (ids[c] != sentinel) mins[w * kEPer + nm + __popc(bal & ((1u << lane) - 1u))] = ids[c];
      nm += __popc(bal);
    }
    if (lane == 0) nmin[w + 1] = nm;
    __syncthreads();
    if (threadIdx.x == 0) {
      nmin[0] = 0;
      for (int v = 0; v < kWarps; ++v) nmin[v + 1] += nmin[v];
    }
    __syncthreads();
    const int rows = nmin[kWarps] * TM;  // the pass's candidate rows, minor by minor
    for (int f0 = 0; f0 < rows; f0 += kMaxRows) {
      const int i_begin = f0 + w * kRPer, i_end = min(rows, i_begin + kRPer);
      int js[kRPer / 32];
      unsigned oks = 0;  // bit c: row i_begin + 32 c + lane is kept
#pragma unroll
      for (int c = 0; c < kRPer / 32; ++c) {
        const int i = i_begin + 32 * c + lane;
        js[c] = 0;
        if (i < i_end) {
          const int mi = i / TM;
          int v = 0;
#pragma unroll
          for (int u = 1; u < kWarps; ++u) v += mi >= nmin[u];
          js[c] = mins[v * kEPer + mi - nmin[v]] * TM + i % TM;
          if (kKde ? V[js[c]] : (FL[js[c]] & V[js[c]])) oks |= 1u << c;
        }
      }
      float4* mine = cand + w * kRPer;
      int n = 0;
#pragma unroll
      for (int c = 0; c < kRPer / 32; ++c) {
        const bool ok = (oks >> c) & 1u;
        const unsigned bal = __ballot_sync(kFull, ok);
        if (ok) {
          const int j = js[c];
          const float x = P[3 * j], y = P[3 * j + 1], z = P[3 * j + 2];
          mine[n + __popc(bal & ((1u << lane) - 1u))] = make_float4(x, y, z, sq_norm_rn(x, y, z));
        }
        n += __popc(bal);
      }
      if (lane == 0) ncand[w] = n;
      __syncthreads();
      // group g: the kept rows [lo, hi) of the round, warp region by region
      int kept = 0;
      for (int v = 0; v < kWarps; ++v) kept += ncand[v];
      const int lo = kept * g / NG, hi = kept * (g + 1) / NG;
      for (int v = 0, off = 0; v < kWarps && off < hi; off += ncand[v++]) {
        const float4* c = cand + v * kRPer;
        for (int k = max(lo - off, 0), e = min(hi - off, ncand[v]); k < e; ++k) {
          const float4 p = c[k];
          const float d2 = pair_d2_rn(qx, qy, qz, qsq, p.x, p.y, p.z, p.w);
          if constexpr (kKde) {
            if (d2 <= r2) acc += expf(fmaxf(d2, 0.f) * neg_half_inv_h2);
          } else {
            count += d2 <= r2;
          }
        }
      }
      __syncthreads();  // the round's rows are consumed
    }
  }
  if constexpr (kKde) {
    if constexpr (NG > 1) {  // group 0 adds the others' partials in group order
      part[g][threadIdx.x % kT] = acc;
      __syncthreads();
      if (g > 0) return;
      for (int u = 1; u < NG; ++u) acc += part[u][threadIdx.x];
    }
    dens[row] = valid[row] ? acc : 0.f;
  } else {
    cover[row] = valid[row] ? count : 0;
  }
}

int check_shape(int B, int NR, int G, int Tm) {
  return (B < 1 || G < 1 || Tm < 8 || G * Tm > kMaxRows || NR < kT || NR % kT != 0) ? 1 : 0;
}

template <int TM>
int kde_launch_tm(const void* pts, const void* valid, const void* j_ids, const void* run, int B,
                  int NR, int S, int G, int sentinel, float r2, float neg_half_inv_h2, void* dens,
                  void* stream) {
  dim3 grid(NR / kT, B);
  tile_sweep_kernel<TM, true><<<grid, kT * kKdeGroups, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(pts), static_cast<const uint8_t*>(valid), nullptr,
      static_cast<const int*>(j_ids), static_cast<const int*>(run), NR, S, G, NR / kT,
      sentinel, r2, neg_half_inv_h2, static_cast<float*>(dens), nullptr);
  MCCNN_LAUNCH_RETURN();
}

template <int TM>
int cover_launch_tm(const void* pts, const void* valid, const void* flags, const void* j_ids,
                    const void* run, int B, int NR, int S, int G, int sentinel, float r2,
                    void* cover, void* stream) {
  dim3 grid(NR / kT, B);
  tile_sweep_kernel<TM, false><<<grid, kT, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(pts), static_cast<const uint8_t*>(valid),
      static_cast<const uint8_t*>(flags), static_cast<const int*>(j_ids),
      static_cast<const int*>(run), NR, S, G, NR / kT, sentinel, r2, 0.f, nullptr,
      static_cast<int*>(cover));
  MCCNN_LAUNCH_RETURN();
}

}  // namespace

// K7 and K8: each launches the instance built for Tm; any other Tm is
// refused.
extern "C" int tile_kde_launch(const void* pts, const void* valid, const void* j_ids,
                               const void* run, int B, int NR, int S, int G, int sentinel,
                               int Tm, float r2, float neg_half_inv_h2, void* out,
                               void* stream) {
  if (check_shape(B, NR, G, Tm)) return static_cast<int>(cudaErrorInvalidValue);
  switch (Tm) {
#define MCCNN_KDE_CASE(tm) \
  case tm:                 \
    return kde_launch_tm<tm>(pts, valid, j_ids, run, B, NR, S, G, sentinel, r2, neg_half_inv_h2, \
                             out, stream);
    MCCNN_KDE_CASE(8)
    MCCNN_KDE_CASE(16)
    MCCNN_KDE_CASE(32)
    MCCNN_KDE_CASE(64)
    MCCNN_KDE_CASE(128)
#undef MCCNN_KDE_CASE
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

extern "C" int tile_cover_launch(const void* pts, const void* valid, const void* flags,
                                 const void* j_ids, const void* run, int B, int NR, int S,
                                 int G, int sentinel, int Tm, float r2, void* out,
                                 void* stream) {
  if (check_shape(B, NR, G, Tm)) return static_cast<int>(cudaErrorInvalidValue);
  switch (Tm) {
#define MCCNN_COVER_CASE(tm) \
  case tm:                   \
    return cover_launch_tm<tm>(pts, valid, flags, j_ids, run, B, NR, S, G, sentinel, r2, out, \
                               stream);
    MCCNN_COVER_CASE(8)
    MCCNN_COVER_CASE(16)
    MCCNN_COVER_CASE(32)
    MCCNN_COVER_CASE(64)
    MCCNN_COVER_CASE(128)
#undef MCCNN_COVER_CASE
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
