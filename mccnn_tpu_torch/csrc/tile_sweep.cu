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
// pushes an unflagged candidate out of range). Here a block of 128 threads
// takes one (cloud, sample tile), one thread a sample, and walks the tile's
// steps. One writer per output and a fixed order: two calls are
// bit-identical. d2 is pair_d2_rn, the expression of every kernel and plain
// version of the port, so K8's counts equal its plain version's exactly.
//
// K7 stages each step's real candidate rows (up to G * Tm positions, |p|^2
// and a validity byte) in shared memory and every thread sweeps them in
// order: a d2, a compare and an exp a candidate pair, its sum in row order.
//
// K8 counts only flagged candidates, and a colour flags at most one point of
// each of its cells: at ScanNet's block batch about 40 of a cloud's 8192 rows
// a launch. So it compacts before any d2: it lists the real minors of its
// run, stopping at the step list's inert padding, then takes a ballot over
// the rows' flag and validity bytes and appends the flagged valid rows to
// shared memory at a popc prefix, in row order, as float4 (x, y, z, |p|^2).
// Only those get a d2. An integer count does not depend on the order, and
// stays the plain version's bit for bit.
//
// What bounds them on the H100: K7 the candidate pairs (a d2, a compare and
// an exp each); K8 the step list's minor ids and flag bytes and its launches,
// the flagged pairs being few. The bytes (positions in, one value out) are
// small. Limits: T == 128, G * Tm <= 2048.

#include "common.cuh"

namespace {

constexpr int kT = 128;
constexpr int kMaxRows = 2048;  // candidate rows a step: G * Tm
constexpr int kWarps = kT / 32;
constexpr unsigned kFull = 0xffffffffu;

// K7: the Gaussian sum over every valid candidate within the radius.
template <int TM>
__global__ void __launch_bounds__(kT)
tile_kde_kernel(const float* __restrict__ pts, const uint8_t* __restrict__ valid,
                const int* __restrict__ j_ids, const int* __restrict__ run, int NR, int S,
                int G, int n_tiles, int sentinel, float r2, float neg_half_inv_h2,
                float* __restrict__ dens) {
  __shared__ float cx[kMaxRows], cy[kMaxRows], cz[kMaxRows], csq[kMaxRows];
  __shared__ uint8_t cok[kMaxRows];
  __shared__ int sj[kMaxRows / TM];

  const int t = blockIdx.x, b = blockIdx.y;
  const int s = threadIdx.x;
  const size_t row = (size_t)b * NR + (size_t)t * kT + s;
  const float qx = pts[3 * row], qy = pts[3 * row + 1], qz = pts[3 * row + 2];
  const float qsq = sq_norm_rn(qx, qy, qz);
  const float* P = pts + (size_t)b * NR * 3;
  const uint8_t* V = valid + (size_t)b * NR;

  float acc = 0.f;
  const int k0 = run[(size_t)b * (n_tiles + 1) + t];
  const int k1 = run[(size_t)b * (n_tiles + 1) + t + 1];
  for (int step = k0; step < k1; ++step) {
    __syncthreads();  // the previous step's candidates are consumed
    for (int g = threadIdx.x; g < G; g += blockDim.x)
      sj[g] = j_ids[((size_t)b * G + g) * S + step];
    __syncthreads();
    int n = 0;  // a step's real minors come first
    while (n < G && sj[n] != sentinel) ++n;
    for (int i = threadIdx.x; i < n * TM; i += blockDim.x) {
      const int j = sj[i / TM] * TM + i % TM;
      const float x = P[3 * j], y = P[3 * j + 1], z = P[3 * j + 2];
      cx[i] = x;
      cy[i] = y;
      cz[i] = z;
      csq[i] = sq_norm_rn(x, y, z);
      cok[i] = V[j];
    }
    __syncthreads();
    for (int i = 0; i < n * TM; ++i) {
      const float d2 = pair_d2_rn(qx, qy, qz, qsq, cx[i], cy[i], cz[i], csq[i]);
      if (cok[i] && d2 <= r2) acc += expf(fmaxf(d2, 0.f) * neg_half_inv_h2);
    }
  }
  dens[row] = valid[row] ? acc : 0.f;
}

// K8: the count of flagged valid candidates within the radius, over the
// compacted flagged rows only. A block first finds where its run's real
// steps end (the host pads the step list with inert all-sentinel steps, all
// in the last tile's run). Then, a pass at a time, it lists the real minor
// ids of up to kEntries (step, slot) entries, and takes their rows in rounds
// of kMaxRows: every row's flag and validity bytes (all loads issued before
// any ballot), then the flagged valid rows' positions. Each warp compacts a
// contiguous slice into its own region, so the lists are in entry and row
// order. A pass costs a few dependent loads however many steps it spans.
template <int TM>
__global__ void __launch_bounds__(kT)
tile_cover_kernel(const float* __restrict__ pts, const uint8_t* __restrict__ valid,
                  const uint8_t* __restrict__ flags, const int* __restrict__ j_ids,
                  const int* __restrict__ run, int NR, int S, int G, int n_tiles,
                  int sentinel, float r2, int* __restrict__ cover) {
  constexpr int kEntries = 1024;              // (step, slot) entries a pass
  constexpr int kEPer = kEntries / kWarps;    // a warp's entries of a pass
  constexpr int kRPer = kMaxRows / kWarps;    // a warp's rows of a round
  __shared__ float4 cand[kMaxRows];  // warp w's flagged rows from cand[w * kRPer]
  __shared__ int mins[kEntries];     // warp w's real minor ids from mins[w * kEPer]
  __shared__ int nmin[kWarps + 1];   // prefix of the warps' minor counts
  __shared__ int ncand[kWarps];
  __shared__ int kend;

  const int t = blockIdx.x, b = blockIdx.y;
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  const size_t row = (size_t)b * NR + (size_t)t * kT + threadIdx.x;
  const float qx = pts[3 * row], qy = pts[3 * row + 1], qz = pts[3 * row + 2];
  const float qsq = sq_norm_rn(qx, qy, qz);
  const float* P = pts + (size_t)b * NR * 3;
  const uint8_t* V = valid + (size_t)b * NR;
  const uint8_t* FL = flags + (size_t)b * NR;
  const int* J = j_ids + (size_t)b * G * S;

  const int k0 = run[(size_t)b * (n_tiles + 1) + t];
  const int k1 = run[(size_t)b * (n_tiles + 1) + t + 1];
  if (threadIdx.x == 0) kend = k1;
  __syncthreads();
  for (int k = k0 + threadIdx.x; k < k1; k += kT)  // a step's real minors come first
    if (J[k] == sentinel) atomicMin(&kend, k);
  __syncthreads();
  const int entries = (kend - k0) * G;  // entry e: step k0 + e / G, slot e % G

  int count = 0;
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
      unsigned oks = 0;  // bit c: row i_begin + 32 c + lane is flagged and valid
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
          if (FL[js[c]] & V[js[c]]) oks |= 1u << c;
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
      for (int v = 0; v < kWarps; ++v) {
        const float4* c = cand + v * kRPer;
        for (int k = 0; k < ncand[v]; ++k) {
          const float4 p = c[k];
          count += pair_d2_rn(qx, qy, qz, qsq, p.x, p.y, p.z, p.w) <= r2;
        }
      }
      __syncthreads();  // the round's rows are consumed
    }
  }
  cover[row] = valid[row] ? count : 0;
}

int check_shape(int B, int NR, int G, int Tm) {
  return (B < 1 || G < 1 || Tm < 8 || G * Tm > kMaxRows || NR < kT || NR % kT != 0) ? 1 : 0;
}

template <int TM>
int kde_launch_tm(const void* pts, const void* valid, const void* j_ids, const void* run, int B,
                  int NR, int S, int G, int sentinel, float r2, float neg_half_inv_h2, void* dens,
                  void* stream) {
  dim3 grid(NR / kT, B);
  tile_kde_kernel<TM><<<grid, kT, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(pts), static_cast<const uint8_t*>(valid),
      static_cast<const int*>(j_ids), static_cast<const int*>(run), NR, S, G, NR / kT,
      sentinel, r2, neg_half_inv_h2, static_cast<float*>(dens));
  MCCNN_LAUNCH_RETURN();
}

template <int TM>
int cover_launch_tm(const void* pts, const void* valid, const void* flags, const void* j_ids,
                    const void* run, int B, int NR, int S, int G, int sentinel, float r2,
                    void* cover, void* stream) {
  dim3 grid(NR / kT, B);
  tile_cover_kernel<TM><<<grid, kT, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(pts), static_cast<const uint8_t*>(valid),
      static_cast<const uint8_t*>(flags), static_cast<const int*>(j_ids),
      static_cast<const int*>(run), NR, S, G, NR / kT, sentinel, r2,
      static_cast<int*>(cover));
  MCCNN_LAUNCH_RETURN();
}

}  // namespace

// Each launches the instance built for Tm; any other Tm is refused.
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
