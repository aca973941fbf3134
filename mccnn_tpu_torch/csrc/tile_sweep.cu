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
// takes one (cloud, sample tile), one thread a sample; per step it stages the
// step's real candidate rows (up to G * Tm positions, |p|^2 and a validity /
// flag byte) in shared memory and every thread sweeps them in order. One
// writer per output and a fixed order: two calls are bit-identical. d2 is
// pair_d2_rn, the expression of every kernel and plain version of the port,
// so K8's counts equal its plain version's exactly.
//
// What bounds it on the H100: the candidate pairs (a d2, a compare and, for
// K7, an exp each); the bytes (positions in, one value out) are small.
// Limits: T == 128, G * Tm <= 2048.

#include "common.cuh"

namespace {

constexpr int kT = 128;
constexpr int kMaxRows = 2048;  // candidate rows a step: G * Tm

template <bool kCover, int TM>
__global__ void __launch_bounds__(kT)
tile_sweep_kernel(const float* __restrict__ pts, const uint8_t* __restrict__ valid,
                  const uint8_t* __restrict__ flags, const int* __restrict__ j_ids,
                  const int* __restrict__ run, int NR, int S, int G, int n_tiles,
                  int sentinel, float r2, float neg_half_inv_h2, float* __restrict__ dens,
                  int* __restrict__ cover) {
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
  const uint8_t* FL = kCover ? flags + (size_t)b * NR : nullptr;

  float acc = 0.f;
  int count = 0;
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
      cok[i] = V[j] && (!kCover || FL[j]);
    }
    __syncthreads();
    for (int i = 0; i < n * TM; ++i) {
      const float d2 = pair_d2_rn(qx, qy, qz, qsq, cx[i], cy[i], cz[i], csq[i]);
      if (cok[i] && d2 <= r2) {
        if (kCover)
          ++count;
        else
          acc += expf(fmaxf(d2, 0.f) * neg_half_inv_h2);
      }
    }
  }
  const bool qv = valid[row];
  if (kCover)
    cover[row] = qv ? count : 0;
  else
    dens[row] = qv ? acc : 0.f;
}

int check_shape(int B, int NR, int G, int Tm) {
  return (B < 1 || G < 1 || Tm < 8 || G * Tm > kMaxRows || NR < kT || NR % kT != 0) ? 1 : 0;
}

template <bool kCover, int TM>
int sweep_launch_tm(const void* pts, const void* valid, const void* flags, const void* j_ids,
                    const void* run, int B, int NR, int S, int G, int sentinel, float r2,
                    float neg_half_inv_h2, void* dens, void* cover, void* stream) {
  dim3 grid(NR / kT, B);
  tile_sweep_kernel<kCover, TM><<<grid, kT, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(pts), static_cast<const uint8_t*>(valid),
      static_cast<const uint8_t*>(flags), static_cast<const int*>(j_ids),
      static_cast<const int*>(run), NR, S, G, NR / kT, sentinel, r2, neg_half_inv_h2,
      static_cast<float*>(dens), static_cast<int*>(cover));
  MCCNN_LAUNCH_RETURN();
}

// Launches the instance built for Tm; any other Tm is refused.
template <bool kCover>
int sweep_dispatch(int Tm, const void* pts, const void* valid, const void* flags,
                   const void* j_ids, const void* run, int B, int NR, int S, int G,
                   int sentinel, float r2, float neg_half_inv_h2, void* dens, void* cover,
                   void* stream) {
  if (check_shape(B, NR, G, Tm)) return static_cast<int>(cudaErrorInvalidValue);
  switch (Tm) {
#define MCCNN_SWEEP_CASE(tm)                                                                  \
  case tm:                                                                                    \
    return sweep_launch_tm<kCover, tm>(pts, valid, flags, j_ids, run, B, NR, S, G, sentinel, \
                                       r2, neg_half_inv_h2, dens, cover, stream);
    MCCNN_SWEEP_CASE(8)
    MCCNN_SWEEP_CASE(16)
    MCCNN_SWEEP_CASE(32)
    MCCNN_SWEEP_CASE(64)
    MCCNN_SWEEP_CASE(128)
#undef MCCNN_SWEEP_CASE
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

extern "C" int tile_kde_launch(const void* pts, const void* valid, const void* j_ids,
                               const void* run, int B, int NR, int S, int G, int sentinel,
                               int Tm, float r2, float neg_half_inv_h2, void* out,
                               void* stream) {
  return sweep_dispatch<false>(Tm, pts, valid, nullptr, j_ids, run, B, NR, S, G, sentinel, r2,
                               neg_half_inv_h2, out, nullptr, stream);
}

extern "C" int tile_cover_launch(const void* pts, const void* valid, const void* flags,
                                 const void* j_ids, const void* run, int B, int NR, int S,
                                 int G, int sentinel, int Tm, float r2, void* out,
                                 void* stream) {
  return sweep_dispatch<true>(Tm, pts, valid, flags, j_ids, run, B, NR, S, G, sentinel, r2,
                              0.f, nullptr, out, stream);
}
