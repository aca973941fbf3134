// K4: dense Gaussian KDE of each point within its own point set.
//
// Replaces mccnn_tpu/ops/pallas/density_kernel.py::_kde_kernel (reached
// through kde_density_pallas from core/pdf.py::kde_density).
//
//   density[b, i] = norm * sum_{valid j, d2(i,j) <= r2} exp(-0.5 * d2 / h^2)
//   norm = 1 / (h^3 (2 pi)^1.5),   masked queries get 1.0.
//
// The TPU kernel sums over every pair, because VMEM holds the whole cloud.
// Only in-radius pairs feed the sum, and at ScanNet's level 0 (8192 points,
// r = 0.05 and 0.1) a point has about 20 and 80 of its 8192 sources in
// radius. Two bodies:
//
// * all pairs (`kde_density_launch`): one thread per query, source positions
//   (and |p|^2) staged through shared memory in tiles of the block size; the
//   sum runs in source order. B*N^2 d2 tests.
// * culled (`kde_density_culled_launch`, up to 8192 points a cloud): one
//   block a cloud reduces the valid points' box, gives each point the 7-bit
//   3-D Hilbert index of its cell in that box (masked points last), sorts
//   the cloud by it in shared memory (a stable LSD radix sort, the same
//   order on every call), and writes the sorted rows as float4 (x, y, z,
//   |p|^2) with one box (and largest |p|^2) per group of 32 sources. Then
//   one warp takes 32 sorted queries: it reduces their box, tests 32 group
//   boxes with one ballot, lists the groups that lie within r of it, and
//   sweeps only those, one staged group of 32 at a time. The sum runs over
//   the kept groups in sorted order, fixed for given points, so two calls
//   give identical bits; each result goes to its query's original row.
//
// The cull keeps a group where the squared box distance is at most
// r2 + 1e-6 (|q|^2max + |p|^2max + r2): pair_d2_rn's rounding of
// (|q|^2 + |p|^2) - 2 q.p stays below 7 * 2^-24 (|q|^2 + |p|^2), so no pair
// whose d2 passes `d2 <= r2` lies in a culled group, and the in-radius set is
// the plain version's. Only the order of the fp32 sum differs from it.
//
// Which body (ops/cuda/density_kernel.py::pick_body, by shape): the culled
// one for 1024 <= N <= 8192 points a cloud, else all pairs. Device times of
// one call, culled against all pairs (ms, `python -m
// mccnn_tpu_torch.tools.dense_ab --sweeps`, an H100 80GB HBM3 at 700 W):
//   N = 8192, B = 8 (r = 0.05 / 0.1)       0.1120 / 0.1373 against 0.4115 / 0.4624
//   N = 1944, B = 8 (r = 0.1 / 0.3)        0.0526 / 0.0810 against 0.0798 / 0.1164
//   N = 1024, B = 8 / 32 (r = 0.2)         0.0599 / 0.0652 against 0.0742 / 0.0746
//   N = 496,  B = 8 / 32 (r = 0.8)         0.0320 / 0.0327 against 0.0303 / 0.0305
//   N = 224,  B = 8 (r = 0.3 / 0.8)        0.0227 / 0.0245 against 0.0149 / 0.0153
//   N = 40,   B = 8 / 32 (r = 0.8 - 1.83)  0.0158 - 0.0163 against 0.0045 - 0.0051
// Below about 1000 points the layout block's fixed cost (the sort's passes)
// outweighs the pairs it saves.
//
// What bounds it on the H100: the pairs it tests (a d2, a compare, and an
// exp where in radius); the bytes (positions in, one float out) are
// negligible.

#include "block_sort.cuh"
#include "common.cuh"

namespace {

constexpr int kKdeBlock = 256;
constexpr unsigned kFull = 0xffffffffu;

__global__ void kde_density_kernel(const float* __restrict__ pts,
                                   const uint8_t* __restrict__ mask, int N,
                                   float r2, float neg_half_inv_h2, float norm,
                                   float* __restrict__ out) {
  __shared__ float sx[kKdeBlock], sy[kKdeBlock], sz[kKdeBlock], ssq[kKdeBlock];
  __shared__ uint8_t sv[kKdeBlock];

  const int b = blockIdx.y;
  const int i = blockIdx.x * kKdeBlock + threadIdx.x;
  const float* P = pts + (size_t)b * N * 3;
  const uint8_t* V = mask + (size_t)b * N;

  float qx = 0.f, qy = 0.f, qz = 0.f, qsq = 0.f;
  if (i < N) {
    qx = P[3 * i];
    qy = P[3 * i + 1];
    qz = P[3 * i + 2];
    qsq = sq_norm_rn(qx, qy, qz);
  }
  float acc = 0.f;
  for (int j0 = 0; j0 < N; j0 += kKdeBlock) {
    const int j = j0 + threadIdx.x;
    if (j < N) {
      float x = P[3 * j], y = P[3 * j + 1], z = P[3 * j + 2];
      sx[threadIdx.x] = x;
      sy[threadIdx.x] = y;
      sz[threadIdx.x] = z;
      ssq[threadIdx.x] = sq_norm_rn(x, y, z);
      sv[threadIdx.x] = V[j];
    }
    __syncthreads();
    const int nj = min(kKdeBlock, N - j0);
    for (int t = 0; t < nj; ++t) {
      float d2 = pair_d2_rn(qx, qy, qz, qsq, sx[t], sy[t], sz[t], ssq[t]);
      d2 = fmaxf(d2, 0.f);
      if (sv[t] && d2 <= r2) acc += expf(d2 * neg_half_inv_h2);
    }
    __syncthreads();
  }
  if (i < N) out[(size_t)b * N + i] = V[i] ? norm * acc : 1.0f;
}

// ---------------------------------------------------------------- culled body

constexpr int kSortThreads = 1024;
constexpr int kSortWarps = kSortThreads / 32;
constexpr int kMaxCulledN = 8192;              // points a cloud the layout block sorts
constexpr int kHilbertBits = 7;                // 128 cells an axis over the cloud's box
constexpr unsigned kMaskedKey = 1u << (3 * kHilbertBits);  // after every cell
constexpr int kPasses = 3;                     // 8 + 8 + 6 key bits
constexpr int kWarps = 4;                      // warps a block of the sweep
constexpr int kWindow = 256;                   // groups culled into one list
constexpr size_t kLayoutSmem = 2 * kMaxCulledN * (sizeof(unsigned) + sizeof(unsigned short)) +
                               block_sort::counter_ints(kSortThreads) * sizeof(int);

__device__ __forceinline__ float warp_min(float v) {
  for (int o = 16; o > 0; o >>= 1) v = fminf(v, __shfl_xor_sync(kFull, v, o));
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(kFull, v, o));
  return v;
}

// Skilling's transform: the 3-D Hilbert index of cell (x0, x1, x2), each in
// [0, 2^bits) (as ops/cuda/tile_conv.py::hilbert_code).
__device__ __forceinline__ unsigned hilbert3(int x0, int x1, int x2, int bits) {
  int X[3] = {x0, x1, x2};
  const int M = 1 << (bits - 1);
  for (int Q = M; Q > 1; Q >>= 1) {
    const int P = Q - 1;
#pragma unroll
    for (int i = 0; i < 3; ++i) {
      if (X[i] & Q) {
        X[0] ^= P;
      } else {
        const int t = (X[0] ^ X[i]) & P;
        X[0] ^= t;
        X[i] ^= t;
      }
    }
  }
  X[1] ^= X[0];
  X[2] ^= X[1];
  int t = 0;
  for (int Q = M; Q > 1; Q >>= 1)
    if (X[2] & Q) t ^= Q - 1;
  unsigned code = 0;
  for (int b = bits - 1; b >= 0; --b)
#pragma unroll
    for (int i = 0; i < 3; ++i) code = (code << 1) | (((X[i] ^ t) >> b) & 1);
  return code;
}

// One block a cloud (N <= kMaxCulledN): the valid points' box and count; each
// point's key, the Hilbert index of its cell among 128^3 over that box
// (masked points after every cell); a stable LSD radix sort of the keys in
// shared memory (a warp ranks equal digits with __match_any_sync, in item
// order, so the order is the same on every call); then, one warp a group of
// 32 sorted rows, the rows as float4 (x, y, z, |p|^2) into rec, each row's
// original index into order, and the group's box over its valid rows into
// box[2g] = (lo, largest |p|^2), box[2g + 1] = (hi, 0).
__global__ void __launch_bounds__(kSortThreads)
kde_layout_kernel(const float* __restrict__ pts, const uint8_t* __restrict__ mask, int N,
                  int* __restrict__ order, int* __restrict__ nvalid, float4* __restrict__ rec,
                  float4* __restrict__ box) {
  extern __shared__ unsigned char smem[];
  unsigned* keys[2] = {reinterpret_cast<unsigned*>(smem),
                       reinterpret_cast<unsigned*>(smem) + kMaxCulledN};
  unsigned short* idx[2] = {
      reinterpret_cast<unsigned short*>(smem + 2 * kMaxCulledN * sizeof(unsigned)),
      reinterpret_cast<unsigned short*>(smem + 2 * kMaxCulledN * sizeof(unsigned)) +
          kMaxCulledN};
  int* cnt = reinterpret_cast<int*>(smem + 2 * kMaxCulledN *
                                               (sizeof(unsigned) + sizeof(unsigned short)));
  __shared__ float red[6][kSortWarps];
  __shared__ int partial[kSortWarps];
  __shared__ int nv_s;
  const int b = blockIdx.x, lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  const float* P = pts + (size_t)b * N * 3;
  const uint8_t* V = mask + (size_t)b * N;

  // the box and count of the valid points
  float lo[3] = {INFINITY, INFINITY, INFINITY}, hi[3] = {-INFINITY, -INFINITY, -INFINITY};
  int n = 0;
  for (int i = threadIdx.x; i < N; i += kSortThreads) {
    if (!V[i]) continue;
    ++n;
#pragma unroll
    for (int d = 0; d < 3; ++d) {
      lo[d] = fminf(lo[d], P[3 * i + d]);
      hi[d] = fmaxf(hi[d], P[3 * i + d]);
    }
  }
#pragma unroll
  for (int d = 0; d < 3; ++d) {
    lo[d] = warp_min(lo[d]);
    hi[d] = warp_max(hi[d]);
  }
  for (int o = 16; o > 0; o >>= 1) n += __shfl_xor_sync(kFull, n, o);
  if (lane == 0) {
#pragma unroll
    for (int d = 0; d < 3; ++d) {
      red[d][w] = lo[d];
      red[3 + d][w] = hi[d];
    }
    partial[w] = n;
  }
  __syncthreads();
  if (w == 0) {
#pragma unroll
    for (int d = 0; d < 3; ++d) {
      lo[d] = warp_min(red[d][lane]);
      hi[d] = warp_max(red[3 + d][lane]);
    }
    n = partial[lane];
    for (int o = 16; o > 0; o >>= 1) n += __shfl_xor_sync(kFull, n, o);
    if (lane == 0) {
#pragma unroll
      for (int d = 0; d < 3; ++d) {
        red[d][0] = lo[d];
        red[3 + d][0] = hi[d];
      }
      nv_s = n;
      nvalid[b] = n;
    }
  }
  __syncthreads();

  // the keys, in index order
  const float l0 = red[0][0], l1 = red[1][0], l2 = red[2][0];
  const float ext = fmaxf(fmaxf(red[3][0] - l0, red[4][0] - l1), red[5][0] - l2);
  const int top = (1 << kHilbertBits) - 1;
  const float scale = ext > 0.f ? (float)(1 << kHilbertBits) / ext : 0.f;
  for (int i = threadIdx.x; i < N; i += kSortThreads) {
    unsigned key = kMaskedKey;
    if (V[i]) {
      const int c0 = min(top, max(0, (int)((P[3 * i] - l0) * scale)));
      const int c1 = min(top, max(0, (int)((P[3 * i + 1] - l1) * scale)));
      const int c2 = min(top, max(0, (int)((P[3 * i + 2] - l2) * scale)));
      key = hilbert3(c0, c1, c2, kHilbertBits);
    }
    keys[0][i] = key;
    idx[0][i] = (unsigned short)i;
  }
  __syncthreads();

  // the stable LSD radix sort (block_sort.cuh)
  block_sort::radix_sort(keys, idx, N, kPasses, cnt, partial);
  const unsigned short* sorted = idx[kPasses & 1];

  // the sorted rows, their original indices and the groups' boxes
  const int nv = nv_s;
  int* O = order + (size_t)b * N;
  float4* R = rec + (size_t)b * N;
  const int NG = (N + 31) / 32;
  for (int g = w; g < NG; g += kSortWarps) {
    const int row = g * 32 + lane;
    const bool valid = row < nv;
    float x = 0.f, y = 0.f, z = 0.f, sq = 0.f;
    if (row < N) {
      const int i = sorted[row];
      x = P[3 * i];
      y = P[3 * i + 1];
      z = P[3 * i + 2];
      sq = sq_norm_rn(x, y, z);
      R[row] = make_float4(x, y, z, sq);
      O[row] = i;
    }
    const float lx = warp_min(valid ? x : INFINITY), ly = warp_min(valid ? y : INFINITY),
                lz = warp_min(valid ? z : INFINITY);
    const float hx = warp_max(valid ? x : -INFINITY), hy = warp_max(valid ? y : -INFINITY),
                hz = warp_max(valid ? z : -INFINITY);
    const float m2 = warp_max(valid ? sq : 0.f);
    if (lane == 0) {
      box[((size_t)b * NG + g) * 2] = make_float4(lx, ly, lz, m2);
      box[((size_t)b * NG + g) * 2 + 1] = make_float4(hx, hy, hz, 0.f);
    }
  }
}

// One warp a tile of 32 sorted queries: cull the groups by box distance,
// sweep the kept ones in sorted order, write each query's original row.
__global__ void __launch_bounds__(kWarps * 32)
kde_culled_kernel(const float4* __restrict__ rec, const float4* __restrict__ box,
                  const int* __restrict__ order, const int* __restrict__ nvalid, int N, int NG,
                  float r2, float neg_half_inv_h2, float norm, float* __restrict__ out) {
  __shared__ int glist[kWarps][kWindow];
  __shared__ float4 stage[kWarps][32];
  const int b = blockIdx.y, lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  const int qt = blockIdx.x * kWarps + w;
  if (qt * 32 >= N) return;
  const int nv = nvalid[b];
  const int row = qt * 32 + lane;
  float* O = out + (size_t)b * N;
  const int dst = row < N ? order[(size_t)b * N + row] : 0;
  if (qt * 32 >= nv) {  // every query of the tile is masked
    if (row < N) O[dst] = 1.0f;
    return;
  }
  const bool qv = row < nv;
  const float4* R = rec + (size_t)b * N;
  const float4* BX = box + (size_t)b * NG * 2;
  const float4 q = qv ? R[row] : make_float4(0.f, 0.f, 0.f, 0.f);
  const float qlx = warp_min(qv ? q.x : INFINITY), qly = warp_min(qv ? q.y : INFINITY),
              qlz = warp_min(qv ? q.z : INFINITY);
  const float qhx = warp_max(qv ? q.x : -INFINITY), qhy = warp_max(qv ? q.y : -INFINITY),
              qhz = warp_max(qv ? q.z : -INFINITY);
  const float qm2 = warp_max(qv ? q.w : 0.f);
  const int ngv = (nv + 31) / 32;  // groups with a valid source
  int* list = glist[w];
  float4* st = stage[w];

  float acc = 0.f;
  for (int w0 = 0; w0 < ngv; w0 += kWindow) {
    const int w1 = min(ngv, w0 + kWindow);
    int ns = 0;
    for (int g0 = w0; g0 < w1; g0 += 32) {
      const int g = g0 + lane;
      bool keep = false;
      if (g < w1) {
        const float4 lo = BX[2 * g], hi = BX[2 * g + 1];
        const float gx = fmaxf(0.f, fmaxf(lo.x - qhx, qlx - hi.x));
        const float gy = fmaxf(0.f, fmaxf(lo.y - qhy, qly - hi.y));
        const float gz = fmaxf(0.f, fmaxf(lo.z - qhz, qlz - hi.z));
        keep = gx * gx + gy * gy + gz * gz <= r2 + 1e-6f * (qm2 + lo.w + r2);
      }
      const unsigned bal = __ballot_sync(kFull, keep);
      if (keep) list[ns + __popc(bal & ((1u << lane) - 1u))] = g;
      ns += __popc(bal);
    }
    __syncwarp();
    auto fetch = [&](int k) {
      const int j = list[k] * 32 + lane;
      return j < nv ? R[j] : make_float4(0.f, 0.f, 0.f, INFINITY);  // INF: out of range
    };
    float4 next = ns > 0 ? fetch(0) : make_float4(0.f, 0.f, 0.f, 0.f);
    for (int k = 0; k < ns; ++k) {
      st[lane] = next;
      if (k + 1 < ns) next = fetch(k + 1);
      __syncwarp();
#pragma unroll 8
      for (int t = 0; t < 32; ++t) {
        const float4 s = st[t];
        float d2 = pair_d2_rn(q.x, q.y, q.z, q.w, s.x, s.y, s.z, s.w);
        d2 = fmaxf(d2, 0.f);
        if (d2 <= r2) acc += expf(d2 * neg_half_inv_h2);
      }
      __syncwarp();
    }
  }
  if (row < N) O[dst] = qv ? norm * acc : 1.0f;
}

}  // namespace

extern "C" int kde_density_launch(const void* pts, const void* mask, int B, int N,
                                  float r2, float neg_half_inv_h2, float norm,
                                  void* out, void* stream) {
  dim3 grid((N + kKdeBlock - 1) / kKdeBlock, B);
  kde_density_kernel<<<grid, kKdeBlock, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(pts), static_cast<const uint8_t*>(mask), N, r2,
      neg_half_inv_h2, norm, static_cast<float*>(out));
  MCCNN_LAUNCH_RETURN();
}

// Bytes of the culled body's scratch for B clouds of N points, or -1 where
// they pass 2^31 - 1.
extern "C" int kde_culled_scratch_bytes(int B, int N) {
  const long long NG = (N + 31) / 32;
  const long long bytes = (long long)B * (16LL * N + 32LL * NG + 4LL * N + 4LL);
  return bytes > 0x7fffffffLL ? -1 : static_cast<int>(bytes);
}

// scratch (kde_culled_scratch_bytes, 16-byte aligned): the sorted rows
// (B, N) float4, the group boxes (B, ceil(N / 32), 2) float4, the sort
// order (B, N) int32 and the valid counts (B,) int32. N <= 8192.
extern "C" int kde_density_culled_launch(const void* pts, const void* mask, int B, int N,
                                         float r2, float neg_half_inv_h2, float norm,
                                         void* scratch, void* out, void* stream) {
  if (N > kMaxCulledN) return static_cast<int>(cudaErrorInvalidValue);
  const cudaError_t err = cudaFuncSetAttribute(
      kde_layout_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kLayoutSmem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int NG = (N + 31) / 32;
  float4* rec = static_cast<float4*>(scratch);
  float4* box = rec + (size_t)B * N;
  int* order = reinterpret_cast<int*>(box + (size_t)B * NG * 2);
  int* nvalid = order + (size_t)B * N;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  kde_layout_kernel<<<B, kSortThreads, kLayoutSmem, s>>>(
      static_cast<const float*>(pts), static_cast<const uint8_t*>(mask), N, order, nvalid, rec,
      box);
  dim3 grid((NG + kWarps - 1) / kWarps, B);
  kde_culled_kernel<<<grid, kWarps * 32, 0, s>>>(rec, box, order, nvalid, N, NG, r2,
                                                 neg_half_inv_h2, norm,
                                                 static_cast<float*>(out));
  MCCNN_LAUNCH_RETURN();
}
