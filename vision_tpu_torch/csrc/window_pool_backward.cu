// Windowed multi-scale RoIAlign contraction, backward in the pyramid:
//
//   grad[r, x, c] = sum_k sum_p sum_q w_y[k, p, r - row0[k]]
//                   * w_x[k, q, x - x0[k]] * g[k, c, p, q] / div
//
// over the RoIs whose window covers (r, x), and 0 elsewhere. f32.
//
// It has no TPU kernel to replace: the JAX package differentiates the
// window pool (vision_tpu/ops/_pallas/window_pool.py:window_pool_pallas)
// through the XLA VJP of _window_pool_xla (vision_tpu/ops/poolers.py:43,
// 82-84), a scatter-add of a [K, win, win, C] window gradient. That
// buffer is 1.07 GB in f32 at the Faster R-CNN training shape (K = 1024,
// 32 x 32 windows, C = 256), and a scatter-add with floating-point atomics
// adds in an order that changes from run to run. This kernel builds no
// window gradient and uses no atomics: every output element is summed by
// one thread, over its RoIs in one fixed order.
//
// Design:
//
//   order    the wrapper sorts the RoIs by row0 on the card (stable: ties
//            in index order), and a first kernel describes each RoI in
//            that order, a warp a RoI: the window's bounds check (a window
//            outside the pyramid traps), then the pyramid rows and columns
//            where its weights are not all zero;
//   bands    a second small kernel finds, a thread a band of 8 pyramid
//            rows, by binary search the range of sorted RoIs whose window
//            can meet the band;
//   block    a band of 8 pyramid rows x 32 columns x 32 channels, 256
//            threads: thread (4 columns, 1 channel) holds 8 x 4 sums in
//            registers. It walks its band's RoIs in sorted order, skipping
//            those whose non-zero rows or columns miss its tile;
//   per RoI  the RoI's g slab (/ div), and its weights on the tile's rows
//            and columns, go to shared memory; each thread contracts w_x
//            with g for its columns (T[p][x] = sum_q w_x[q, x] g[c, p, q]),
//            then w_y with T into its sums, over the band rows the RoI's
//            weights reach.
//
// What bounds it: the multiply-adds and the shared-memory reads of the
// RoIs a tile meets, not bytes. The output (444 MB at the training shape,
// a 1,292 x 336 pyramid of 256 channels) is written once, coalesced
// (32 consecutive channels a warp), zeros included; g and the weights are
// read once per tile a RoI meets. A simple kernel: T is recomputed for
// each band a window meets.

#include <cuda_runtime.h>
#include <stdint.h>
#include <stdio.h>

namespace {

constexpr int kThreads = 256;
constexpr int kBand = 8;                        // pyramid rows a block
constexpr int kTile = 32;                       // pyramid columns a block
constexpr int kSlab = 32;                       // channels a block
constexpr int kCols = kTile / (kThreads / kSlab);  // 4 columns a thread
constexpr int kMaxP = 16;                       // PH, PW at most
constexpr unsigned kAll = 0xffffffffu;

// A RoI in sorted order: its index, window origin, and the pyramid rows
// [r0, r1) and columns [c0, c1) where its weights are not all zero.
struct Extent {
  int k, row0, x0, r0, r1, c0, c1, pad;
};

__device__ __noinline__ void out_of_bounds(int k, int row0, int x0, int winy,
                                           int winx, int rrows, int wmax) {
  printf("window_pool_backward: the window of RoI %d at (%d, %d) leaves the "
         "pyramid (row0 + %d must be <= %d and x0 + %d <= %d)\n",
         k, row0, x0, winy, rrows, winx, wmax);
  __trap();
}

// The first [lo, lo + n) range of indices i < len at which some of the np
// rows of w (row stride len) is non-zero, by one warp.
__device__ int extent(const float* w, int np, int len, int lane, int* lo_out) {
  int lo = len, hi = 0;
  for (int base = 0; base < len; base += 32) {
    const int i = base + lane;
    bool nz = false;
    if (i < len)
      for (int p = 0; p < np; ++p) nz |= w[(size_t)p * len + i] != 0.0f;
    const unsigned m = __ballot_sync(kAll, nz);
    if (m) {
      lo = min(lo, base + __ffs(m) - 1);
      hi = base + 32 - __clz(m);
    }
  }
  *lo_out = lo;
  return max(hi - lo, 0);
}

__global__ void __launch_bounds__(kThreads)
    window_pool_backward_describe(const int* __restrict__ order,
                    const int* __restrict__ row0, const int* __restrict__ x0,
                    const float* __restrict__ wy,
                    const float* __restrict__ wx, int rrows, int wmax, int k,
                    int ph, int pw, int winy, int winx,
                    Extent* __restrict__ ext) {
  const int lane = threadIdx.x & 31;
  const int i = blockIdx.x * (kThreads / 32) + (threadIdx.x >> 5);
  if (i >= k) return;
  const int r = order[i], r0 = row0[r], c0 = x0[r];
  if (r0 < 0 || (long long)r0 + winy > rrows || c0 < 0 ||
      (long long)c0 + winx > wmax) {
    if (lane == 0) out_of_bounds(r, r0, c0, winy, winx, rrows, wmax);
    return;  // not reached: the launch has stopped
  }
  int ylo, xlo;
  const int ny = extent(wy + (size_t)r * ph * winy, ph, winy, lane, &ylo);
  const int nx = extent(wx + (size_t)r * pw * winx, pw, winx, lane, &xlo);
  if (lane == 0) {
    if (ny > 0 && nx > 0)
      ext[i] = Extent{r, r0, c0, r0 + ylo, r0 + ylo + ny, c0 + xlo,
                      c0 + xlo + nx, 0};
    else  // nothing to add: meets no tile
      ext[i] = Extent{r, r0, c0, -1, -1, -1, -1, 0};
  }
}

// The first index in sorted[0, n) whose value is >= v.
__device__ int lower_bound(const int* sorted, int n, long long v) {
  int lo = 0, hi = n;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (sorted[mid] < v)
      lo = mid + 1;
    else
      hi = mid;
  }
  return lo;
}

// One thread a band of kBand pyramid rows: the range [first, last) of the
// sorted RoIs whose window can meet it, rb - winy < row0 < rb + kBand.
__global__ void __launch_bounds__(kThreads)
    window_pool_backward_bands(const int* __restrict__ sorted_row0, int k,
                               int nbands, int winy, int* __restrict__ ranges) {
  const int band = blockIdx.x * kThreads + threadIdx.x;
  if (band >= nbands) return;
  const long long rb = (long long)band * kBand;
  ranges[2 * band] = lower_bound(sorted_row0, k, rb - winy + 1);
  ranges[2 * band + 1] = lower_bound(sorted_row0, k, rb + kBand);
}

template <int kP>
__global__ void __launch_bounds__(kThreads)
    window_pool_backward_kernel(const float* __restrict__ g,
                                const int* __restrict__ ranges,
                                const Extent* __restrict__ ext,
                                const float* __restrict__ wy,
                                const float* __restrict__ wx, int rrows,
                                int wmax, int c, int ph, int pw, int winy,
                                int winx, float div,
                                float* __restrict__ out) {
  const int npq = ph * pw, gstride = npq | 1;  // odd: no bank conflicts
  __shared__ float s_g[kSlab * (kMaxP * kMaxP + 1)];  // [c][p*pw + q]
  __shared__ float s_wy[kBand * kP];                 // [r][p]
  __shared__ __align__(16) float s_wx[kMaxP * kTile];  // [q][x]

  const int ntiles = (wmax + kTile - 1) / kTile;
  const int band = blockIdx.x / ntiles;
  const int rb = band * kBand;
  const int xb = (blockIdx.x % ntiles) * kTile;
  const int cb = blockIdx.y * kSlab;
  const int t = threadIdx.x, ch = t % kSlab, cg = t / kSlab;
  const int first = ranges[2 * band], last = ranges[2 * band + 1];

  float acc[kBand][kCols];
#pragma unroll
  for (int r = 0; r < kBand; ++r)
#pragma unroll
    for (int j = 0; j < kCols; ++j) acc[r][j] = 0.0f;

  for (int i = first; i < last; ++i) {
    const Extent e = ext[i];
    if (e.r1 <= rb || e.r0 >= rb + kBand || e.c1 <= xb || e.c0 >= xb + kTile)
      continue;  // the same test in every thread
    __syncthreads();  // the last RoI's staging is no longer read
    const float* gk = g + ((size_t)e.k * c + cb) * npq;
    for (int idx = t; idx < kSlab * npq; idx += kThreads) {
      const int cc = idx / npq, pq = idx - cc * npq;
      s_g[cc * gstride + pq] = cb + cc < c ? gk[idx] / div : 0.0f;
    }
    for (int idx = t; idx < kBand * kP; idx += kThreads) {
      const int r = idx / kP, p = idx - r * kP;
      const int y = rb + r - e.row0;
      s_wy[idx] = p < ph && y >= 0 && y < winy
                      ? wy[((size_t)e.k * ph + p) * winy + y]
                      : 0.0f;
    }
    for (int idx = t; idx < pw * kTile; idx += kThreads) {
      const int q = idx / kTile, x = xb + idx - q * kTile - e.x0;
      s_wx[idx] = x >= 0 && x < winx ? wx[((size_t)e.k * pw + q) * winx + x]
                                     : 0.0f;
    }
    __syncthreads();

    // T[p][j] = sum_q w_x[q, column j] * g[ch, p, q]
    float tp[kP][kCols];
#pragma unroll
    for (int p = 0; p < kP; ++p) {
#pragma unroll
      for (int j = 0; j < kCols; ++j) tp[p][j] = 0.0f;
      if (p < ph) {
        const float* gp = s_g + ch * gstride + p * pw;
        for (int q = 0; q < pw; ++q) {
          const float gv = gp[q];
          const float4 w4 =
              *reinterpret_cast<const float4*>(s_wx + q * kTile + cg * kCols);
          tp[p][0] += w4.x * gv;
          tp[p][1] += w4.y * gv;
          tp[p][2] += w4.z * gv;
          tp[p][3] += w4.w * gv;
        }
      }
    }
    const int rlo = max(e.r0 - rb, 0), rhi = min(e.r1 - rb, kBand);
#pragma unroll
    for (int r = 0; r < kBand; ++r) {
      if (r < rlo || r >= rhi) continue;
#pragma unroll
      for (int j = 0; j < kCols; ++j) {
        float a = 0.0f;
#pragma unroll
        for (int p = 0; p < kP; ++p)
          if (p < ph) a += s_wy[r * kP + p] * tp[p][j];
        acc[r][j] += a;
      }
    }
  }

  if (cb + ch >= c) return;
#pragma unroll
  for (int r = 0; r < kBand; ++r) {
    if (rb + r >= rrows) break;
#pragma unroll
    for (int j = 0; j < kCols; ++j) {
      const int x = xb + cg * kCols + j;
      if (x < wmax) out[((size_t)(rb + r) * wmax + x) * c + cb + ch] = acc[r][j];
    }
  }
}

}  // namespace

// The int32 scratch that vt_window_pool_backward takes for k RoIs and a
// pyramid of rrows rows: k Extents and a range of RoIs per band of rows.
extern "C" int vt_window_pool_backward_scratch(int k, int rrows) {
  return k * (int)(sizeof(Extent) / sizeof(int)) +
         2 * ((rrows + kBand - 1) / kBand);
}

// g [k, c, ph, pw] f32; sorted_row0 [k] the window rows in ascending order
// and order [k] the RoI of each (a stable sort); row0/x0 [k] int32 (each
// window is checked on the card); wy [k, ph, winy], wx [k, pw, winx] f32;
// scratch of vt_window_pool_backward_scratch(k, rrows) int32; out [rrows,
// wmax, c] f32, every element written. ph, pw <= 16.
extern "C" int vt_window_pool_backward(
    const float* g, const int* sorted_row0, const int* order, const int* row0,
    const int* x0, const float* wy, const float* wx, void* scratch,
    float* out, int rrows, int wmax, int c, int k, int ph, int pw, int winy,
    int winx, float div, void* stream) {
  if ((long long)rrows * wmax * c == 0) return 0;
  if (ph > kMaxP || pw > kMaxP || ph < 1 || pw < 1)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  Extent* e = static_cast<Extent*>(scratch);
  int* ranges = reinterpret_cast<int*>(e + k);
  const int nbands = (rrows + kBand - 1) / kBand;
  if (k > 0) {
    const int warps = kThreads / 32;
    window_pool_backward_describe<<<(k + warps - 1) / warps, kThreads, 0, s>>>(
        order, row0, x0, wy, wx, rrows, wmax, k, ph, pw, winy, winx, e);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  window_pool_backward_bands<<<(nbands + kThreads - 1) / kThreads, kThreads, 0,
                               s>>>(sorted_row0, k, nbands, winy, ranges);
  const long long tiles = (long long)nbands * ((wmax + kTile - 1) / kTile);
  if (tiles > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  const dim3 grid((unsigned)tiles, (unsigned)((c + kSlab - 1) / kSlab));
  if (ph <= 8)
    window_pool_backward_kernel<8><<<grid, kThreads, 0, s>>>(
        g, ranges, e, wy, wx, rrows, wmax, c, ph, pw, winy, winx, div, out);
  else
    window_pool_backward_kernel<16><<<grid, kThreads, 0, s>>>(
        g, ranges, e, wy, wx, rrows, wmax, c, ph, pw, winy, winx, div, out);
  return (int)cudaGetLastError();
}
