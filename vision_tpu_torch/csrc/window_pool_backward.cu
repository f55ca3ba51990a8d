// Windowed multi-scale RoIAlign contraction, backward in the pyramid:
//
//   grad[r, x, c] = sum_k sum_p sum_q w_y[k, p, r - row0[k]]
//                   * w_x[k, q, x - x0[k]] * g[k, c, p, q] / div
//
// over the RoIs whose window covers (r, x), and 0 elsewhere. g and the
// gradient are f32, or bf16 (the amp path: f32 weights and sums, the
// gradient rounded once from its f32 sum).
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
//            threads: a warp a row, a lane a channel, 32 column sums in
//            registers (templates of 8, 14 and 16 bins a side, launch
//            bounds for three blocks an SM at 8 and two above). It lists,
//            256 candidates at a time, the RoIs of its band whose non-zero
//            rows and columns meet its tile, in sorted order, and walks
//            the list;
//   staging  double-buffered: while RoI j is summed from shared memory,
//            the loads of RoI j + 1's g slab (32 channels x PH x PW,
//            contiguous in g), of its w_y on the band's rows and of its
//            w_x on the tile's columns are in flight into registers; they
//            are stored to shared memory (channel-minor, the slab widened
//            to f32, w_y / div) between two barriers, one pair a RoI;
//   per RoI  w_y first: each warp contracts its row's weights with the slab,
//            u[q] = sum_p w_y[row, p] g[c, p, q], skipping the bins whose
//            weight on the row is 0 (a row meets two or three of them);
//            then sums[x] += sum_q u[q] w_x[q, x], skipping the bins q
//            whose w_x is 0 on the whole tile and the groups of 4 columns
//            outside the RoI's non-zero columns. Contracting w_y first
//            costs 8 PH PW + 8 PW 32 multiply-adds a channel a tile
//            (5,152 at 14x14) against w_x first's PH PW 32 + 8 PH 32
//            (9,856), and nothing is recomputed across the bands a window
//            meets: each band contracts w_y only on its own rows.
//
// What bounds it: writing the output (444 MB in f32 at the training shape,
// a 1,292 x 336 pyramid of 256 channels; 222 MB in bf16), coalesced (32
// consecutive channels a warp), zeros included, and the multiply-adds and
// shared-memory reads of the RoIs a tile meets; g and the weights are read
// once per tile a RoI meets.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <stdio.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kBand = kWarps;       // pyramid rows a block: a warp each
constexpr int kTile = 32;           // pyramid columns a block
constexpr int kSlab = 32;           // channels a block: a lane each
constexpr int kGS = kSlab + 1;      // the staged slab's row stride
constexpr int kGroups = kTile / 4;  // groups of 4 columns
constexpr int kMaxP = 16;           // PH, PW at most
constexpr unsigned kAll = 0xffffffffu;

// A RoI in sorted order: its index, window origin, and the pyramid rows
// [r0, r1) and columns [c0, c1) where its weights are not all zero.
struct Extent {
  int k, row0, x0, r0, r1, c0, c1, pad;
};

__device__ __forceinline__ float widen(float v) { return v; }
__device__ __forceinline__ float widen(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ void put(float* p, float v) { *p = v; }
__device__ __forceinline__ void put(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);  // the f32 sum rounded once
}
template <typename T>
__device__ __forceinline__ T zero();
template <>
__device__ __forceinline__ float zero<float>() {
  return 0.0f;
}
template <>
__device__ __forceinline__ __nv_bfloat16 zero<__nv_bfloat16>() {
  return __ushort_as_bfloat16((unsigned short)0);
}

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
  const int i = blockIdx.x * kWarps + (threadIdx.x >> 5);
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

// One RoI's staging in registers: its g slab (kStage elements a thread,
// slab index t + j kThreads), its w_y on the band's rows and its w_x on the
// tile's columns.
template <typename T, int kP>
struct Staged {
  static constexpr int kStage = (kP * kP * kSlab + kThreads - 1) / kThreads;
  static constexpr int kWx = (kP * kTile + kThreads - 1) / kThreads;
  T g[kStage];
  float wy;
  float wx[kWx];
};

template <typename T, int kP>
__global__ void __launch_bounds__(kThreads, kP <= 8 ? 3 : 2)
    window_pool_backward_kernel(const T* __restrict__ g,
                                const int* __restrict__ ranges,
                                const Extent* __restrict__ ext,
                                const float* __restrict__ wy,
                                const float* __restrict__ wx, int rrows,
                                int wmax, int c, int ph, int pw, int winy,
                                int winx, float div, T* __restrict__ out) {
  using S = Staged<T, kP>;
  __shared__ float s_g[kP * kP * kGS];             // [p * pw + q][channel]
  __shared__ __align__(16) float s_wx[kP * kTile];  // [q][x]
  __shared__ float s_wy[kBand * kP];               // [row][p], / div
  __shared__ int s_qnz[kP];  // bin q has a non-zero w_x on the tile
  __shared__ int s_list[kThreads];
  __shared__ int s_count[kWarps];

  const int ntiles = (wmax + kTile - 1) / kTile;
  const int band = blockIdx.x / ntiles;
  const int rb = band * kBand;
  const int xb = (blockIdx.x % ntiles) * kTile;
  const int cb = blockIdx.y * kSlab;
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const int first = ranges[2 * band], last = ranges[2 * band + 1];
  const int npq = ph * pw;
  const int nslab = min(kSlab, c - cb) * npq;  // this slab's g elements
  // slab index t + j kThreads = channel * npq + pq, stepped without a
  // division: kThreads = step_c * npq + step_pq
  const int step_c = kThreads / npq, step_pq = kThreads - step_c * npq;

  float acc[kTile];
#pragma unroll
  for (int x = 0; x < kTile; ++x) acc[x] = 0.0f;

  S st;
  auto fetch = [&](int i) {
    const Extent e = ext[i];
    const T* gk = g + ((size_t)e.k * c + cb) * npq;  // the slab is contiguous
#pragma unroll
    for (int j = 0; j < S::kStage; ++j) {
      const int idx = t + j * kThreads;
      st.g[j] = idx < nslab ? gk[idx] : zero<T>();
    }
    st.wy = 0.0f;
    if (t < kBand * kP) {
      const int p = t % kP, y = rb + t / kP - e.row0;
      if (p < ph && y >= 0 && y < winy)
        st.wy = wy[((size_t)e.k * ph + p) * winy + y];
    }
#pragma unroll
    for (int j = 0; j < S::kWx; ++j) {
      const int q = warp + j * kWarps, x = xb + lane - e.x0;
      st.wx[j] = q < pw && x >= 0 && x < winx
                     ? wx[((size_t)e.k * pw + q) * winx + x]
                     : 0.0f;
    }
  };
  auto commit = [&]() {
    int ch = t / npq, pq = t - ch * npq;
#pragma unroll
    for (int j = 0; j < S::kStage; ++j) {
      if (t + j * kThreads < nslab) s_g[pq * kGS + ch] = widen(st.g[j]);
      ch += step_c;
      pq += step_pq;
      if (pq >= npq) {
        pq -= npq;
        ++ch;
      }
    }
    if (t < kBand * kP) s_wy[t] = st.wy / div;
#pragma unroll
    for (int j = 0; j < S::kWx; ++j) {
      const int q = warp + j * kWarps;  // the same in the whole warp
      if (q >= kP) break;
      s_wx[q * kTile + lane] = st.wx[j];
      const unsigned nz = __ballot_sync(kAll, st.wx[j] != 0.0f);
      if (lane == 0) s_qnz[q] = nz != 0u;
    }
  };

  for (int base = first; base < last; base += kThreads) {
    // the candidates that meet the tile, in sorted order
    const int i = base + t;
    bool meets = false;
    if (i < last) {
      const Extent e = ext[i];
      meets = e.r0 < rb + kBand && e.r1 > rb && e.c0 < xb + kTile &&
              e.c1 > xb;
    }
    const unsigned m = __ballot_sync(kAll, meets);
    __syncthreads();  // the last chunk's list is no longer read
    if (lane == 0) s_count[warp] = __popc(m);
    __syncthreads();
    int before = 0, n = 0;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const int cnt = s_count[w];
      before += w < warp ? cnt : 0;
      n += cnt;
    }
    if (meets) s_list[before + __popc(m & ((1u << lane) - 1u))] = i;
    __syncthreads();
    if (n == 0) continue;  // the same in every thread

    fetch(s_list[0]);
    for (int j = 0; j < n; ++j) {
      const Extent e = ext[s_list[j]];
      __syncthreads();  // the last RoI's staging is no longer read
      commit();
      __syncthreads();
      if (j + 1 < n) fetch(s_list[j + 1]);  // in flight while this RoI sums

      const int row = rb + warp;
      if (row < e.r0 || row >= e.r1) continue;  // the same in the warp
      float u[kP];
#pragma unroll
      for (int q = 0; q < kP; ++q) u[q] = 0.0f;
      for (int p = 0; p < ph; ++p) {
        const float w = s_wy[warp * kP + p];
        if (w == 0.0f) continue;  // the same in the warp
        const float* gp = s_g + p * pw * kGS + lane;
#pragma unroll
        for (int q = 0; q < kP; ++q)
          if (q < pw) u[q] += w * gp[q * kGS];
      }
      const int xlo = max(e.c0 - xb, 0), xhi = min(e.c1 - xb, kTile);
#pragma unroll
      for (int q = 0; q < kP; ++q) {
        if (q >= pw || !s_qnz[q]) continue;  // the same in the block
        const float* wq = s_wx + q * kTile;
#pragma unroll
        for (int gi = 0; gi < kGroups; ++gi) {
          if (4 * gi >= xhi || 4 * gi + 4 <= xlo) continue;  // the same
          const float4 w4 = *reinterpret_cast<const float4*>(wq + 4 * gi);
          acc[4 * gi] += u[q] * w4.x;
          acc[4 * gi + 1] += u[q] * w4.y;
          acc[4 * gi + 2] += u[q] * w4.z;
          acc[4 * gi + 3] += u[q] * w4.w;
        }
      }
    }
  }

  const int row = rb + warp, ch = cb + lane;
  if (row >= rrows || ch >= c) return;
  T* o = out + ((size_t)row * wmax + xb) * c + ch;
#pragma unroll
  for (int x = 0; x < kTile; ++x)
    if (xb + x < wmax) put(o + (size_t)x * c, acc[x]);
}

template <typename T>
int launch(const void* g, const int* ranges, const Extent* e, const float* wy,
           const float* wx, void* out, int rrows, int wmax, int c, int ph,
           int pw, int winy, int winx, float div, dim3 grid, cudaStream_t s) {
  const T* gt = static_cast<const T*>(g);
  T* o = static_cast<T*>(out);
  // 8: the box head's 7x7; 14: the mask and keypoint heads' 14x14
  if (ph <= 8 && pw <= 8)
    window_pool_backward_kernel<T, 8><<<grid, kThreads, 0, s>>>(
        gt, ranges, e, wy, wx, rrows, wmax, c, ph, pw, winy, winx, div, o);
  else if (ph <= 14 && pw <= 14)
    window_pool_backward_kernel<T, 14><<<grid, kThreads, 0, s>>>(
        gt, ranges, e, wy, wx, rrows, wmax, c, ph, pw, winy, winx, div, o);
  else
    window_pool_backward_kernel<T, 16><<<grid, kThreads, 0, s>>>(
        gt, ranges, e, wy, wx, rrows, wmax, c, ph, pw, winy, winx, div, o);
  return (int)cudaGetLastError();
}

}  // namespace

// The int32 scratch that vt_window_pool_backward takes for k RoIs and a
// pyramid of rrows rows: k Extents and a range of RoIs per band of rows.
extern "C" int vt_window_pool_backward_scratch(int k, int rrows) {
  return k * (int)(sizeof(Extent) / sizeof(int)) +
         2 * ((rrows + kBand - 1) / kBand);
}

// g [k, c, ph, pw] and out [rrows, wmax, c], both f32 (bf16 = 0) or both
// bf16 (bf16 = 1); sorted_row0 [k] the window rows in ascending order and
// order [k] the RoI of each (a stable sort); row0/x0 [k] int32 (each window
// is checked on the card); wy [k, ph, winy], wx [k, pw, winx] f32; scratch
// of vt_window_pool_backward_scratch(k, rrows) int32. Every element of out
// is written. ph, pw <= 16.
extern "C" int vt_window_pool_backward(
    const void* g, const int* sorted_row0, const int* order, const int* row0,
    const int* x0, const float* wy, const float* wx, void* scratch, void* out,
    int rrows, int wmax, int c, int k, int ph, int pw, int winy, int winx,
    float div, int bf16, void* stream) {
  if ((long long)rrows * wmax * c == 0) return 0;
  if (ph > kMaxP || pw > kMaxP || ph < 1 || pw < 1)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  Extent* e = static_cast<Extent*>(scratch);
  int* ranges = reinterpret_cast<int*>(e + k);
  const int nbands = (rrows + kBand - 1) / kBand;
  if (k > 0) {
    window_pool_backward_describe<<<(k + kWarps - 1) / kWarps, kThreads, 0,
                                    s>>>(order, row0, x0, wy, wx, rrows, wmax,
                                         k, ph, pw, winy, winx, e);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  window_pool_backward_bands<<<(nbands + kThreads - 1) / kThreads, kThreads, 0,
                               s>>>(sorted_row0, k, nbands, winy, ranges);
  const long long tiles = (long long)nbands * ((wmax + kTile - 1) / kTile);
  if (tiles > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  const dim3 grid((unsigned)tiles, (unsigned)((c + kSlab - 1) / kSlab));
  if (bf16)
    return launch<__nv_bfloat16>(g, ranges, e, wy, wx, out, rrows, wmax, c, ph,
                                 pw, winy, winx, div, grid, s);
  return launch<float>(g, ranges, e, wy, wx, out, rrows, wmax, c, ph, pw, winy,
                       winx, div, grid, s);
}
