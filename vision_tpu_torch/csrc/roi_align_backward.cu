// RoIAlign backward in the input, NCHW:
//
//   grad_input[b, c, h, w] = sum_{k: batch(k) = b} sum_p sum_q
//       W_y[k, p, h] * W_x[k, q, w] * g[k, c, p, q] / count_k
//
// where W_y[k, p, h] sums the bilinear row weights that the samples of
// bin p put on row h (and W_x the same over columns): the transpose of the
// forward's separable sampling (csrc/roi_align.cu). Every output element
// is written, zeros included. g and the gradient are f32, or bf16 (the amp
// path: f32 weights and sums, the gradient rounded once from its f32 sum).
//
// It has no TPU kernel to replace: the JAX package differentiates RoIAlign
// (vision_tpu/ops/_pallas/roi_align.py:roi_align_pallas) through the XLA
// VJP of roi_align_mxu (vision_tpu/ops/roi_align.py:420-431; of the gather
// path off the TPU), which is deterministic by design. The reference CUDA
// backward, and a PyTorch composite (index_put_ with accumulate,
// index_add_), add with floating-point atomics in an order that changes
// from run to run. This kernel uses no atomics: every output element is
// summed by one thread, over the RoIs in index order.
//
// Design:
//
//   describe a block a RoI, once: the batch index is checked on the card
//            (outside [0, N) the launch stops with a trap, as in the
//            forward); then the RoI's weights, W_y[p, h] / count and
//            W_x[q, w], each the sum over the bin's samples in the
//            forward's order (the sample positions are the forward's
//            expressions, built with -fmad=false: the plain version's to
//            the bit), rows padded to 8 and columns to 32 with zeros, into
//            scratch; then, from those weights, for each band of 8 rows
//            (tile of 32 columns) the range of bins whose weights reach it;
//   widen    g copied to f32 with each bin row padded to a multiple of 4
//            (a small pass: 15 MB at the 14x14 shape), so that one 16-byte
//            load brings 4 bins, in f32 and bf16 alike;
//   block    one image, a band of 8 rows x 32 columns x 16 channels, 256
//            threads: a lane a column, a warp 2 channels, 2 x 8 sums in
//            registers (launch bounds for three blocks an SM: the loop is
//            bound by the latency of its loads, and more warps hide more
//            of it; four spill more than they gain). It lists, 256 at a
//            time and in index order, the RoIs of its image whose weights
//            reach the tile (two loads a candidate), each with the range
//            of bins p that reach its rows and q that reach its columns;
//            then each warp walks the list on its own (no barrier a
//            RoI): per bin p in range, u = sum_q W_x[q, w] g[c, p, q], 4
//            bins a step, two steps' loads in flight (the padded g a
//            16-byte broadcast load, the same address in the warp; a bin
//            outside the range weighs 0 on the tile), then
//            sums[c][r] += W_y[p, r] u;
//   split    where the tiles are few (a small map: the dense fallback's
//            P4 and P5 levels) and the RoIs many, each tile's RoIs are cut
//            into fixed chunks in index order, a block a chunk, which
//            writes an f32 partial sum; a last kernel adds the partials in
//            chunk order. The split depends on the shapes only, so the
//            same inputs give the same bits.
//
// It covers what the forward covers: a fixed grid (sampling_ratio > 0)
// and the adaptive one (ceil(roi / pooled) samples a bin), aligned both
// ways, any pooled size.
//
// What bounds it: in bytes, writing the output. At the Faster R-CNN
// training shape (the dense fallback's 64 RoIs against each of the four
// levels of two 1344x1344 images, C = 256) the four level gradients are
// 308 MB in f32 (154 MB in bf16), nearly all zeros, against a few MB of
// sampled pixels. A block that no RoI reaches only writes its zeros; a RoI
// costs a tile the loads and multiply-adds of the bins that reach it, and
// on the small maps, where every tile meets most of the 64 RoIs, the
// latency of those loads (L2 hits, one RoI after another a warp) is what
// the time is made of.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>
#include <stdio.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kBand = 8;      // input rows a block: a thread's sums
constexpr int kTile = 32;     // input columns a block: a lane each
constexpr int kPerWarp = 2;   // channels a warp
constexpr int kSlab = kWarps * kPerWarp;  // channels a block
// The split aims at this many blocks (some eight an SM of a 132-SM card),
// with at least kMinChunk RoIs a chunk and kMaxSplit chunks.
constexpr long long kTargetBlocks = 1024;
constexpr int kMinChunk = 8;
constexpr int kMaxSplit = 16;
constexpr unsigned kAll = 0xffffffffu;

// The low and high corner lines of sample s of an axis (bin s / grid,
// point s % grid) and their weights, 0 outside [-1, size]: the forward's
// rules (csrc/roi_align.cu: sample).
struct Sample {
  int lo, hi;
  float wlo, whi;
};

__device__ __forceinline__ float coord(int s, int grid, float start,
                                       float bin, float step) {
  const int p = s / grid, i = s - p * grid;
  float x = start + (float)p * bin;
  return x + ((float)i + 0.5f) * step;
}

__device__ __forceinline__ Sample sample(int s, int grid, float start,
                                         float bin, float step, int size) {
  float x = coord(s, grid, start, bin, step);
  Sample out = {0, 0, 0.0f, 0.0f};
  if (x < -1.0f || x > (float)size) return out;
  x = fmaxf(x, 0.0f);
  int lo = (int)x, hi;
  if (lo >= size - 1) {
    hi = lo = size - 1;
    x = (float)lo;
  } else {
    hi = lo + 1;
  }
  const float l = x - (float)lo;
  out.lo = lo;
  out.hi = hi;
  out.wlo = 1.0f - l;
  out.whi = l;
  return out;
}

// A superset [lo, hi] of the lines that the samples of bin p reach: the
// samples are monotonic in their index (ascending, or descending where an
// aligned RoI has a negative extent), so from the low corner of the lower
// of the first and the last to the high corner of the other, one line
// wider on each side; empty (lo > hi) where the bin has no sample or every
// sample lies outside [-1, size].
__device__ __forceinline__ void bin_lines(int p, int grid, float start,
                                          float bin, float step, int size,
                                          int* lo, int* hi) {
  *lo = 1, *hi = 0;
  if (grid <= 0) return;
  const float a = coord(p * grid, grid, start, bin, step);
  const float z = coord(p * grid + grid - 1, grid, start, bin, step);
  const float first = fminf(a, z), last = fmaxf(a, z);
  if (last < -1.0f || first > (float)size) return;
  *lo = max((int)fmaxf(first, 0.0f) - 1, 0);
  *hi = min((int)fmaxf(last, 0.0f) + 2, size - 1);
}

// The weight that the grid samples of bin p put on `line`, summed in
// order.
__device__ __forceinline__ float line_weight(int p, int line, int grid,
                                             float start, float bin,
                                             float step, int size) {
  float w = 0.0f;
  for (int i = 0; i < grid; ++i) {
    const Sample s = sample(p * grid + i, grid, start, bin, step, size);
    if (s.lo == line) w += s.wlo;
    if (s.hi == line) w += s.whi;
  }
  return w;
}

__device__ __noinline__ void bad_batch_index(int r, float b, int n) {
  printf("roi_align_backward: RoI %d has batch index %g, outside [0, %d)\n",
         r, b, n);
  __trap();
}

// The scratch of one call, in floats, each part aligned to 64 floats:
// per RoI its batch index (-1: no sample), for each band of kBand rows the
// range of bins whose weights reach it and for each tile of kTile columns
// the same, W_y [k, ph, hp] / count and W_x [k, pwp, wp]; g widened to f32
// with its rows padded to pwp = 4 * ceil(pw / 4) bins, [k, c, ph, pwp]; then
// the partial sums of the split.
struct Layout {
  long long batch, yband, xtile, wy, wx, gpad, part, total;
  int bands, tiles, hp, wp, pwp, splits;
};

__host__ __device__ inline long long align64(long long v) {
  return (v + 63) / 64 * 64;
}

__host__ __device__ inline int split_count(long long blocks, int k) {
  if (blocks >= kTargetBlocks || k < 2 * kMinChunk) return 1;
  long long s = (kTargetBlocks + blocks - 1) / blocks;
  s = s < k / kMinChunk ? s : k / kMinChunk;
  s = s < kMaxSplit ? s : kMaxSplit;
  return s > 1 ? (int)s : 1;
}

__host__ __device__ inline Layout layout(int n, int c, int h, int w, int k,
                                         int ph, int pw) {
  Layout l;
  l.bands = (h + kBand - 1) / kBand;
  l.tiles = (w + kTile - 1) / kTile;
  l.hp = l.bands * kBand;
  l.wp = l.tiles * kTile;
  l.pwp = (pw + 3) / 4 * 4;
  l.splits = split_count(
      (long long)n * l.bands * l.tiles * ((c + kSlab - 1) / kSlab), k);
  l.batch = 0;
  l.yband = align64(l.batch + k);
  l.xtile = align64(l.yband + (long long)k * l.bands);
  l.wy = align64(l.xtile + (long long)k * l.tiles);
  l.wx = align64(l.wy + (long long)k * ph * l.hp);
  l.gpad = align64(l.wx + (long long)k * l.pwp * l.wp);
  l.part = align64(l.gpad + (long long)k * c * ph * l.pwp);
  l.total = l.part + (l.splits > 1
                          ? (long long)l.splits * n * c * h * w
                          : 0LL);
  return l;
}

// The range [lo, hi) of the np weight rows (stride `stride`) that have a
// non-zero in columns [a, a + len), as lo | hi << 16 (lo >= hi where none
// does), by one warp: a lane a row.
__device__ int rows_meeting(const float* wt, int np, int stride, int a,
                            int len, int lane) {
  int lo = np, hi = 0;
  for (int base = 0; base < np; base += 32) {
    const int p = base + lane;
    bool nz = false;
    if (p < np)
      for (int i = a; i < a + len; ++i) nz |= wt[(size_t)p * stride + i] != 0.0f;
    const unsigned m = __ballot_sync(kAll, nz);
    if (m) {
      lo = min(lo, base + __ffs(m) - 1);
      hi = base + 32 - __clz(m);
    }
  }
  return lo | hi << 16;
}

// One block a RoI: the batch-index check (outside [0, N) the launch
// stops), then its weights, and the bins whose weights reach each band and
// each tile.
__global__ void __launch_bounds__(kThreads)
    roi_align_backward_describe(const float* __restrict__ rois, int n, int h,
                                int w, int ph, int pw, float scale, int sr,
                                int aligned, Layout l,
                                float* __restrict__ scratch) {
  __shared__ float s_geo[8];  // start, bin, step of each axis; count
  __shared__ int s_grid[2];
  const int r = blockIdx.x, t = threadIdx.x;
  if (t == 0) {
    const float* roi = rois + (size_t)r * 5;
    // trunc(roi[0]) lies in [0, n) exactly when roi[0] lies in (-1, n); a
    // NaN fails both tests
    if (!(roi[0] > -1.0f && roi[0] < (float)n)) {
      bad_batch_index(r, roi[0], n);
      return;  // not reached: the launch has stopped
    }
    const float offset = aligned ? 0.5f : 0.0f;
    const float start_w = roi[1] * scale - offset;
    const float start_h = roi[2] * scale - offset;
    const float end_w = roi[3] * scale - offset;
    const float end_h = roi[4] * scale - offset;
    float roi_w = end_w - start_w, roi_h = end_h - start_h;
    if (!aligned) {
      roi_w = fmaxf(roi_w, 1.0f);
      roi_h = fmaxf(roi_h, 1.0f);
    }
    const float bin_h = roi_h / (float)ph, bin_w = roi_w / (float)pw;
    const int gh = sr > 0 ? sr : (int)ceilf(roi_h / (float)ph);
    const int gw = sr > 0 ? sr : (int)ceilf(roi_w / (float)pw);
    s_geo[0] = start_h;
    s_geo[1] = bin_h;
    s_geo[2] = gh > 0 ? bin_h / (float)gh : 0.0f;
    s_geo[3] = start_w;
    s_geo[4] = bin_w;
    s_geo[5] = gw > 0 ? bin_w / (float)gw : 0.0f;
    s_geo[6] = fmaxf((float)(gh * gw), 1.0f);
    s_grid[0] = gh > 0 && gw > 0 ? gh : 0;
    s_grid[1] = gh > 0 && gw > 0 ? gw : 0;
    // no sample at all: no tile to visit
    reinterpret_cast<int*>(scratch + l.batch)[r] =
        gh > 0 && gw > 0 ? (int)roi[0] : -1;
  }
  __syncthreads();
  const float count = s_geo[6];
  float* wy = scratch + l.wy + (size_t)r * ph * l.hp;
  for (int i = t; i < ph * l.hp; i += kThreads) {
    const int p = i / l.hp, line = i - p * l.hp;
    int lo, hi;
    bin_lines(p, s_grid[0], s_geo[0], s_geo[1], s_geo[2], h, &lo, &hi);
    wy[i] = line >= lo && line <= hi
                ? line_weight(p, line, s_grid[0], s_geo[0], s_geo[1],
                              s_geo[2], h) / count
                : 0.0f;
  }
  float* wx = scratch + l.wx + (size_t)r * l.pwp * l.wp;
  for (int i = t; i < l.pwp * l.wp; i += kThreads) {
    const int q = i / l.wp, line = i - q * l.wp;
    int lo = 1, hi = 0;
    if (q < pw)
      bin_lines(q, s_grid[1], s_geo[3], s_geo[4], s_geo[5], w, &lo, &hi);
    wx[i] = line >= lo && line <= hi
                ? line_weight(q, line, s_grid[1], s_geo[3], s_geo[4],
                              s_geo[5], w)
                : 0.0f;
  }
  __syncthreads();  // the weights are written
  int* yband = reinterpret_cast<int*>(scratch + l.yband) + (size_t)r * l.bands;
  int* xtile = reinterpret_cast<int*>(scratch + l.xtile) + (size_t)r * l.tiles;
  const int lane = t & 31;
  for (int i = t >> 5; i < l.bands; i += kWarps) {
    const int v = rows_meeting(wy, ph, l.hp, i * kBand, kBand, lane);
    if (lane == 0) yband[i] = v;
  }
  for (int i = t >> 5; i < l.tiles; i += kWarps) {
    const int v = rows_meeting(wx, pw, l.wp, i * kTile, kTile, lane);
    if (lane == 0) xtile[i] = v;
  }
}

__device__ __forceinline__ float widen(float v) { return v; }
__device__ __forceinline__ float widen(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ void put(float* p, float v) { *p = v; }
__device__ __forceinline__ void put(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);  // the f32 sum rounded once
}

// g [k, c, ph, pw] widened to f32 into rows of pwp bins, zeros past pw.
template <typename T>
__global__ void __launch_bounds__(kThreads)
    roi_align_backward_widen(const T* __restrict__ g, long long rows, int pw,
                             int pwp, float* __restrict__ gpad) {
  const long long total = rows * pwp;
  for (long long i = (long long)blockIdx.x * kThreads + threadIdx.x;
       i < total; i += (long long)gridDim.x * kThreads) {
    const long long row = i / pwp;
    const int q = (int)(i - row * pwp);
    gpad[i] = q < pw ? widen(g[row * pw + q]) : 0.0f;
  }
}

// TOut is T where the block writes the gradient (no split), else float
// (a partial sum).
template <typename TOut>
__global__ void __launch_bounds__(kThreads, 3)
    roi_align_backward_kernel(Layout l, const float* __restrict__ scratch,
                              int c, int h, int w, int k, int ph,
                              TOut* __restrict__ out) {
  __shared__ int s_k[kThreads], s_p[kThreads], s_q[kThreads];
  __shared__ int s_count[kWarps];

  int blk = blockIdx.x;
  const int tile = blk % l.tiles;
  blk /= l.tiles;
  const int band = blk % l.bands;
  const int b = blk / l.bands;
  const int rb = band * kBand, xb = tile * kTile;
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const int cw = blockIdx.y * kSlab + warp * kPerWarp;  // the warp's channels
  const int nch = min(kPerWarp, c - cw);
  const int chunk = (k + l.splits - 1) / l.splits;
  const int k0 = blockIdx.z * chunk, k1 = min(k, k0 + chunk);
  const int* batch = reinterpret_cast<const int*>(scratch + l.batch);
  const int* yband = reinterpret_cast<const int*>(scratch + l.yband);
  const int* xtile = reinterpret_cast<const int*>(scratch + l.xtile);
  const int pwp = l.pwp, rowg = ph * pwp;  // a channel's padded g

  float acc[kPerWarp][kBand];
#pragma unroll
  for (int j = 0; j < kPerWarp; ++j)
#pragma unroll
    for (int r = 0; r < kBand; ++r) acc[j][r] = 0.0f;

  for (int base = k0; base < k1; base += kThreads) {
    // the RoIs of this chunk whose weights reach the tile, in index order
    const int i = base + t;
    bool meets = false;
    int pr = 0, qr = 0;
    if (i < k1) {  // three independent loads
      const int bi = batch[i];
      pr = yband[(size_t)i * l.bands + band];
      qr = xtile[(size_t)i * l.tiles + tile];
      meets = bi == b && (pr & 0xffff) < (pr >> 16) &&
              (qr & 0xffff) < (qr >> 16);
    }
    const unsigned m = __ballot_sync(kAll, meets);
    __syncthreads();  // the last chunk's list is no longer read
    if (lane == 0) s_count[warp] = __popc(m);
    __syncthreads();
    int before = 0, n = 0;
#pragma unroll
    for (int v = 0; v < kWarps; ++v) {
      const int cnt = s_count[v];
      before += v < warp ? cnt : 0;
      n += cnt;
    }
    if (meets) {
      const int at = before + __popc(m & ((1u << lane) - 1u));
      s_k[at] = i;
      s_p[at] = pr;
      s_q[at] = qr;
    }
    __syncthreads();
    if (nch <= 0) continue;  // a warp past the last channel

    for (int j = 0; j < n; ++j) {
      const int r = s_k[j], pr = s_p[j], qr = s_q[j];
      // whole groups of 4 bins: the bins of a group outside [qlo, qhi)
      // have a zero weight on this tile, and the padding bins zero g
      const int q4lo = (qr & 0xffff) >> 2, q4hi = ((qr >> 16) + 3) >> 2;
      const float* wyr = scratch + l.wy + ((size_t)r * ph) * l.hp + rb;
      const float* wxr =
          scratch + l.wx + ((size_t)r * pwp) * l.wp + xb + lane;
      const float* gr = scratch + l.gpad + ((size_t)r * c + cw) * rowg;
      for (int p = pr & 0xffff; p < (pr >> 16); ++p) {
        // no test of the row weights: a bin in range whose weights miss the
        // band adds zeros, and the loads below need not wait for them
        const float4 y0 = *reinterpret_cast<const float4*>(wyr + p * l.hp);
        const float4 y1 = *reinterpret_cast<const float4*>(wyr + p * l.hp + 4);
        const float wyv[kBand] = {y0.x, y0.y, y0.z, y0.w,
                                  y1.x, y1.y, y1.z, y1.w};
        float u[kPerWarp];
#pragma unroll
        for (int j2 = 0; j2 < kPerWarp; ++j2) u[j2] = 0.0f;
        const float* gp = gr + p * pwp;
#pragma unroll 2  // two groups' loads in flight
        for (int q4 = q4lo; q4 < q4hi; ++q4) {
          const float* wq = wxr + (size_t)(4 * q4) * l.wp;
          const float w0 = wq[0], w1 = wq[l.wp], w2 = wq[2 * l.wp],
                      w3 = wq[3 * l.wp];
#pragma unroll
          for (int j2 = 0; j2 < kPerWarp; ++j2) {
            if (j2 >= nch) break;
            // a broadcast load: the same 4 bins in the whole warp
            const float4 g4 = *reinterpret_cast<const float4*>(
                gp + (size_t)j2 * rowg + 4 * q4);
            u[j2] = __fmaf_rn(w0, g4.x, u[j2]);
            u[j2] = __fmaf_rn(w1, g4.y, u[j2]);
            u[j2] = __fmaf_rn(w2, g4.z, u[j2]);
            u[j2] = __fmaf_rn(w3, g4.w, u[j2]);
          }
        }
#pragma unroll
        for (int j2 = 0; j2 < kPerWarp; ++j2)
#pragma unroll
          for (int row = 0; row < kBand; ++row)
            acc[j2][row] = __fmaf_rn(wyv[row], u[j2], acc[j2][row]);
      }
    }
  }

  const int col = xb + lane;
  if (col >= w) return;
  const int n = gridDim.x / (l.bands * l.tiles);
  TOut* o = out + (size_t)blockIdx.z * n * c * h * w;
#pragma unroll
  for (int j = 0; j < kPerWarp; ++j) {
    if (j >= nch) break;
    TOut* oc = o + (((size_t)b * c + cw + j) * h + rb) * w + col;
#pragma unroll
    for (int row = 0; row < kBand; ++row)
      if (rb + row < h) put(oc + (size_t)row * w, acc[j][row]);
  }
}

// The partial sums of the split added in chunk order, rounded once.
template <typename T>
__global__ void __launch_bounds__(kThreads)
    roi_align_backward_combine(const float* __restrict__ part, long long total,
                               int splits, T* __restrict__ out) {
  for (long long i = (long long)blockIdx.x * kThreads + threadIdx.x;
       i < total; i += (long long)gridDim.x * kThreads) {
    float s = part[i];
    for (int z = 1; z < splits; ++z) s += part[z * total + i];
    put(out + i, s);
  }
}

int grid_for(long long total) {
  const long long need = (total + kThreads - 1) / kThreads;
  return (int)(need < 4096 ? need : 4096);
}

template <typename T>
int launch(const void* g, float* scratch, void* out, const Layout& l, int n,
           int c, int h, int w, int k, int ph, int pw, cudaStream_t s) {
  const long long blocks = (long long)n * l.bands * l.tiles;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  if (k > 0) {
    const long long rows = (long long)k * c * ph;
    roi_align_backward_widen<T><<<grid_for(rows * l.pwp), kThreads, 0, s>>>(
        static_cast<const T*>(g), rows, pw, l.pwp, scratch + l.gpad);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  const dim3 grid((unsigned)blocks, (unsigned)((c + kSlab - 1) / kSlab),
                  (unsigned)l.splits);
  if (l.splits == 1) {
    roi_align_backward_kernel<T><<<grid, kThreads, 0, s>>>(
        l, scratch, c, h, w, k, ph, static_cast<T*>(out));
    return (int)cudaGetLastError();
  }
  float* part = scratch + l.part;
  roi_align_backward_kernel<float><<<grid, kThreads, 0, s>>>(
      l, scratch, c, h, w, k, ph, part);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const long long total = (long long)n * c * h * w;
  roi_align_backward_combine<T><<<grid_for(total), kThreads, 0, s>>>(
      part, total, l.splits, static_cast<T*>(out));
  return (int)cudaGetLastError();
}

}  // namespace

// The f32 scratch that vt_roi_align_backward takes, in floats; -1 where it
// passes INT_MAX.
extern "C" int vt_roi_align_backward_scratch(int n, int c, int h, int w, int k,
                                             int ph, int pw) {
  const long long total = layout(n, c, h, w, k, ph, pw).total;
  return total > INT_MAX ? -1 : (int)total;
}

// g [k, c, ph, pw] and out [n, c, h, w], both f32 (bf16 = 0) or both bf16
// (bf16 = 1); rois [k, 5] f32 (batch index, x1, y1, x2, y2); scratch of
// vt_roi_align_backward_scratch(n, c, h, w, k, ph, pw) floats. Every
// element of out is written. A batch index outside [0, n) stops the launch
// on the card.
extern "C" int vt_roi_align_backward(const void* g, const float* rois,
                                     void* scratch, void* out, int n, int c,
                                     int h, int w, int k, int ph, int pw,
                                     float scale, int sr, int aligned,
                                     int bf16, void* stream) {
  if ((long long)n * c * h * w == 0) return 0;
  if (ph < 1 || pw < 1 || ph >= (1 << 15) || pw >= (1 << 15))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Layout l = layout(n, c, h, w, k, ph, pw);
  float* sc = static_cast<float*>(scratch);
  if (k > 0) {
    roi_align_backward_describe<<<k, kThreads, 0, s>>>(
        rois, n, h, w, ph, pw, scale, sr, aligned, l, sc);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  if (bf16)
    return launch<__nv_bfloat16>(g, sc, out, l, n, c, h, w, k, ph, pw, s);
  return launch<float>(g, sc, out, l, n, c, h, w, k, ph, pw, s);
}
