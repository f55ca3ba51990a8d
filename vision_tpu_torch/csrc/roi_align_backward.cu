// RoIAlign backward in the input, NCHW, f32:
//
//   grad_input[b, c, h, w] = sum_{k: batch(k) = b} sum_p sum_q
//       W_y[k, p, h] * W_x[k, q, w] * g[k, c, p, q] / count_k
//
// where W_y[k, p, h] sums the bilinear row weights that the samples of
// bin p put on row h (and W_x the same over columns): the transpose of the
// forward's separable sampling (csrc/roi_align.cu). Every output element
// is written, zeros included.
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
//   describe a first kernel, a thread a RoI: the batch index is checked on
//            the card (outside [0, N) the launch stops with a trap, as in
//            the forward), then the RoI's sampling grid and a conservative
//            extent of the lines its samples reach (from the first and the
//            last sample of each axis) go to a 64-byte descriptor;
//   block    one image, a band of 8 rows x 32 columns x 16 channels, 256
//            threads: lane = column, warp = 2 channels, 8 x 2 sums in
//            registers. It walks the RoIs in index order, 256 at a time:
//            each thread tests one descriptor against the tile, and the
//            block visits the RoIs of its image that reach it;
//   per RoI  W_y on the band's rows and W_x on the tile's columns are built
//            in shared memory, a thread a (bin, line) pair summing the
//            bin's samples that touch its line in order (the sample
//            positions are the forward's expressions, built with
//            -fmad=false: the plain version's to the bit); the RoI's g slab
//            / count beside them; then per bin p that reaches the band,
//            u = sum_q W_x[q, w] g[c, p, q] and sums[r] += W_y[p, r] u.
//            A tile where the weights of its rows or of its columns are
//            all zero (a large RoI samples some lines of its extent) is
//            skipped before the gradient slab is staged.
//
// It covers what the forward covers: a fixed grid (sampling_ratio > 0)
// and the adaptive one (ceil(roi / pooled) samples a bin), aligned both
// ways, any pooled size whose g slab fits shared memory.
//
// What bounds it: writing the output. At the Faster R-CNN training shape
// (the dense fallback's 64 RoIs against each of the four levels of two
// 1344x1344 images, C = 256) the four level gradients are 308 MB, nearly
// all zeros, against a few MB of sampled pixels; each block also walks
// all K RoIs (64 there) to find its own. A simple kernel: the weights are
// rebuilt in every tile a RoI meets.

#include <cuda_runtime.h>
#include <math.h>
#include <stdio.h>

namespace {

constexpr int kThreads = 256;
constexpr int kBand = 8;     // input rows a block
constexpr int kTile = 32;    // input columns a block: a lane each
constexpr int kSlab = 16;    // channels a block
constexpr int kPerWarp = kSlab / (kThreads / 32);  // 2 channels a thread

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

// A superset of the lines that some of the n > 0 samples of the axis
// reaches: the samples are monotonic in their index (ascending, or
// descending where an aligned RoI has a negative extent), so from the low
// corner of the lowest of the first and the last to the high corner of the
// other, one line wider on each side; empty (lo > hi) where every sample
// lies outside [-1, size].
__device__ __forceinline__ void lines(int n, int grid, float start, float bin,
                                      float step, int size, int* lo, int* hi) {
  const float a = coord(0, grid, start, bin, step);
  const float z = coord(n - 1, grid, start, bin, step);
  const float first = fminf(a, z), last = fmaxf(a, z);
  if (last < -1.0f || first > (float)size) {
    *lo = 1, *hi = 0;
    return;
  }
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

// A RoI's sampling grid, as the forward builds it, and the lines its
// samples can reach; b = -1 where it has no sample.
struct __align__(16) RoiDesc {
  int b, gh, gw, ylo, yhi, xlo, xhi, pad;
  float start_h, bin_h, step_h, start_w, bin_w, step_w, count, pad2;
};

// One thread a RoI: the batch-index check (outside [0, N) the launch
// stops), then the RoI's grid and line extents.
__global__ void __launch_bounds__(kThreads)
    roi_align_backward_describe(const float* __restrict__ rois, int n, int k,
                                int h, int w, int ph, int pw, float scale,
                                int sr, int aligned,
                                RoiDesc* __restrict__ desc) {
  const int r = blockIdx.x * kThreads + threadIdx.x;
  if (r >= k) return;
  const float* roi = rois + (size_t)r * 5;
  // trunc(roi[0]) lies in [0, n) exactly when roi[0] lies in (-1, n); a NaN
  // fails both tests
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
  RoiDesc d;
  d.b = (int)roi[0];
  d.bin_h = roi_h / (float)ph;
  d.bin_w = roi_w / (float)pw;
  d.gh = sr > 0 ? sr : (int)ceilf(roi_h / (float)ph);
  d.gw = sr > 0 ? sr : (int)ceilf(roi_w / (float)pw);
  d.start_h = start_h;
  d.start_w = start_w;
  d.ylo = d.xlo = 1;
  d.yhi = d.xhi = 0;
  d.pad = 0;
  d.pad2 = 0.0f;
  if (d.gh > 0 && d.gw > 0) {
    d.step_h = d.bin_h / (float)d.gh;
    d.step_w = d.bin_w / (float)d.gw;
    d.count = fmaxf((float)(d.gh * d.gw), 1.0f);
    lines(ph * d.gh, d.gh, start_h, d.bin_h, d.step_h, h, &d.ylo, &d.yhi);
    lines(pw * d.gw, d.gw, start_w, d.bin_w, d.step_w, w, &d.xlo, &d.xhi);
  } else {
    d.step_h = d.step_w = 0.0f;
    d.count = 1.0f;
  }
  if (d.ylo > d.yhi || d.xlo > d.xhi) d.b = -1;  // no sample: no tile
  desc[r] = d;
}

__global__ void __launch_bounds__(kThreads)
    roi_align_backward_kernel(const float* __restrict__ g,
                              const RoiDesc* __restrict__ desc, int c, int h,
                              int w, int k, int ph, int pw,
                              float* __restrict__ out) {
  extern __shared__ __align__(16) float smem[];
  const int npq = ph * pw;
  float* s_g = smem;                    // [kSlab][npq]
  float* s_wy = s_g + kSlab * npq;      // [ph][kBand]
  float* s_wx = s_wy + ph * kBand;      // [pw][kTile]
  int* s_prow = reinterpret_cast<int*>(s_wx + pw * kTile);  // [ph]
  __shared__ int s_meets[kThreads];

  const int bands = (h + kBand - 1) / kBand, tiles = (w + kTile - 1) / kTile;
  int blk = blockIdx.x;
  const int tile = blk % tiles;
  blk /= tiles;
  const int band = blk % bands;
  const int b = blk / bands;
  const int rb = band * kBand, xb = tile * kTile, cb = blockIdx.y * kSlab;
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;

  float acc[kPerWarp][kBand];
#pragma unroll
  for (int j = 0; j < kPerWarp; ++j)
#pragma unroll
    for (int r = 0; r < kBand; ++r) acc[j][r] = 0.0f;

  // the RoIs in index order, kThreads at a time: a thread tests one for
  // this tile, then the block visits those that meet it
  for (int base = 0; base < k; base += kThreads) {
    bool meets = false;
    if (base + t < k) {
      const RoiDesc& d = desc[base + t];
      meets = d.b == b && d.yhi >= rb && d.ylo < rb + kBand && d.xhi >= xb &&
              d.xlo < xb + kTile;
    }
    __syncthreads();  // the last chunk's list and staging are no longer read
    s_meets[t] = meets;
    __syncthreads();
    const int nr = min(kThreads, k - base);
    for (int j = 0; j < nr; ++j) {
      if (!s_meets[j]) continue;  // the same in every thread
      const int r = base + j;
      const RoiDesc d = desc[r];
      __syncthreads();  // the last RoI's staging is no longer read
      bool ynz = false, xnz = false;
      for (int i = t; i < ph * kBand; i += kThreads) {
        const int p = i / kBand, row = rb + i - p * kBand;
        s_wy[i] = row < h ? line_weight(p, row, d.gh, d.start_h, d.bin_h,
                                        d.step_h, h)
                          : 0.0f;
        ynz |= s_wy[i] != 0.0f;
      }
      for (int i = t; i < pw * kTile; i += kThreads) {
        const int q = i / kTile, col = xb + i - q * kTile;
        s_wx[i] = col < w ? line_weight(q, col, d.gw, d.start_w, d.bin_w,
                                        d.step_w, w)
                          : 0.0f;
        xnz |= s_wx[i] != 0.0f;
      }
      // a large RoI's samples touch only some of the rows and columns of
      // its extent: skip the tiles where they touch none
      const int any_y = __syncthreads_or(ynz);
      const int any_x = __syncthreads_or(xnz);
      if (!any_y || !any_x) continue;  // the same in every thread
      const float* gk = g + ((size_t)r * c + cb) * npq;
      for (int i = t; i < kSlab * npq; i += kThreads)
        s_g[i] = cb + i / npq < c ? gk[i] / d.count : 0.0f;
      for (int p = t; p < ph; p += kThreads) {
        bool any = false;
        for (int row = 0; row < kBand; ++row)
          any |= s_wy[p * kBand + row] != 0.0f;
        s_prow[p] = any;
      }
      __syncthreads();

#pragma unroll
      for (int jj = 0; jj < kPerWarp; ++jj) {
        const float* gc = s_g + (warp * kPerWarp + jj) * npq;
        for (int p = 0; p < ph; ++p) {
          if (!s_prow[p]) continue;  // the same in every thread
          float u = 0.0f;
          for (int q = 0; q < pw; ++q)
            u += s_wx[q * kTile + lane] * gc[p * pw + q];
          const float* wyp = s_wy + p * kBand;
#pragma unroll
          for (int row = 0; row < kBand; ++row) acc[jj][row] += wyp[row] * u;
        }
      }
    }
  }

  const int col = xb + lane;
  if (col >= w) return;
#pragma unroll
  for (int j = 0; j < kPerWarp; ++j) {
    const int ch = cb + warp * kPerWarp + j;
    if (ch >= c) continue;
    float* o = out + (((size_t)b * c + ch) * h + rb) * w + col;
#pragma unroll
    for (int row = 0; row < kBand; ++row)
      if (rb + row < h) o[(size_t)row * w] = acc[j][row];
  }
}

}  // namespace

// g [k, c, ph, pw] f32; rois [k, 5] f32 (batch index, x1, y1, x2, y2);
// desc scratch of k RoiDescs (64 bytes each); out [n, c, h, w] f32, every
// element written. A batch index outside [0, n) stops the launch on the
// card.
extern "C" int vt_roi_align_backward(const float* g, const float* rois,
                                     void* desc, float* out, int n, int c,
                                     int h, int w, int k, int ph, int pw,
                                     float scale, int sr, int aligned,
                                     void* stream) {
  if ((long long)n * c * h * w == 0) return 0;
  if (ph < 1 || pw < 1) return (int)cudaErrorInvalidValue;
  const size_t smem = ((size_t)kSlab * ph * pw + (size_t)ph * kBand +
                       (size_t)pw * kTile + ph) * sizeof(float);
  if (smem + kThreads * sizeof(int) > 232448) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      roi_align_backward_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  RoiDesc* d = static_cast<RoiDesc*>(desc);
  if (k > 0) {
    roi_align_backward_describe<<<(k + kThreads - 1) / kThreads, kThreads, 0,
                                  s>>>(rois, n, k, h, w, ph, pw, scale, sr,
                                       aligned, d);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  }
  const long long blocks =
      (long long)n * ((h + kBand - 1) / kBand) * ((w + kTile - 1) / kTile);
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  const dim3 grid((unsigned)blocks, (unsigned)((c + kSlab - 1) / kSlab));
  roi_align_backward_kernel<<<grid, kThreads, smem, s>>>(g, d, c, h, w, k, ph,
                                                         pw, out);
  return (int)cudaGetLastError();
}
