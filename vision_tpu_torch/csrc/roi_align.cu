// RoIAlign forward, NCHW, as a separable contraction with the RoI's
// weights built once.
//
// Replaces the TPU kernel vision_tpu/ops/_pallas/roi_align.py:
// roi_align_pallas. That kernel computes the bilinear pool as two
// contractions with precomputed separable weights, rows = w_y @ feat, then
// out = w_x @ rows, because the TPU's matrix unit makes dense one-hot
// products cheaper than gathers. On Hopper the gather is cheap and what
// costs is the work around it, so this kernel keeps the separable weights
// and drops the dense products:
//
//   block    one RoI and a slab of kSlab channels, 256 threads, each with
//            up to kPerThread outputs (c, p, q), consecutive in memory;
//   weights  the RoI's sample rows and columns, each with its two corner
//            lines (rows as offsets into the plane) and weights, built
//            once in shared memory, kChunk samples an axis at a time (the
//            sample positions are the plain version's expressions, built
//            with -fmad=false, so they agree to the bit; a sample outside
//            the map gets weights 0);
//   output   per row sample of bin p, the columns' corners of bin q are
//            contracted with w_x first, then the two rows with w_y: four
//            loads and a few multiply-adds a sample pair, the weights read
//            from shared memory, nothing recomputed per output;
//   adaptive sampling_ratio <= 0 (ceil(roi / pooled) samples a bin) walks
//            the samples in chunks of kChunk an axis, the sums carried in
//            registers, so shared memory stays fixed.
//
// What bounds it: instructions and load latency, not bytes: a call of the
// Faster R-CNN path reads a few MB, mostly from L2. The design cuts the
// instructions of an output to its loads and their multiply-adds and
// keeps every thread independent (no barrier after the weights), so the
// card hides the loads' latency across many threads.
//
// Edge rules as vision_tpu/ops/roi_align.py:_roi_align_gather (the CUDA
// rules of the reference): a sample outside [-1, size] contributes 0; the
// low/high corners clamp to size-1. The sums are taken in another order
// than the plain version's: agreement within 1e-5 of the largest value.
//
// Element types: f32, and bf16 for the amp path. A bf16 input is read as
// it lies and widened at the multiply-add; weights and sums stay f32. A
// bf16 output is rounded as the TPU kernel rounds it: the f32 sum to bf16,
// then divided by the sample count in f32 and rounded again
// (vision_tpu/ops/_pallas/roi_align.py:104,230).
//
// A RoI's batch index (its first column, truncated as the plain version
// truncates it) is checked on the card: outside [0, N) the launch stops
// with a trap, which the host sees as an error at its next
// synchronisation; the input is never read there.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdio.h>

namespace {

constexpr int kThreads = 256;
constexpr int kSlab = 16;       // channels a block
constexpr int kPerThread = 4;   // outputs a thread takes at once
constexpr int kChunk = 256;     // samples an axis whose weights are staged

// One sample along an axis: its low and high corner lines and weights.
struct __align__(16) Sample {
  int lo, hi;  // rows: line * w; columns: the line
  float wlo, whi;
};

// Sample s of an axis (bin s / grid, point s % grid), the rules of
// _bilinear_gather; `stride` scales the lines (w for rows, 1 for columns).
__device__ __forceinline__ Sample sample(int s, int grid, float start,
                                         float bin, float step, int size,
                                         int stride) {
  const int p = s / grid, i = s - p * grid;
  float x = start + (float)p * bin;
  x = x + ((float)i + 0.5f) * step;
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
  out.lo = lo * stride;
  out.hi = hi * stride;
  out.wlo = 1.0f - l;
  out.whi = l;
  return out;
}

__device__ __forceinline__ float widen(float v) { return v; }
__device__ __forceinline__ float widen(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

__device__ __forceinline__ void finish(float* o, float sum, float count) {
  *o = sum / count;
}
__device__ __forceinline__ void finish(__nv_bfloat16* o, float sum,
                                       float count) {
  *o = __float2bfloat16_rn(__bfloat162float(__float2bfloat16_rn(sum)) / count);
}

__device__ __noinline__ void bad_batch_index(int r, float b, int n) {
  printf("roi_align: RoI %d has batch index %g, outside [0, %d)\n", r, b, n);
  __trap();
}

// kGrid > 0: a fixed grid of kGrid x kGrid samples a bin, whose loops the
// compiler unrolls (every load of a thread's outputs in flight at once);
// the launch takes it when one chunk holds every sample of both axes.
// kGrid == 0: any grid, the adaptive one included.
template <typename T, int kGrid>
__global__ void __launch_bounds__(kThreads)
    roi_align_forward_kernel(const T* __restrict__ input,
                             const float* __restrict__ rois, int n, int c,
                             int h, int w, int ph, int pw, float scale,
                             int sr, int aligned, T* __restrict__ out) {
  __shared__ Sample ys[kChunk], xs[kChunk];
  const int slabs = (c + kSlab - 1) / kSlab;
  const int r = blockIdx.x / slabs, c0 = (blockIdx.x - r * slabs) * kSlab;
  const int nch = min(kSlab, c - c0);
  const int tid = threadIdx.x;

  const float* roi = rois + (size_t)r * 5;
  // trunc(roi[0]) lies in [0, n) exactly when roi[0] lies in (-1, n); a NaN
  // fails both tests
  if (!(roi[0] > -1.0f && roi[0] < (float)n)) {
    if (tid == 0) bad_batch_index(r, roi[0], n);
    return;  // not reached: the launch has stopped
  }
  const int b = (int)roi[0];
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
  const float step_h = bin_h / (float)gh, step_w = bin_w / (float)gw;
  const float count = fmaxf((float)(gh * gw), 1.0f);
  const int ny = ph * max(gh, 0), nx = pw * max(gw, 0);
  const int area = ph * pw, nout = nch * area;
  const T* planes = input + ((size_t)b * c + c0) * h * w;
  T* o = out + ((size_t)r * c + c0) * area;

  for (int base = 0; base < nout; base += kThreads * kPerThread) {
    float sum[kPerThread];
#pragma unroll
    for (int k = 0; k < kPerThread; ++k) sum[k] = 0.0f;
    for (int y0 = 0; y0 < ny; y0 += kChunk) {
      const int y1 = min(y0 + kChunk, ny);
      for (int x0 = 0; x0 < nx; x0 += kChunk) {
        const int x1 = min(x0 + kChunk, nx);
        __syncthreads();  // the last chunk's weights are no longer read
        for (int s = tid; s < y1 - y0; s += kThreads)
          ys[s] = sample(y0 + s, gh, start_h, bin_h, step_h, h, w);
        for (int s = tid; s < x1 - x0; s += kThreads)
          xs[s] = sample(x0 + s, gw, start_w, bin_w, step_w, w, 1);
        __syncthreads();
#pragma unroll
        for (int k = 0; k < kPerThread; ++k) {
          const int i = base + tid + k * kThreads;
          if (i >= nout) break;
          const int g = i / area, pq = i - g * area;
          const int p = pq / pw, q = pq - p * pw;
          const int sy0 = max(p * gh, y0) - y0, sy1 = min((p + 1) * gh, y1) - y0;
          const int sx0 = max(q * gw, x0) - x0, sx1 = min((q + 1) * gw, x1) - x0;
          const T* plane = planes + (size_t)g * h * w;
          float acc = 0.0f;
          if (kGrid > 0) {
#pragma unroll
            for (int u = 0; u < kGrid; ++u) {
              const Sample Y = ys[p * kGrid + u];
              float a = 0.0f, d = 0.0f;
#pragma unroll
              for (int v = 0; v < kGrid; ++v) {
                const Sample X = xs[q * kGrid + v];
                a += X.wlo * widen(plane[Y.lo + X.lo]) +
                     X.whi * widen(plane[Y.lo + X.hi]);
                d += X.wlo * widen(plane[Y.hi + X.lo]) +
                     X.whi * widen(plane[Y.hi + X.hi]);
              }
              acc += Y.wlo * a + Y.whi * d;
            }
            sum[k] += acc;
            continue;
          }
          for (int sy = sy0; sy < sy1; ++sy) {
            const Sample Y = ys[sy];
            const T* rlo = plane + Y.lo;
            const T* rhi = plane + Y.hi;
            float a = 0.0f, d = 0.0f;  // the low and the high row
            for (int sx = sx0; sx < sx1; ++sx) {
              const Sample X = xs[sx];
              a += X.wlo * widen(rlo[X.lo]) + X.whi * widen(rlo[X.hi]);
              d += X.wlo * widen(rhi[X.lo]) + X.whi * widen(rhi[X.hi]);
            }
            acc += Y.wlo * a + Y.whi * d;
          }
          sum[k] += acc;
        }
      }
    }
#pragma unroll
    for (int k = 0; k < kPerThread; ++k) {
      const int i = base + tid + k * kThreads;
      if (i < nout) finish(o + i, sum[k], count);
    }
  }
}

template <typename T>
void launch(const void* input, const float* rois, void* out, int n, int c,
            int h, int w, int k, int ph, int pw, float scale, int sr,
            int aligned, cudaStream_t s) {
  const long long blocks = (long long)k * ((c + kSlab - 1) / kSlab);
  const T* in = static_cast<const T*>(input);
  T* o = static_cast<T*>(out);
  if (sr == 2 && ph * 2 <= kChunk && pw * 2 <= kChunk)
    roi_align_forward_kernel<T, 2><<<(unsigned)blocks, kThreads, 0, s>>>(
        in, rois, n, c, h, w, ph, pw, scale, sr, aligned, o);
  else
    roi_align_forward_kernel<T, 0><<<(unsigned)blocks, kThreads, 0, s>>>(
        in, rois, n, c, h, w, ph, pw, scale, sr, aligned, o);
}

}  // namespace

// input [n, c, h, w] and out [k, c, ph, pw], both f32 (bf16 = 0) or both
// bf16 (bf16 = 1); rois [k, 5] f32 (batch index, x1, y1, x2, y2). A batch
// index outside [0, n) stops the launch on the card.
extern "C" int vt_roi_align_forward(const void* input, const float* rois,
                                    void* out, int n, int c, int h, int w,
                                    int k, int ph, int pw, float scale, int sr,
                                    int aligned, int bf16, void* stream) {
  if ((long long)k * c * ph * pw == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bf16)
    launch<__nv_bfloat16>(input, rois, out, n, c, h, w, k, ph, pw, scale, sr,
                          aligned, s);
  else
    launch<float>(input, rois, out, n, c, h, w, k, ph, pw, scale, sr,
                  aligned, s);
  return (int)cudaGetLastError();
}
