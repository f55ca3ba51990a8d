// RoIAlign forward, NCHW, one thread per output element (k, c, ph, pw).
//
// Replaces the TPU kernel vision_tpu/ops/_pallas/roi_align.py:
// roi_align_pallas. That kernel recasts the bilinear gather as two dense
// one-hot matrix products so that the TPU's matrix unit does the work.
// On Hopper a gather is cheap, so this is the direct form: each thread
// averages the sr x sr (or adaptive ceil(roi/pooled)) bilinear samples of
// its bin, reading four neighbours per sample from the input plane.
//
// What bounds it: memory. Each output reads 4 * sr^2 input floats,
// scattered over the RoI's footprint; neighbouring threads (neighbouring
// pw, same channel) read neighbouring addresses, so the reads of a warp
// share cache lines and the L1/L2 serve most of them. The work per output
// is a few dozen FLOPs.
//
// Edge rules as vision_tpu/ops/roi_align.py:_roi_align_gather (the CUDA
// rules of the reference): a sample outside [-1, size] contributes 0; the
// low/high corners clamp to size-1. Sample positions are computed in the
// same order as the plain version (start + p * bin + (i + 0.5) *
// (bin / grid)) and built with -fmad=false, so they agree to the bit.

#include <cuda_runtime.h>
#include <math.h>

namespace {

__device__ __forceinline__ float bilinear(const float* __restrict__ plane,
                                          int h, int w, float y, float x) {
  if (y < -1.0f || y > (float)h || x < -1.0f || x > (float)w) return 0.0f;
  y = fmaxf(y, 0.0f);
  x = fmaxf(x, 0.0f);
  int yl = (int)y, xl = (int)x, yh, xh;
  if (yl >= h - 1) {
    yh = yl = h - 1;
    y = (float)yl;
  } else {
    yh = yl + 1;
  }
  if (xl >= w - 1) {
    xh = xl = w - 1;
    x = (float)xl;
  } else {
    xh = xl + 1;
  }
  const float ly = y - (float)yl, lx = x - (float)xl;
  const float hy = 1.0f - ly, hx = 1.0f - lx;
  const float v1 = plane[yl * w + xl], v2 = plane[yl * w + xh];
  const float v3 = plane[yh * w + xl], v4 = plane[yh * w + xh];
  return hy * hx * v1 + hy * lx * v2 + ly * hx * v3 + ly * lx * v4;
}

__global__ void roi_align_forward_kernel(
    const float* __restrict__ input, const float* __restrict__ rois, int n,
    int c, int h, int w, int k, int ph, int pw, float scale, int sr,
    int aligned, float* __restrict__ out) {
  const long long total = (long long)k * c * ph * pw;
  const long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= total) return;
  const int q = (int)(idx % pw);
  const int p = (int)((idx / pw) % ph);
  const int ch = (int)((idx / ((long long)pw * ph)) % c);
  const int r = (int)(idx / ((long long)pw * ph * c));

  const float* roi = rois + (size_t)r * 5;
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
  const float base_h = start_h + (float)p * bin_h;
  const float base_w = start_w + (float)q * bin_w;

  const float* plane = input + ((size_t)b * c + ch) * h * w;
  float sum = 0.0f;
  for (int iy = 0; iy < gh; ++iy) {
    const float y = base_h + ((float)iy + 0.5f) * step_h;
    for (int ix = 0; ix < gw; ++ix) {
      const float x = base_w + ((float)ix + 0.5f) * step_w;
      sum += bilinear(plane, h, w, y, x);
    }
  }
  out[idx] = sum / count;
}

}  // namespace

// input [n, c, h, w] f32, rois [k, 5] f32 (batch index, x1, y1, x2, y2),
// out [k, c, ph, pw] f32. Batch indices must lie in [0, n).
extern "C" int vt_roi_align_forward(const float* input, const float* rois,
                                    float* out, int n, int c, int h, int w,
                                    int k, int ph, int pw, float scale, int sr,
                                    int aligned, void* stream) {
  const long long total = (long long)k * c * ph * pw;
  if (total == 0) return 0;
  const int threads = 256;
  const long long blocks = (total + threads - 1) / threads;
  roi_align_forward_kernel<<<(unsigned)blocks, threads, 0,
                             static_cast<cudaStream_t>(stream)>>>(
      input, rois, n, c, h, w, k, ph, pw, scale, sr, aligned, out);
  return (int)cudaGetLastError();
}
