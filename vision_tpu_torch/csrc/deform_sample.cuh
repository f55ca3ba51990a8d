// The bilinear sample of a deformable convolution, shared by the forward
// kernel (deform_conv.cu) and the backward kernels
// (deform_conv_backward.cu), so that both see the same positions, corners
// and weights to the bit.
//
// Rules of vision_tpu/ops/deform_conv.py:88-145: the sample of tap
// (i, j) at output (oy, ox) lies at y = oy * sh - ph + i * dh + dy (one f32
// add: the base is an exact integer), likewise x; it counts only strictly
// inside (-1, H) x (-1, W); each of its four corners (yl, xl), (yl, xh),
// (yh, xl), (yh, xh) counts only inside the map; their weights are
// hy hx, hy lx, ly hx, ly lx with ly = y - floor(y), hy = 1 - ly. Built
// with -fmad=false, every product and sum is rounded on its own, as the
// plain PyTorch version rounds it.
//
// Layouts: the input channels last [N, H, W, C]; offsets [N, 2 og K², OH,
// OW] (channel g 2K² + 2 tap + {0: dy, 1: dx}); mask [N, og K², OH, OW];
// columns and their gradient [N, OH, OW, K², C]. A sample is indexed
// s = ((b * L + pos) * K² + tap) * og + g, L = OH * OW, so that
// consecutive samples own consecutive rows of the columns.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace deform {

struct Geometry {
  int n, c, h, w, kh, kw, oh, ow, og, sh, sw, ph, pw, dh, dw;
  __host__ __device__ int k2() const { return kh * kw; }
  __host__ __device__ long long l() const { return (long long)oh * ow; }
  __host__ __device__ int cg() const { return c / og; }
  __host__ __device__ long long samples() const {
    return (long long)n * l() * k2() * og;
  }
};

struct Sample {
  int b, pos, tap, g;
};

__device__ __forceinline__ Sample decode(long long s, const Geometry& geo) {
  Sample out;
  out.g = (int)(s % geo.og);
  s /= geo.og;
  out.tap = (int)(s % geo.k2());
  s /= geo.k2();
  out.pos = (int)(s % geo.l());
  out.b = (int)(s / geo.l());
  return out;
}

// the offset channel of dy for sample `s`; dx is the next one
__device__ __forceinline__ long long offset_channel(const Sample& s,
                                                    const Geometry& geo) {
  return ((long long)s.b * geo.og + s.g) * 2 * geo.k2() + 2 * s.tap;
}

__device__ __forceinline__ float mask_of(const float* mask, const Sample& s,
                                         const Geometry& geo) {
  if (mask == nullptr) return 1.0f;
  return mask[(((long long)s.b * geo.og + s.g) * geo.k2() + s.tap) * geo.l() +
              s.pos];
}

struct Bilinear {
  int idx[4];  // each corner's flat pixel y * W + x, -1 where invalid
  float hy, ly, hx, lx;
  bool inside;
};

__device__ __forceinline__ Bilinear bilinear(const float* offset,
                                             const Sample& s,
                                             const Geometry& geo) {
  const long long ch = offset_channel(s, geo);
  const float dy = offset[ch * geo.l() + s.pos];
  const float dx = offset[(ch + 1) * geo.l() + s.pos];
  const int oy = (int)(s.pos / geo.ow), ox = (int)(s.pos - (long long)oy * geo.ow);
  const int i = s.tap / geo.kw, j = s.tap - i * geo.kw;
  const float y = (float)(oy * geo.sh - geo.ph + i * geo.dh) + dy;
  const float x = (float)(ox * geo.sw - geo.pw + j * geo.dw) + dx;
  Bilinear out;
  out.inside = y > -1.0f && y < (float)geo.h && x > -1.0f && x < (float)geo.w;
  out.idx[0] = out.idx[1] = out.idx[2] = out.idx[3] = -1;
  out.hy = out.ly = out.hx = out.lx = 0.0f;
  if (!out.inside) return out;
  const int yl = (int)floorf(y), xl = (int)floorf(x);
  const int yh = yl + 1, xh = xl + 1;
  out.ly = y - (float)yl;
  out.lx = x - (float)xl;
  out.hy = 1.0f - out.ly;
  out.hx = 1.0f - out.lx;
  const bool vyl = yl >= 0, vyh = yh <= geo.h - 1;
  const bool vxl = xl >= 0, vxh = xh <= geo.w - 1;
  if (vyl && vxl) out.idx[0] = yl * geo.w + xl;
  if (vyl && vxh) out.idx[1] = yl * geo.w + xh;
  if (vyh && vxl) out.idx[2] = yh * geo.w + xl;
  if (vyh && vxh) out.idx[3] = yh * geo.w + xh;
  return out;
}

__device__ __forceinline__ float corner_weight(const Bilinear& s, int corner) {
  const float a = corner < 2 ? s.hy : s.ly;
  const float b = (corner & 1) ? s.lx : s.hx;
  return a * b;
}

__device__ __forceinline__ float widen(float v) { return v; }
__device__ __forceinline__ float widen(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

}  // namespace deform
