// The bilinear sample of a deformable convolution and the staged input
// window, shared by the forward kernel (deform_conv.cu) and the backward
// kernels (deform_conv_backward.cu), so that both see the same positions,
// corners and weights to the bit.
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
// Layouts: the input NCHW, as the caller holds it; offsets [N, 2 og K², OH,
// OW] (channel g 2K² + 2 tap + {0: dy, 1: dx}); mask [N, og K², OH, OW];
// columns and their gradient [N, OH, OW, K², C] (row (b L + pos) K² + tap,
// L = OH OW, channels g C/og .. of group g).
//
// The window: a block owns a tile of th x tw output positions (of one
// image and offset group) and stages, a chunk of kChunk channels at a
// time, the input pixels that the tile's samples read when every offset
// lies within `margin` px of zero: rows wy0 = oy0 sh - ph - margin ..,
// wr = (th - 1) sh + (kh - 1) dh + 2 margin + 1 of them, and the same in
// x; one more pixel, wr wc, holds zeros. Shared memory holds it channels
// last, kStride floats a pixel: a quarter-warp of 8 lanes reads a pixel's
// 32 channels as 8 16-byte loads without a bank conflict, and so do the
// staging stores of 8 consecutive pixels. A corner is coded once a tile:
// its pixel in the window, the zero pixel where the sample or the corner
// is invalid, or, for a valid corner outside the window (a larger offset),
// -1 - its pixel in the map, read from global memory. The host
// (ops/deform_conv.py:tile_plan) sizes the window, and shrinks the margin
// (to an empty window) where it would not fit.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace deform {

constexpr int kChunk = 32;           // channels staged at a time
constexpr int kStride = kChunk + 4;  // floats a window pixel

struct Geometry {
  int n, c, h, w, kh, kw, oh, ow, og, sh, sw, ph, pw, dh, dw;
  __host__ __device__ int k2() const { return kh * kw; }
  __host__ __device__ long long l() const { return (long long)oh * ow; }
  __host__ __device__ long long hw() const { return (long long)h * w; }
  __host__ __device__ int cg() const { return c / og; }
};

// a tile of output positions and its staged window (the host's plan)
struct Window {
  int th, tw;    // output rows and columns of a tile
  int margin;    // px staged around the tile's nominal footprint
  int wr, wc;    // the window's rows and columns (0 x 0: nothing staged)
  int tiles_x;   // tiles across the output's width
};

struct Corners {
  int yl, xl;     // the low corner; the high one is +1 in each axis
  bool valid[4];  // (yl, xl), (yl, xh), (yh, xl), (yh, xh)
  float hy, ly, hx, lx;
  bool inside;
};

// the sample of tap (i, j) at output (oy, ox) with offsets (dy, dx)
__device__ __forceinline__ Corners sample_at(float dy, float dx, int oy, int ox,
                                             int i, int j, const Geometry& geo) {
  const float y = (float)(oy * geo.sh - geo.ph + i * geo.dh) + dy;
  const float x = (float)(ox * geo.sw - geo.pw + j * geo.dw) + dx;
  Corners out;
  out.inside = y > -1.0f && y < (float)geo.h && x > -1.0f && x < (float)geo.w;
  out.yl = out.xl = 0;
  out.valid[0] = out.valid[1] = out.valid[2] = out.valid[3] = false;
  out.hy = out.ly = out.hx = out.lx = 0.0f;
  if (!out.inside) return out;
  const int yl = (int)floorf(y), xl = (int)floorf(x);
  out.yl = yl;
  out.xl = xl;
  out.ly = y - (float)yl;
  out.lx = x - (float)xl;
  out.hy = 1.0f - out.ly;
  out.hx = 1.0f - out.lx;
  const bool vyl = yl >= 0, vyh = yl + 1 <= geo.h - 1;
  const bool vxl = xl >= 0, vxh = xl + 1 <= geo.w - 1;
  out.valid[0] = vyl && vxl;
  out.valid[1] = vyl && vxh;
  out.valid[2] = vyh && vxl;
  out.valid[3] = vyh && vxh;
  return out;
}

// corner k's weight: hy hx, hy lx, ly hx, ly lx
__device__ __forceinline__ float corner_weight(const Corners& s, int k) {
  const float a = k < 2 ? s.hy : s.ly;
  const float b = (k & 1) ? s.lx : s.hx;
  return a * b;
}

__device__ __forceinline__ int corner_y(const Corners& s, int k) {
  return s.yl + (k >> 1);
}
__device__ __forceinline__ int corner_x(const Corners& s, int k) {
  return s.xl + (k & 1);
}

// corner k's code in the window whose top-left pixel is (wy0, wx0), times
// kStride where it lies in shared memory
__device__ __forceinline__ int corner_code(const Corners& s, int k, int wy0,
                                           int wx0, const Window& win,
                                           const Geometry& geo) {
  if (!s.valid[k]) return win.wr * win.wc * kStride;  // the zero pixel
  const int yy = corner_y(s, k), xx = corner_x(s, k);
  const int r = yy - wy0, c = xx - wx0;
  if (r >= 0 && r < win.wr && c >= 0 && c < win.wc)
    return (r * win.wc + c) * kStride;
  return -1 - (yy * geo.w + xx);
}

__device__ __forceinline__ float widen(float v) { return v; }
__device__ __forceinline__ float widen(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

// A lane's 4 channels of a corner: from the window (`win` at the lane's
// first channel of the chunk; channels past the chunk's read as its
// zeros), or, for a corner outside it, from the `avail` (<= 4) planes
// starting at `plane` in global memory (zero past them).
template <typename T>
__device__ __forceinline__ float4 corner_quad(int code, const float* win,
                                              const T* plane, long long hw,
                                              int avail) {
  if (code >= 0) return *reinterpret_cast<const float4*>(win + code);
  const T* src = plane + (-1 - code);
  float v[4];
#pragma unroll
  for (int e = 0; e < 4; ++e) v[e] = e < avail ? widen(src[e * hw]) : 0.0f;
  return make_float4(v[0], v[1], v[2], v[3]);
}

// Two horizontally adjacent elements of a plane as f32 (the pointer is
// aligned to both).
__device__ __forceinline__ float2 load_pair(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}
__device__ __forceinline__ float2 load_pair(const __nv_bfloat16* p) {
  const __nv_bfloat162 v = *reinterpret_cast<const __nv_bfloat162*>(p);
  return make_float2(__low2float(v), __high2float(v));
}

// Stage channels [0, cw) of the planes starting at `planes` (cw <= kChunk,
// plane stride hw) over the window at (wy0, wx0) into `win`, widened to
// f32, zeros in the chunk's channels past cw; pixels outside the map are
// left as they are (no valid corner reads them). A thread takes a pair of
// horizontally adjacent pixels and a quarter of the chunk's channels, its
// 8 loads in flight at once, each one 2-pixel vector where the pair lies in
// the map on a vector boundary: many short items keep more loads in flight
// than a few long ones at the registers the kernels can spare. Called by
// every thread of the block.
template <typename T>
__device__ __forceinline__ void stage_window(const T* __restrict__ planes,
                                             long long hw, int cw, int wy0,
                                             int wx0, const Window& w,
                                             const Geometry& geo, float* win) {
  constexpr int kPart = kChunk / 4;  // channels an item
  const int pairs_x = (w.wc + 1) / 2;
  const int items = 4 * w.wr * pairs_x;
  for (int item = threadIdx.x; item < items; item += blockDim.x) {
    const int k0 = kPart * (item & 3), pair = item >> 2;
    const int r = pair / pairs_x, c = 2 * (pair - r * pairs_x);
    const int gy = wy0 + r, gx = wx0 + c;
    if (gy < 0 || gy >= geo.h) continue;
    const bool in0 = gx >= 0 && gx < geo.w;
    const bool in1 = c + 1 < w.wc && gx + 1 >= 0 && gx + 1 < geo.w;
    if (!in0 && !in1) continue;
    const T* src = planes + (long long)gy * geo.w + gx + (long long)k0 * hw;
    const bool vec = in0 && in1 && hw % 2 == 0 &&
                     reinterpret_cast<uintptr_t>(src) % (2 * sizeof(T)) == 0;
    float v0[kPart], v1[kPart];
    if (vec) {
#pragma unroll
      for (int e = 0; e < kPart; ++e) {
        const float2 q = k0 + e < cw ? load_pair(src + e * hw)
                                     : make_float2(0.0f, 0.0f);
        v0[e] = q.x;
        v1[e] = q.y;
      }
    } else {
#pragma unroll
      for (int e = 0; e < kPart; ++e) {
        const bool live = k0 + e < cw;
        v0[e] = live && in0 ? widen(src[e * hw]) : 0.0f;
        v1[e] = live && in1 ? widen(src[e * hw + 1]) : 0.0f;
      }
    }
    float* dst = win + (r * w.wc + c) * kStride + k0;
#pragma unroll
    for (int e = 0; e < kPart; e += 4) {
      if (in0)
        *reinterpret_cast<float4*>(dst + e) =
            make_float4(v0[e], v0[e + 1], v0[e + 2], v0[e + 3]);
      if (in1)
        *reinterpret_cast<float4*>(dst + kStride + e) =
            make_float4(v1[e], v1[e + 1], v1[e + 2], v1[e + 3]);
    }
  }
}

// Zero the window's zero pixel (once a block; staging never writes it).
__device__ __forceinline__ void zero_pixel(const Window& w, float* win) {
  if (threadIdx.x < kStride / 4)
    reinterpret_cast<float4*>(win + w.wr * w.wc * kStride)[threadIdx.x] =
        make_float4(0.0f, 0.0f, 0.0f, 0.0f);
}

// shared-memory floats of a window and its zero pixel
__host__ __device__ __forceinline__ int window_floats(const Window& w) {
  return (w.wr * w.wc + 1) * kStride;
}

}  // namespace deform
