// The exact IoU test of the NMS kernels (nms.cu, nms_rowscan.cu).
//
// Suppress when IoU > thr strictly; union <= 0 gives IoU 0. Build with
// -fmad=false: the intersection, union and areas are the plain PyTorch
// version's expressions, each operation rounded on its own; the rounded
// quotient is compared with the threshold exactly, without dividing
// (Threshold below), so every keep mask agrees bit for bit.

#pragma once

#include <cuda_runtime.h>
#include <float.h>
#include <math.h>
#include <stdint.h>
#include <string.h>

namespace {

// fl(inter / uni) > thr for a float quotient rounded to nearest even,
// decided exactly without dividing: with m the midpoint between thr and the
// next float above it, the rounded quotient exceeds thr iff inter > m * uni,
// or inter == m * uni and thr's significand is odd (the tie rounds up).
// m has at most 25 significant bits and uni 24, so m * uni is exact in a
// double. uni <= 0 (or NaN) gives IoU 0, which exceeds thr iff 0 > thr.
struct Threshold {
  double mid;
  bool odd, zero_above;
};

inline Threshold make_threshold(float thr) {
  Threshold r;
  r.zero_above = 0.0f > thr;
  uint32_t bits;
  memcpy(&bits, &thr, sizeof bits);
  r.odd = bits & 1u;
  if (!(thr >= 0.0f) || thr == INFINITY) {
    // NaN: never above; +inf: never above; below 0: every quotient (>= 0)
    r.mid = thr < 0.0f ? -INFINITY : (thr == INFINITY ? INFINITY : NAN);
    r.odd = false;
    return r;
  }
  int e;
  frexp((double)thr, &e);  // thr = f * 2^e, f in [0.5, 1)
  const double ulp = thr >= FLT_MIN ? ldexp(1.0, e - 24) : ldexp(1.0, -149);
  r.mid = (double)thr + ulp / 2;
  return r;
}

// IoU(a, b) > thr for boxes as float4 (x1, y1, x2, y2), a the earlier. The
// areas are recomputed here with the expression the plain version stores.
__device__ __forceinline__ bool above(const float4& a, const float4& b,
                                      const Threshold& thr) {
  const float aarea = (a.z - a.x) * (a.w - a.y);
  const float barea = (b.z - b.x) * (b.w - b.y);
  const float w = fmaxf(fminf(a.z, b.z) - fmaxf(a.x, b.x), 0.0f);
  const float h = fmaxf(fminf(a.w, b.w) - fmaxf(a.y, b.y), 0.0f);
  const float inter = w * h;
  const float uni = (aarea + barea) - inter;
  const double x = inter, p = thr.mid * (double)uni;
  const bool hit = (x > p) | (thr.odd & (x == p));  // no branches
  return uni > 0.0f ? hit : thr.zero_above;
}

}  // namespace
