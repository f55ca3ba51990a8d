// Deformable convolution forward: the bilinear columns (im2col of the
// offset samples), channels last.
//
// Replaces vision_tpu/ops/deform_conv.py:88-151 (no pallas_call: there the
// TPU design gathers the whole column tensor four times, once a corner,
// with XLA gathers on the 128-lane channel axis, and feeds it to one MXU
// einsum). On the card the four corners of a sample are one gather pass:
//
//   warp     one sample (image, output position, tap, offset group): its
//            position, corners and weights computed once
//            (deform_sample.cuh), its channels in the lanes, 4 a lane as
//            one 16-byte (f32) or 8-byte (bf16) load a corner where the
//            group's width allows it;
//   output   columns [N, OH, OW, K², C] in f32, every element written
//            (zeros where the sample or a corner is invalid), the sum
//            w1 v1 + w2 v2 + w3 v3 + w4 v4 times the mask in the plain
//            version's order, built with -fmad=false so that the two
//            agree to the bit;
//   input    channels last, so that the lanes of a corner read consecutive
//            addresses, and a bf16 input is read as it lies and widened.
//
// What bounds it: the bytes of the columns it writes, K² times the input
// at the output's resolution (at the 1344 canvas, batch 2: 260 MB a call
// at C3, 130 MB at C4, 65 MB at C5, some 2 GB for the 13 calls of a
// ResNet-50 forward); the corners it reads hit L2 mostly, since
// neighbouring samples share them. The design writes each column once, in
// full rows of the group's channels. Its next step is not to write the
// columns at all: sample straight into shared-memory tiles that feed
// wgmma (an implicit GEMM).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "deform_sample.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

template <typename T, int VEC>
struct Vec;
template <>
struct Vec<float, 4> {
  __device__ static void load(const float* p, float* out) {
    const float4 v = *reinterpret_cast<const float4*>(p);
    out[0] = v.x; out[1] = v.y; out[2] = v.z; out[3] = v.w;
  }
};
template <>
struct Vec<__nv_bfloat16, 4> {
  __device__ static void load(const __nv_bfloat16* p, float* out) {
    const uint2 raw = *reinterpret_cast<const uint2*>(p);
    const __nv_bfloat162 a = *reinterpret_cast<const __nv_bfloat162*>(&raw.x);
    const __nv_bfloat162 b = *reinterpret_cast<const __nv_bfloat162*>(&raw.y);
    out[0] = __low2float(a); out[1] = __high2float(a);
    out[2] = __low2float(b); out[3] = __high2float(b);
  }
};
template <typename T>
struct Vec<T, 1> {
  __device__ static void load(const T* p, float* out) {
    out[0] = deform::widen(*p);
  }
};

template <int VEC>
__device__ __forceinline__ void store(float* p, const float* v) {
  if constexpr (VEC == 4) {
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  } else {
    p[0] = v[0];
  }
}

template <typename T, int VEC>
__global__ void __launch_bounds__(kThreads)
    im2col_kernel(const T* __restrict__ input, const float* __restrict__ offset,
                  const float* __restrict__ mask, float* __restrict__ cols,
                  deform::Geometry geo) {
  const long long s_idx =
      (long long)blockIdx.x * kWarps + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (s_idx >= geo.samples()) return;
  const deform::Sample s = deform::decode(s_idx, geo);
  const deform::Bilinear bl = deform::bilinear(offset, s, geo);
  const float m = deform::mask_of(mask, s, geo);
  const float w[4] = {bl.hy * bl.hx, bl.hy * bl.lx, bl.ly * bl.hx,
                      bl.ly * bl.lx};
  const int cg = geo.cg();
  const T* src = input + (long long)s.b * geo.h * geo.w * geo.c + s.g * cg;
  float* dst = cols +
               (((long long)s.b * geo.l() + s.pos) * geo.k2() + s.tap) * geo.c +
               s.g * cg;
  for (int c = lane * VEC; c < cg; c += 32 * VEC) {
    float v[4][VEC];
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      if (bl.idx[k] >= 0) {
        Vec<T, VEC>::load(src + (long long)bl.idx[k] * geo.c + c, v[k]);
      } else {
#pragma unroll
        for (int e = 0; e < VEC; ++e) v[k][e] = 0.0f;
      }
    }
    float out[VEC];
#pragma unroll
    for (int e = 0; e < VEC; ++e) {
      float acc = w[0] * v[0][e];
      acc = acc + w[1] * v[1][e];
      acc = acc + w[2] * v[2][e];
      acc = acc + w[3] * v[3][e];
      out[e] = mask != nullptr ? acc * m : acc;
    }
    store<VEC>(dst + c, out);
  }
}

template <typename T>
void launch(const void* input, const float* offset, const float* mask,
            float* cols, const deform::Geometry& geo, cudaStream_t stream) {
  const long long blocks = (geo.samples() + kWarps - 1) / kWarps;
  const T* in = static_cast<const T*>(input);
  // 4 channels a lane where every row of the group starts on a 4-element
  // boundary (the buffers themselves are allocated aligned)
  if (geo.cg() % 4 == 0 && geo.c % 4 == 0)
    im2col_kernel<T, 4><<<(unsigned)blocks, kThreads, 0, stream>>>(
        in, offset, mask, cols, geo);
  else
    im2col_kernel<T, 1><<<(unsigned)blocks, kThreads, 0, stream>>>(
        in, offset, mask, cols, geo);
}

}  // namespace

// input [N, H, W, C] (f32, or bf16 where bf16 != 0), offset and mask f32
// (mask may be null), cols [N, OH, OW, KH*KW, C] f32. Returns
// cudaGetLastError() after the launch.
extern "C" int vt_deform_im2col(const void* input, const float* offset,
                                const float* mask, float* cols, int n, int c,
                                int h, int w, int kh, int kw, int oh, int ow,
                                int og, int sh, int sw, int ph, int pw, int dh,
                                int dw, int bf16, void* stream) {
  const deform::Geometry geo{n, c, h, w, kh, kw, oh, ow, og,
                             sh, sw, ph, pw, dh, dw};
  if (geo.samples() == 0 || c == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bf16)
    launch<__nv_bfloat16>(input, offset, mask, cols, geo, s);
  else
    launch<float>(input, offset, mask, cols, geo, s);
  return (int)cudaGetLastError();
}
