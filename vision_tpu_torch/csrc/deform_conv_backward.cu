// Deformable convolution backward: the gradients of the input, the
// offsets and the mask from the gradient of the columns, deterministic
// (no atomics: the same bits on every call).
//
// Replaces the XLA autodiff of vision_tpu/ops/deform_conv.py:88-151 (no
// pallas_call: XLA scatter-adds each corner's share into the input and
// reduces the offset and mask cotangents over the channels). On the card
// a scatter with atomics would add in an order that changes from run to
// run, and the offsets are arbitrary, so no output position owns an input
// pixel. The input's gradient is therefore gathered, not scattered:
//
//   keys     vt_deform_scatter_keys gives every corner of every sample
//            (4 N og K² OH OW of them) the flat index of the input pixel
//            it reads, (b og + g) H W + y W + x, or N og H W where the
//            sample or the corner is invalid; the wrapper sorts the keys
//            stably (torch.sort) and finds each pixel's range of corners
//            with torch.searchsorted (glue, as the port's top-k is);
//   input    one block takes 32 consecutive pixels of one (image, offset
//            group) and 128 channels of the group; a warp walks one
//            pixel's range in sorted order, recomputing each corner's
//            sample and weight (deform_sample.cuh, the forward's bits),
//            its lanes the channels (4 a lane), and sums
//            (g_cols m) w in f32; the block's sums go through shared
//            memory so that the stores run along the pixels of the NCHW
//            gradient, rounded once to the input's type; every pixel is
//            written, zeros included;
//   offsets  one warp a sample: its lanes take the group's channels, read
//            the four corners and g_cols, and sum g dv/dy, g dv/dx and (for
//            the mask) g v; a fixed shuffle tree reduces the lanes; the
//            offset gradients are those sums times the mask. As in JAX's
//            autodiff of the forward, floor carries no gradient, and an
//            invalid corner (or sample) gives zero.
//
// What bounds it: bytes. g_cols (as many as the columns: 260 MB a call at
// C3 at the 1344 canvas, batch 2, in f32) is read once by the offsets'
// pass and once a corner by the input's, the input once a corner; the
// corners' rows hit L2 mostly. The sort of the keys (2 M a call at C3) and
// the recomputed samples are the price of determinism without atomics.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "deform_sample.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kPixels = 32;  // pixels a block of the input's gradient
constexpr int kCPL = 4;      // channels a lane there
constexpr int kChannels = 32 * kCPL;

__global__ void __launch_bounds__(kThreads)
    keys_kernel(const float* __restrict__ offset, int* __restrict__ keys,
                deform::Geometry geo) {
  const long long t = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (t >= 4 * geo.samples()) return;
  const deform::Sample s = deform::decode(t >> 2, geo);
  const deform::Bilinear bl = deform::bilinear(offset, s, geo);
  const int idx = bl.idx[t & 3];
  const long long hw = (long long)geo.h * geo.w;
  keys[t] = idx >= 0 ? (int)(((long long)s.b * geo.og + s.g) * hw + idx)
                     : (int)((long long)geo.n * geo.og * hw);
}

__device__ __forceinline__ void store_elem(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_elem(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    input_grad_kernel(const float* __restrict__ offset,
                      const float* __restrict__ mask,
                      const float* __restrict__ gcols,
                      const long long* __restrict__ order,
                      const long long* __restrict__ starts,
                      T* __restrict__ grad_input, deform::Geometry geo) {
  __shared__ float tile[kChannels][kPixels + 1];
  const int bg = blockIdx.y;  // b * og + g
  const int b = bg / geo.og, g = bg - b * geo.og;
  const long long hw = (long long)geo.h * geo.w;
  const long long pix0 = (long long)blockIdx.x * kPixels;
  const int c0 = blockIdx.z * kChannels;
  const int cg = geo.cg();
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int p = warp; p < kPixels; p += kWarps) {
    float acc[kCPL];
#pragma unroll
    for (int k = 0; k < kCPL; ++k) acc[k] = 0.0f;
    if (pix0 + p < hw) {
      const long long key = (long long)bg * hw + pix0 + p;
      const long long end = starts[key + 1];
      for (long long j = starts[key]; j < end; ++j) {
        const long long t = order[j];
        const deform::Sample s = deform::decode(t >> 2, geo);
        const deform::Bilinear bl = deform::bilinear(offset, s, geo);
        const float wgt = deform::corner_weight(bl, (int)(t & 3));
        const float m = deform::mask_of(mask, s, geo);
        const float* row =
            gcols +
            (((long long)s.b * geo.l() + s.pos) * geo.k2() + s.tap) * geo.c +
            g * cg + c0;
#pragma unroll
        for (int k = 0; k < kCPL; ++k) {
          const int c = lane + 32 * k;
          if (c0 + c < cg) acc[k] = acc[k] + (row[c] * m) * wgt;
        }
      }
    }
#pragma unroll
    for (int k = 0; k < kCPL; ++k) tile[lane + 32 * k][p] = acc[k];
  }
  __syncthreads();
  for (int i = threadIdx.x; i < kChannels * kPixels; i += kThreads) {
    const int cl = i / kPixels, p = i - cl * kPixels;
    if (c0 + cl < cg && pix0 + p < hw)
      store_elem(grad_input + ((long long)b * geo.c + g * cg + c0 + cl) * hw +
                     pix0 + p,
                 tile[cl][p]);
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    offset_grad_kernel(const T* __restrict__ input,
                       const float* __restrict__ offset,
                       const float* __restrict__ mask,
                       const float* __restrict__ gcols,
                       float* __restrict__ grad_offset,
                       float* __restrict__ grad_mask, deform::Geometry geo) {
  const long long s_idx =
      (long long)blockIdx.x * kWarps + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (s_idx >= geo.samples()) return;
  const deform::Sample s = deform::decode(s_idx, geo);
  const deform::Bilinear bl = deform::bilinear(offset, s, geo);
  const int cg = geo.cg();
  float sy = 0.0f, sx = 0.0f, sm = 0.0f;
  if (bl.inside) {
    const float w0 = bl.hy * bl.hx, w1 = bl.hy * bl.lx;
    const float w2 = bl.ly * bl.hx, w3 = bl.ly * bl.lx;
    const T* src = input + (long long)s.b * geo.h * geo.w * geo.c + s.g * cg;
    const float* row =
        gcols + (((long long)s.b * geo.l() + s.pos) * geo.k2() + s.tap) * geo.c +
        s.g * cg;
    for (int c = lane; c < cg; c += 32) {
      float v[4];
#pragma unroll
      for (int k = 0; k < 4; ++k)
        v[k] = bl.idx[k] >= 0
                   ? deform::widen(src[(long long)bl.idx[k] * geo.c + c])
                   : 0.0f;
      const float gv = row[c];
      sy = sy + gv * ((v[2] - v[0]) * bl.hx + (v[3] - v[1]) * bl.lx);
      sx = sx + gv * ((v[1] - v[0]) * bl.hy + (v[3] - v[2]) * bl.ly);
      sm = sm + gv * (w0 * v[0] + w1 * v[1] + w2 * v[2] + w3 * v[3]);
    }
  }
#pragma unroll
  for (int d = 16; d > 0; d >>= 1) {
    sy += __shfl_xor_sync(0xffffffffu, sy, d);
    sx += __shfl_xor_sync(0xffffffffu, sx, d);
    sm += __shfl_xor_sync(0xffffffffu, sm, d);
  }
  if (lane == 0) {
    const float m = deform::mask_of(mask, s, geo);
    const long long ch = deform::offset_channel(s, geo);
    grad_offset[ch * geo.l() + s.pos] = sy * m;
    grad_offset[(ch + 1) * geo.l() + s.pos] = sx * m;
    if (grad_mask != nullptr)
      grad_mask[(((long long)s.b * geo.og + s.g) * geo.k2() + s.tap) *
                    geo.l() +
                s.pos] = sm;
  }
}

template <typename T>
void launch(const void* input, const float* offset, const float* mask,
            const float* gcols, const long long* order,
            const long long* starts, void* grad_input, float* grad_offset,
            float* grad_mask, const deform::Geometry& geo,
            cudaStream_t stream) {
  const long long hw = (long long)geo.h * geo.w;
  if (hw > 0 && geo.cg() > 0) {
    const dim3 grid((unsigned)((hw + kPixels - 1) / kPixels),
                    (unsigned)(geo.n * geo.og),
                    (unsigned)((geo.cg() + kChannels - 1) / kChannels));
    input_grad_kernel<T><<<grid, kThreads, 0, stream>>>(
        offset, mask, gcols, order, starts, static_cast<T*>(grad_input), geo);
  }
  if (geo.samples() > 0) {
    const long long blocks = (geo.samples() + kWarps - 1) / kWarps;
    offset_grad_kernel<T><<<(unsigned)blocks, kThreads, 0, stream>>>(
        static_cast<const T*>(input), offset, mask, gcols, grad_offset,
        grad_mask, geo);
  }
}

}  // namespace

// offset [N, 2 og K², OH, OW] f32 -> keys [4 N og K² OH OW] int32, each
// corner's flat input pixel or N og H W where it is invalid.
extern "C" int vt_deform_scatter_keys(const float* offset, int* keys, int n,
                                      int c, int h, int w, int kh, int kw,
                                      int oh, int ow, int og, int sh, int sw,
                                      int ph, int pw, int dh, int dw,
                                      void* stream) {
  const deform::Geometry geo{n, c, h, w, kh, kw, oh, ow, og,
                             sh, sw, ph, pw, dh, dw};
  const long long items = 4 * geo.samples();
  if (items == 0) return 0;
  keys_kernel<<<(unsigned)((items + kThreads - 1) / kThreads), kThreads, 0,
                static_cast<cudaStream_t>(stream)>>>(offset, keys, geo);
  return (int)cudaGetLastError();
}

// input [N, H, W, C] (f32, or bf16 where bf16 != 0), offset, mask (may be
// null) and gcols [N, OH, OW, K², C] f32; order: the stable sort's
// permutation of the keys (int64), starts: each pixel's first position in
// the sorted keys, N og H W + 1 of them (int64). Writes grad_input [N, C,
// H, W] in the input's type, grad_offset and grad_mask (where mask is not
// null) in f32. Returns cudaGetLastError() after the launches.
extern "C" int vt_deform_backward(const void* input, const float* offset,
                                  const float* mask, const float* gcols,
                                  const long long* order,
                                  const long long* starts, void* grad_input,
                                  float* grad_offset, float* grad_mask, int n,
                                  int c, int h, int w, int kh, int kw, int oh,
                                  int ow, int og, int sh, int sw, int ph,
                                  int pw, int dh, int dw, int bf16,
                                  void* stream) {
  const deform::Geometry geo{n, c, h, w, kh, kw, oh, ow, og,
                             sh, sw, ph, pw, dh, dw};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bf16)
    launch<__nv_bfloat16>(input, offset, mask, gcols, order, starts,
                          grad_input, grad_offset, grad_mask, geo, s);
  else
    launch<float>(input, offset, mask, gcols, order, starts, grad_input,
                  grad_offset, grad_mask, geo, s);
  return (int)cudaGetLastError();
}
