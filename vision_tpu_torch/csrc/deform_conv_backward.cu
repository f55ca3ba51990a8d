// Deformable convolution backward: the gradients of the input, the
// offsets and the mask from the gradient of the columns, deterministic
// (no atomics: the same bits on every call).
//
// Replaces the XLA autodiff of vision_tpu/ops/deform_conv.py:88-151 (no
// pallas_call: XLA scatter-adds each corner's share into the input and
// reduces the offset and mask cotangents over the channels). On the card
// a scatter with atomics would add in an order that changes from run to
// run, and the offsets are arbitrary, so no output position owns an input
// pixel. The input's gradient is therefore gathered, not scattered.
//
// What bounds it: bytes. g_cols (as many as the columns: 260 MB a call at
// C3 at the 1344 canvas, batch 2, in f32; 2.0 GB a train step) must be read
// once for the offsets and once for the input, whose gather reads each row
// once a corner, four times, mostly from L2. The passes:
//
//   keys     vt_deform_scatter_keys, a thread a sample, the samples ordered
//            (b, g, tap, pos) so that the offsets and the mask are read
//            along pos and the keys and records written in whole vectors:
//            each corner t = 4 s + k gets a key, the flat index
//            (b og + g) H W + y W + x of the input pixel it reads (or
//            N og H W where the sample or the corner is invalid), and a
//            record, its g_cols row (b L + pos) K² + tap and its weight
//            times the mask (f32); the wrapper sorts the keys stably
//            (torch.sort) and finds each pixel's range of corners with
//            torch.searchsorted (glue, as the port's top-k is);
//   records  the records put in sorted order once, a coalesced pass over
//            the sort's permutation;
//   input    a block takes a 4 x 8 tile of pixels of one (image, offset
//            group), a warp a column of it, a pixel at a time: the four
//            pixels' ranges come in one load, and the next pixel's first
//            records are loaded while this one is summed; the warp reads a
//            pixel's records 32 at a time in one load and hands each out by
//            __shfl_sync, keeps several g_cols rows in flight (16-byte
//            loads, 4 channels a lane, up to 256 channels a lane set, so a
//            range is walked once for C <= 256), and sums g_cols · (w m) in
//            f32 in sorted order, with no recompute; the block's sums go
//            through shared memory so that the stores run along the pixels
//            of the NCHW gradient, rounded once to the input's type; every
//            pixel is written, zeros included. A pixel's range has no
//            bound: a pile-up of thousands of corners is walked in full.
//            (Keyed by 2 x 2 quads of pixels instead, a warp loading a
//            sample's row once for all its corners in the quad, the pass
//            was slower: a warp's walk is four times as long);
//   offsets  a block of 16 warps takes the forward's tile of 4 x 8 output
//            positions (of one image and offset group), up to 9 taps and a
//            range of channel chunks, and stages the input window of each
//            chunk of 32 channels as the forward does (NCHW read as it
//            lies, deform_sample.cuh), the chunk's g_cols copied to shared
//            memory (cp.async) while the window is staged; a warp instruction
//            covers 4 samples, a lane 4 of the chunk's channels (16-byte
//            reads of both), and each lane keeps, for its 5 samples, the
//            running sums S_k = sum of g v_k over its channels, one a
//            corner, in registers across the chunks (2 operations an
//            element and corner, where the gradients' own formulas take
//            about 6); a fixed shuffle tree sums each sample's 8 lanes at the
//            end, where the gradients follow from the four sums:
//            g dv/dy = hx (S_2 - S_0) + lx (S_3 - S_1), g dv/dx =
//            hy (S_1 - S_0) + ly (S_3 - S_2), and g v = hy hx S_0 +
//            hy lx S_1 + ly hx S_2 + ly lx S_3 (the same sums in another
//            order: their error is f32's on the terms' magnitudes). Where
//            the tiles alone would not fill the card (C4, C5), the channels
//            are split over several blocks, which write their four sums to
//            scratch, and a last pass adds the splits in order. The offset
//            gradients are those times the mask. As in JAX's autodiff of
//            the forward, floor carries no gradient, and an invalid corner
//            (or sample) gives zero.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "deform_sample.cuh"

namespace {

using deform::kChunk;

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kTileY = 4, kTileX = 8;  // pixels of an input-gradient block
constexpr int kPixels = kTileY * kTileX;
constexpr int kMaxPass = 256;          // channels a pass of the input sum
constexpr int kTaps = 9;               // taps an offsets block
constexpr int kOffWarps = 16;          // warps an offsets block
constexpr int kOffThreads = 32 * kOffWarps;
// sample groups of 4 a warp there, for a tile of 32 positions
constexpr int kIters = (32 * kTaps / 4 + kOffWarps - 1) / kOffWarps;

__global__ void __launch_bounds__(kThreads)
    keys_kernel(const float* __restrict__ offset, const float* __restrict__ mask,
                int4* __restrict__ keys, int4* __restrict__ recs,
                deform::Geometry geo) {
  const long long L = geo.l();
  const long long s = (long long)blockIdx.x * kThreads + threadIdx.x;
  const int k2 = geo.k2();
  const long long samples = (long long)geo.n * geo.og * k2 * L;
  if (s >= samples) return;
  // s = ((b og + g) K² + tap) L + pos
  const long long bgt = s / L;
  const int pos = (int)(s - bgt * L);
  const int bg = (int)(bgt / k2), tap = (int)(bgt - (long long)bg * k2);
  const int b = bg / geo.og;
  const int oy = pos / geo.ow, ox = pos - oy * geo.ow;
  const int i = tap / geo.kw, j = tap - i * geo.kw;
  const long long ch = (long long)bg * 2 * k2 + 2 * tap;
  const deform::Corners cs = deform::sample_at(
      offset[ch * L + pos], offset[(ch + 1) * L + pos], oy, ox, i, j, geo);
  const float m = mask != nullptr ? mask[bgt * L + pos] : 1.0f;
  const long long hw = geo.hw();
  const int none = (int)((long long)geo.n * geo.og * hw);
  const int row = (int)(((long long)b * L + pos) * k2 + tap);
  int key[4], rec[8];
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const bool valid = cs.valid[k];
    key[k] = valid ? (int)((long long)bg * hw +
                           deform::corner_y(cs, k) * geo.w +
                           deform::corner_x(cs, k))
                   : none;
    const float w = deform::corner_weight(cs, k);
    rec[2 * k] = valid ? row : 0;
    rec[2 * k + 1] = __float_as_int(valid ? (mask != nullptr ? w * m : w) : 0.0f);
  }
  keys[s] = make_int4(key[0], key[1], key[2], key[3]);
  recs[2 * s] = make_int4(rec[0], rec[1], rec[2], rec[3]);
  recs[2 * s + 1] = make_int4(rec[4], rec[5], rec[6], rec[7]);
}

__global__ void __launch_bounds__(kThreads)
    sort_records_kernel(const long long* __restrict__ order,
                        const int2* __restrict__ recs, int2* __restrict__ out,
                        long long items) {
  const long long t = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (t < items) out[t] = recs[order[t]];
}

__device__ __forceinline__ void store_elem(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_elem(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

// the channels of a lane: VEC = 4: c_base + 128 k + 4 lane + e (16-byte
// loads), VEC = 1: c_base + 32 k + lane; NV of them, kMaxPass at most
template <int VEC>
__device__ __forceinline__ int lane_channel(int k, int e, int lane) {
  return VEC == 4 ? 128 * k + 4 * lane + e : 32 * k + lane;
}

template <typename T, int VEC, int NV>
__global__ void __launch_bounds__(kThreads, 4)
    input_grad_kernel(const float* __restrict__ gcols,
                      const int2* __restrict__ recs,
                      const int* __restrict__ starts,
                      T* __restrict__ grad_input, deform::Geometry geo,
                      int tiles_x) {
  constexpr int kSpan = 32 * VEC * NV;  // channels a pass
  constexpr int kAhead = 8 / NV;        // records in flight
  constexpr int kPerWarp = kPixels / kWarps;
  static_assert(kSpan <= kMaxPass, "a pass's sums live in registers");
  static_assert(kTileX == kWarps, "a warp takes a column of the tile");
  __shared__ float tile[kSpan][kPixels + 1];
  const int bg = blockIdx.y;  // b * og + g
  const int b = bg / geo.og, g = bg - b * geo.og;
  const int ty = blockIdx.x / tiles_x, tx = blockIdx.x - ty * tiles_x;
  const long long hw = geo.hw();
  const int cg = geo.cg();
  const int c_base = blockIdx.z * kSpan;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const float* gbase = gcols + g * cg + c_base;
  // the warp's pixels p = warp + kWarps j, j < kPerWarp (a column of the
  // tile): lane j holds pixel j's first record, lane kPerWarp + j its end
  // (an empty range off the map)
  int bound = 0;
  if (lane < 2 * kPerWarp) {
    const int j = lane % kPerWarp;
    const int y = ty * kTileY + j, x = tx * kTileX + warp;
    if (y < geo.h && x < geo.w)
      bound = starts[(long long)bg * hw + (long long)y * geo.w + x +
                     (lane >= kPerWarp)];
  }
  int first = __shfl_sync(0xffffffffu, bound, 0);
  int last = __shfl_sync(0xffffffffu, bound, kPerWarp);
  // the first 32 records of the next pixel, loaded while this one is summed
  int2 next = lane < last - first ? recs[first + lane] : make_int2(0, 0);
#pragma unroll 1
  for (int j = 0; j < kPerWarp; ++j) {
    const int p = warp + kWarps * j;
    const int start = first, end = last;
    int2 mine = next;
    if (j + 1 < kPerWarp) {
      first = __shfl_sync(0xffffffffu, bound, j + 1);
      last = __shfl_sync(0xffffffffu, bound, kPerWarp + j + 1);
      next = lane < last - first ? recs[first + lane] : make_int2(0, 0);
    }
    float acc[NV][VEC];
#pragma unroll
    for (int k = 0; k < NV; ++k)
#pragma unroll
      for (int e = 0; e < VEC; ++e) acc[k][e] = 0.0f;
    for (int base = start; base < end; base += 32) {
      const int count = min(32, end - base);
      if (base != start)
        mine = lane < count ? recs[base + lane] : make_int2(0, 0);
      for (int j0 = 0; j0 < count; j0 += kAhead) {
        float v[kAhead][NV][VEC];
        float wm[kAhead];
#pragma unroll
        for (int u = 0; u < kAhead; ++u) {
          const int row = __shfl_sync(0xffffffffu, mine.x, j0 + u);
          wm[u] = __int_as_float(__shfl_sync(0xffffffffu, mine.y, j0 + u));
          const float* src = gbase + (long long)row * geo.c;
#pragma unroll
          for (int k = 0; k < NV; ++k) {
            const int c = lane_channel<VEC>(k, 0, lane);
            const bool live = j0 + u < count && c_base + c < cg;
            if constexpr (VEC == 4) {
              const float4 q =
                  live ? __ldg(reinterpret_cast<const float4*>(src + c))
                       : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
              v[u][k][0] = q.x;
              v[u][k][1] = q.y;
              v[u][k][2] = q.z;
              v[u][k][3] = q.w;
            } else {
              v[u][k][0] = live ? __ldg(src + c) : 0.0f;
            }
          }
        }
#pragma unroll
        for (int u = 0; u < kAhead; ++u) {
          if (j0 + u >= count) break;  // the same for the whole warp
#pragma unroll
          for (int k = 0; k < NV; ++k)
#pragma unroll
            for (int e = 0; e < VEC; ++e)
              acc[k][e] = acc[k][e] + v[u][k][e] * wm[u];
        }
      }
    }
#pragma unroll
    for (int k = 0; k < NV; ++k)
#pragma unroll
      for (int e = 0; e < VEC; ++e)
        tile[lane_channel<VEC>(k, e, lane)][p] = acc[k][e];
  }
  __syncthreads();
  for (int i = threadIdx.x; i < kSpan * kPixels; i += kThreads) {
    const int cl = i / kPixels, p = i - cl * kPixels;
    const int y = ty * kTileY + p / kTileX, x = tx * kTileX + p % kTileX;
    if (c_base + cl < cg && y < geo.h && x < geo.w)
      store_elem(grad_input + ((long long)b * geo.c + g * cg + c_base + cl) * hw +
                     (long long)y * geo.w + x,
                 tile[cl][p]);
  }
}

// shared memory of an offsets block: the window, and a sample's corner
// codes, (hy, ly, hx, lx) and its chunk of g_cols
size_t offset_smem_bytes(const deform::Window& w) {
  const int ns = w.th * w.tw * kTaps;
  return (size_t)deform::window_floats(w) * 4 +
         (size_t)ns * (sizeof(int4) + sizeof(float4) + kChunk * 4);
}

// 16 bytes from global to shared memory without registers (cp.async), and
// the wait for all of this thread's copies
__device__ __forceinline__ void copy_async16(float* smem, const float* gmem) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst),
               "l"(gmem));
}
__device__ __forceinline__ void wait_async_copies() {
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::
                   : "memory");
}

// A sample's offset and mask gradients from its four sums S_k = sum over
// the channels of g v_k, and its fractions f = (hy, ly, hx, lx).
struct OffsetGrads {
  float dy, dx, dm;
};
__device__ __forceinline__ OffsetGrads offset_grads(const float* S, float4 f) {
  OffsetGrads out;
  out.dy = (S[2] - S[0]) * f.z + (S[3] - S[1]) * f.w;
  out.dx = (S[1] - S[0]) * f.x + (S[3] - S[2]) * f.y;
  out.dm = f.x * f.z * S[0] + f.x * f.w * S[1] + f.y * f.z * S[2] +
           f.y * f.w * S[3];
  return out;
}

// VEC: the channels of every group start on 16-byte boundaries, so a lane
// reads its 4 g_cols values as one float4. With `partial` the block's four
// sums over its chunks go there, [split][4][samples] (the sample index of
// keys_kernel), for finish_kernel; without, they give the gradients.
template <typename T, bool VEC>
__global__ void __launch_bounds__(kOffThreads, 2)
    offset_grad_kernel(const T* __restrict__ input,
                       const float* __restrict__ offset,
                       const float* __restrict__ mask,
                       const float* __restrict__ gcols,
                       float* __restrict__ grad_offset,
                       float* __restrict__ grad_mask,
                       float* __restrict__ partial, deform::Geometry geo,
                       deform::Window wp, int splits, int chunks_per_split) {
  extern __shared__ float4 smem4[];
  float* win = reinterpret_cast<float*>(smem4);
  const int tp = wp.th * wp.tw;
  int4* codes = reinterpret_cast<int4*>(win + deform::window_floats(wp));
  float4* fr = reinterpret_cast<float4*>(codes + tp * kTaps);
  float* gbuf = reinterpret_cast<float*>(fr + tp * kTaps);  // [sample][kChunk]

  const int bg = blockIdx.y, b = bg / geo.og, g = bg - b * geo.og;
  const int ty = blockIdx.x / wp.tiles_x, tx = blockIdx.x - ty * wp.tiles_x;
  const int oy0 = ty * wp.th, ox0 = tx * wp.tw;
  const int wy0 = oy0 * geo.sh - geo.ph - wp.margin;
  const int wx0 = ox0 * geo.sw - geo.pw - wp.margin;
  const int k2 = geo.k2(), cg = geo.cg();
  const int split = blockIdx.z % splits;
  const int t0 = blockIdx.z / splits * kTaps, nt = min(kTaps, k2 - t0);
  const int ns = tp * nt;
  const int c_end = min(cg, (split + 1) * chunks_per_split * kChunk);
  const long long L = geo.l(), hw = geo.hw();
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int sub = lane >> 3, cq = 4 * (lane & 7);
  deform::zero_pixel(wp, win);

  // records: s = tap * tp + p, consecutive threads on consecutive positions
  for (int s = threadIdx.x; s < ns; s += kOffThreads) {
    const int tl = s / tp, p = s - tl * tp, tap = t0 + tl;
    const int py = p / wp.tw, oy = oy0 + py, ox = ox0 + p - py * wp.tw;
    const int zero = wp.wr * wp.wc * deform::kStride;
    int4 code = make_int4(zero, zero, zero, zero);
    float4 f = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    if (oy < geo.oh && ox < geo.ow) {
      const long long pos = (long long)oy * geo.ow + ox;
      const long long ch = (long long)bg * 2 * k2 + 2 * tap;
      const int i = tap / geo.kw, j = tap - i * geo.kw;
      const deform::Corners cs = deform::sample_at(
          offset[ch * L + pos], offset[(ch + 1) * L + pos], oy, ox, i, j, geo);
      code = make_int4(deform::corner_code(cs, 0, wy0, wx0, wp, geo),
                       deform::corner_code(cs, 1, wy0, wx0, wp, geo),
                       deform::corner_code(cs, 2, wy0, wx0, wp, geo),
                       deform::corner_code(cs, 3, wy0, wx0, wp, geo));
      f = make_float4(cs.hy, cs.ly, cs.hx, cs.lx);
    }
    codes[s] = code;
    fr[s] = f;
  }

  // a lane's samples: s_i = 4 (i kOffWarps + warp) + sub, i < kIters, the same
  // in every chunk; its g_cols row, or -1 off the output
  int grow[kIters];
#pragma unroll
  for (int i = 0; i < kIters; ++i) {
    const int s = 4 * (i * kOffWarps + warp) + sub;
    const int tl = s / tp, p = s - tl * tp;
    const int py = p / wp.tw, oy = oy0 + py, ox = ox0 + p - py * wp.tw;
    grow[i] = s < ns && oy < geo.oh && ox < geo.ow
                  ? (int)(((long long)b * L + (long long)oy * geo.ow + ox) * k2 +
                          t0 + tl)
                  : -1;
  }
  float S[kIters][4];  // each sample's sum of g v_k, k a corner
#pragma unroll
  for (int i = 0; i < kIters; ++i)
#pragma unroll
    for (int k = 0; k < 4; ++k) S[i][k] = 0.0f;

  for (int c0 = split * chunks_per_split * kChunk; c0 < c_end; c0 += kChunk) {
    const int cw = min(kChunk, cg - c0);
    const int avail = max(0, min(4, cw - cq));
    __syncthreads();  // the records are written; the last window is read
    // the chunk's g_cols of the lane's samples, copied while the window is
    // staged
    const float* gbase = gcols + g * cg + c0 + cq;
#pragma unroll
    for (int i = 0; i < kIters; ++i) {
      if (grow[i] < 0 || avail == 0) continue;
      const float* src = gbase + (long long)grow[i] * geo.c;
      float* dst = gbuf + (4 * (i * kOffWarps + warp) + sub) * kChunk + cq;
      if (VEC) {
        copy_async16(dst, src);
      } else {
#pragma unroll
        for (int e = 0; e < 4; ++e) dst[e] = e < avail ? src[e] : 0.0f;
      }
    }
    const long long plane0 = (long long)b * geo.c + g * cg + c0;
    deform::stage_window(input + plane0 * hw, hw, cw, wy0, wx0, wp, geo, win);
    wait_async_copies();
    __syncthreads();
    if (avail == 0) continue;
    const T* plane = input + (plane0 + cq) * hw;
    const float* wl = win + cq;
#pragma unroll
    for (int i = 0; i < kIters; ++i) {
      if (grow[i] < 0) continue;
      const int s = 4 * (i * kOffWarps + warp) + sub;
      const float4 gq = *reinterpret_cast<const float4*>(gbuf + s * kChunk + cq);
      const float gv[4] = {gq.x, gq.y, gq.z, gq.w};
      const int4 code = codes[s];
      const float4 q[4] = {deform::corner_quad(code.x, wl, plane, hw, avail),
                           deform::corner_quad(code.y, wl, plane, hw, avail),
                           deform::corner_quad(code.z, wl, plane, hw, avail),
                           deform::corner_quad(code.w, wl, plane, hw, avail)};
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        S[i][k] = S[i][k] + gv[0] * q[k].x;
        S[i][k] = S[i][k] + gv[1] * q[k].y;
        S[i][k] = S[i][k] + gv[2] * q[k].z;
        S[i][k] = S[i][k] + gv[3] * q[k].w;
      }
    }
  }
  // each sample's 8 lanes summed by a fixed tree: all 8 end with the same
  // bits; the first of them writes
#pragma unroll
  for (int i = 0; i < kIters; ++i)
#pragma unroll
    for (int d = 1; d < 8; d <<= 1)
#pragma unroll
      for (int k = 0; k < 4; ++k)
        S[i][k] += __shfl_xor_sync(0xffffffffu, S[i][k], d);
  if (cq != 0) return;
  const long long samples = (long long)geo.n * geo.og * k2 * L;
#pragma unroll
  for (int i = 0; i < kIters; ++i) {
    if (grow[i] < 0) continue;
    const int s = 4 * (i * kOffWarps + warp) + sub;
    const int tl = s / tp, p = s - tl * tp, tap = t0 + tl;
    const int py = p / wp.tw;
    const long long pos = (long long)(oy0 + py) * geo.ow + ox0 + p - py * wp.tw;
    const long long si = ((long long)bg * k2 + tap) * L + pos;
    if (partial != nullptr) {
      float* out = partial + (long long)split * 4 * samples + si;
#pragma unroll
      for (int k = 0; k < 4; ++k) out[k * samples] = S[i][k];
      continue;
    }
    const OffsetGrads d = offset_grads(S[i], fr[s]);
    const float m = mask != nullptr ? mask[si] : 1.0f;
    const long long ch = (long long)bg * 2 * k2 + 2 * tap;
    grad_offset[ch * L + pos] = mask != nullptr ? d.dy * m : d.dy;
    grad_offset[(ch + 1) * L + pos] = mask != nullptr ? d.dx * m : d.dx;
    if (grad_mask != nullptr) grad_mask[si] = d.dm;
  }
}

// the splits' four sums of each sample added in order, and the offsets'
// and the mask's gradients from them (the sample recomputed to the bit)
__global__ void __launch_bounds__(kThreads)
    finish_kernel(const float* __restrict__ partial,
                  const float* __restrict__ offset,
                  const float* __restrict__ mask, float* __restrict__ grad_offset,
                  float* __restrict__ grad_mask, deform::Geometry geo,
                  int splits) {
  const long long L = geo.l();
  const int k2 = geo.k2();
  const long long samples = (long long)geo.n * geo.og * k2 * L;
  const long long si = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (si >= samples) return;
  float S[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) S[k] = partial[k * samples + si];
  for (int sp = 1; sp < splits; ++sp) {
    const float* p = partial + (long long)sp * 4 * samples + si;
#pragma unroll
    for (int k = 0; k < 4; ++k) S[k] = S[k] + p[k * samples];
  }
  // si = (bg K² + tap) L + pos: its offset channels are 2 (bg K² + tap), + 1
  const long long bgt = si / L;
  const int pos = (int)(si - bgt * L), tap = (int)(bgt % k2);
  const int oy = pos / geo.ow, ox = pos - oy * geo.ow;
  const int i = tap / geo.kw, j = tap - i * geo.kw;
  const deform::Corners cs = deform::sample_at(
      offset[2 * bgt * L + pos], offset[(2 * bgt + 1) * L + pos], oy, ox, i, j,
      geo);
  const OffsetGrads d =
      offset_grads(S, make_float4(cs.hy, cs.ly, cs.hx, cs.lx));
  const float m = mask != nullptr ? mask[si] : 1.0f;
  grad_offset[2 * bgt * L + pos] = mask != nullptr ? d.dy * m : d.dy;
  grad_offset[(2 * bgt + 1) * L + pos] = mask != nullptr ? d.dx * m : d.dx;
  if (grad_mask != nullptr) grad_mask[si] = d.dm;
}

template <typename T, int VEC, int NV>
int launch_input(const float* gcols, const int2* recs, const int* starts,
                 void* grad_input, const deform::Geometry& geo,
                 cudaStream_t stream) {
  const int tiles_x = (geo.w + kTileX - 1) / kTileX;
  const int tiles_y = (geo.h + kTileY - 1) / kTileY;
  const int span = 32 * VEC * NV;
  const dim3 grid((unsigned)(tiles_x * tiles_y), (unsigned)(geo.n * geo.og),
                  (unsigned)((geo.cg() + span - 1) / span));
  input_grad_kernel<T, VEC, NV><<<grid, kThreads, 0, stream>>>(
      gcols, recs, starts, static_cast<T*>(grad_input), geo, tiles_x);
  return (int)cudaGetLastError();
}

template <typename T, bool VEC>
int launch_offsets(const void* input, const float* offset, const float* mask,
                   const float* gcols, float* grad_offset, float* grad_mask,
                   float* partial, const deform::Geometry& geo,
                   const deform::Window& wp, int tiles_y, int splits,
                   cudaStream_t stream) {
  const size_t smem = offset_smem_bytes(wp);
  cudaError_t err = cudaFuncSetAttribute(
      offset_grad_kernel<T, VEC>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int chunks = (geo.cg() + kChunk - 1) / kChunk;
  const int per_split = (chunks + splits - 1) / splits;
  splits = (chunks + per_split - 1) / per_split;
  const dim3 grid((unsigned)(wp.tiles_x * tiles_y), (unsigned)(geo.n * geo.og),
                  (unsigned)((geo.k2() + kTaps - 1) / kTaps * splits));
  offset_grad_kernel<T, VEC><<<grid, kOffThreads, smem, stream>>>(
      static_cast<const T*>(input), offset, mask, gcols, grad_offset, grad_mask,
      splits > 1 ? partial : nullptr, geo, wp, splits, per_split);
  if (splits > 1) {
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    const long long samples = (long long)geo.n * geo.og * geo.k2() * geo.l();
    finish_kernel<<<(unsigned)((samples + kThreads - 1) / kThreads), kThreads,
                    0, stream>>>(partial, offset, mask, grad_offset, grad_mask,
                                 geo, splits);
  }
  return (int)cudaGetLastError();
}

template <typename T>
int launch(const void* input, const float* offset, const float* mask,
           const float* gcols, const long long* order, const int2* recs,
           int2* sorted, const int* starts, void* grad_input,
           float* grad_offset, float* grad_mask, float* partial,
           const deform::Geometry& geo, const deform::Window& wp, int tiles_y,
           int splits, cudaStream_t stream) {
  const long long items = 4LL * geo.n * geo.og * geo.k2() * geo.l();
  // 16-byte loads where every row of the group starts on a 16-byte
  // boundary (the buffers themselves are allocated aligned)
  const bool vec = geo.cg() % 4 == 0 && geo.c % 4 == 0;
  if (items > 0) {
    sort_records_kernel<<<(unsigned)((items + kThreads - 1) / kThreads),
                          kThreads, 0, stream>>>(order, recs, sorted, items);
    const int err = (int)cudaGetLastError();
    if (err) return err;
  }
  if (geo.hw() > 0 && geo.cg() > 0) {
    const int err =
        !vec ? launch_input<T, 1, 4>(gcols, sorted, starts, grad_input, geo, stream)
        : geo.cg() <= 128
            ? launch_input<T, 4, 1>(gcols, sorted, starts, grad_input, geo, stream)
            : launch_input<T, 4, 2>(gcols, sorted, starts, grad_input, geo, stream);
    if (err) return err;
  }
  if (items > 0)
    return vec ? launch_offsets<T, true>(input, offset, mask, gcols, grad_offset,
                                         grad_mask, partial, geo, wp, tiles_y,
                                         splits, stream)
               : launch_offsets<T, false>(input, offset, mask, gcols,
                                          grad_offset, grad_mask, partial, geo,
                                          wp, tiles_y, splits, stream);
  return 0;
}

}  // namespace

// offset [N, 2 og K², OH, OW] and mask [N, og K², OH, OW] (may be null) f32
// -> keys [4 N og K² OH OW] int32, each corner's flat input pixel or
// N og H W where it is invalid, and recs [4 N og K² OH OW] of (int32 g_cols
// row, f32 weight times mask; 0, 0 where invalid); corner
// t = 4 (((b og + g) K² + tap) OH OW + pos) + k.
// Returns the CUDA error of the launch (0 if none).
extern "C" int vt_deform_scatter_keys(const float* offset, const float* mask,
                                      int* keys, int* recs, int n, int c,
                                      int h, int w, int kh, int kw, int oh,
                                      int ow, int og, int sh, int sw, int ph,
                                      int pw, int dh, int dw, void* stream) {
  const deform::Geometry geo{n, c, h, w, kh, kw, oh, ow, og,
                             sh, sw, ph, pw, dh, dw};
  const long long samples = (long long)n * og * geo.k2() * geo.l();
  if (samples == 0) return 0;
  keys_kernel<<<(unsigned)((samples + kThreads - 1) / kThreads), kThreads, 0,
                static_cast<cudaStream_t>(stream)>>>(
      offset, mask, reinterpret_cast<int4*>(keys), reinterpret_cast<int4*>(recs),
      geo);
  return (int)cudaGetLastError();
}

// input [N, C, H, W] (f32, or bf16 where bf16 != 0), offset, mask (may be
// null) and gcols [N, OH, OW, K², C] f32; order: the stable sort's
// permutation of the keys (int64); recs: vt_deform_scatter_keys's
// records; sorted: scratch for them in sorted order (as many); starts:
// each pixel's first position in the sorted keys, N og H W + 1 of them
// (int32); partial: scratch of 4 splits N og K² OH OW floats where splits
// > 1. The offsets' tile (th x tw <= 32 positions), window and channel
// splits are the host's plan (ops/deform_conv.py:tile_plan). Writes
// grad_input [N, C, H, W] in the input's type, grad_offset and grad_mask
// (where mask is not null) in f32. Returns the first CUDA error of the
// launches (0 if none).
extern "C" int vt_deform_backward(const void* input, const float* offset,
                                  const float* mask, const float* gcols,
                                  const long long* order, const int* recs,
                                  int* sorted, const int* starts,
                                  void* grad_input, float* grad_offset,
                                  float* grad_mask, float* partial, int n,
                                  int c, int h, int w, int kh, int kw, int oh,
                                  int ow, int og, int sh, int sw, int ph,
                                  int pw, int dh, int dw, int th, int tw,
                                  int margin, int wr, int wc, int splits,
                                  int bf16, void* stream) {
  const deform::Geometry geo{n, c, h, w, kh, kw, oh, ow, og,
                             sh, sw, ph, pw, dh, dw};
  if (th * tw * kTaps > 4 * kOffWarps * kIters || splits < 1)
    return (int)cudaErrorInvalidValue;
  const int tiles_x = (ow + tw - 1) / tw, tiles_y = (oh + th - 1) / th;
  const deform::Window wp{th, tw, margin, wr, wc, tiles_x};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int2* r = reinterpret_cast<const int2*>(recs);
  int2* out = reinterpret_cast<int2*>(sorted);
  return bf16 ? launch<__nv_bfloat16>(input, offset, mask, gcols, order, r, out,
                                      starts, grad_input, grad_offset,
                                      grad_mask, partial, geo, wp, tiles_y,
                                      splits, s)
              : launch<float>(input, offset, mask, gcols, order, r, out, starts,
                              grad_input, grad_offset, grad_mask, partial, geo,
                              wp, tiles_y, splits, s);
}
