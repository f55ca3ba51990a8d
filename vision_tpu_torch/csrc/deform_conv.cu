// Deformable convolution forward: the bilinear columns (im2col of the
// offset samples), channels last.
//
// Replaces vision_tpu/ops/deform_conv.py:88-151 (no pallas_call: there the
// TPU design gathers the whole column tensor four times, once a corner,
// with XLA gathers on the 128-lane channel axis, and feeds it to one MXU
// einsum).
//
// What bounds it: the bytes of the columns it writes, K² times the input
// at the output's resolution (at the 1344 canvas, batch 2: 260 MB a call
// at C3, 130 MB at C4, 65 MB at C5, some 2.0 GB for the 13 calls of a
// ResNet-50 forward), against ~0.4 GB of input read. The corners it reads
// are four per column element: gathered from L2 one by one, they are four
// times the columns' bytes again, and that (not DRAM) was what held back a
// design with a warp a sample and its lanes over channels. So:
//
//   block    a tile of th x tw output positions (4 x 8; ops/deform_conv.py:
//            tile_plan) of one image, all K² taps, a range of channel
//            chunks (several blocks split the channels where the tiles
//            alone would not fill the card);
//   records  once a tile (and offset group): each sample's four corner
//            codes (deform_sample.cuh: a pixel of the staged window,
//            invalid, or a pixel of the map outside it), its four weights
//            and its mask, in shared memory; the offsets and the mask read
//            along ox, coalesced; 2-D indexing, no 64-bit division;
//   window   for each chunk of 32 channels, the input pixels the tile can
//            read at offsets of up to `margin` px, read NCHW as the input
//            lies (along rows, two pixels a load, a thread's 8 loads in
//            flight at once; a bf16 input as it lies, widened) and staged
//            channels last, so the K² x 4 corner reads of a tile hit shared
//            memory instead of L2;
//   gather   a warp instruction covers 4 samples, a quarter-warp each, a
//            lane 4 of the chunk's channels: four 16-byte shared-memory
//            reads without bank conflicts (an invalid corner reads the
//            window's zero pixel, so a corner costs one branch), the sum
//            w1 v1 + w2 v2 + w3 v3 + w4 v4 times the mask in the plain
//            version's order (-fmad=false: the plain version's bits), and
//            one 16-byte streaming store (__stcs: the product reads the
//            columns once); every element is written, zeros where the
//            sample or a corner is invalid. (A warp a sample with its lanes
//            over 32 channels spends four times the instructions a column
//            on records, branches and addresses, and was slower.)
//
// Its next step is not to write the columns at all: sample straight into
// shared-memory tiles that feed the product (an implicit GEMM, in f32).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "deform_sample.cuh"

namespace {

using deform::kChunk;

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

// shared memory: the window, then a record a sample (corner codes,
// weights, mask, and its row of the columns, -1 off the output)
__host__ __device__ int samples_of(const deform::Window& w,
                                   const deform::Geometry& geo) {
  return w.th * w.tw * geo.k2();
}
size_t smem_bytes(const deform::Window& w, const deform::Geometry& geo) {
  return (size_t)deform::window_floats(w) * 4 +
         (size_t)samples_of(w, geo) * (sizeof(int4) + sizeof(float4) + 8);
}

// VEC: the channels of every group start on 16-byte boundaries, so a lane
// stores its 4 columns as one float4
template <typename T, bool VEC>
__global__ void __launch_bounds__(kThreads)
    im2col_kernel(const T* __restrict__ input, const float* __restrict__ offset,
                  const float* __restrict__ mask, float* __restrict__ cols,
                  deform::Geometry geo, deform::Window wp, int chunks_per_split) {
  extern __shared__ float4 smem4[];
  float* win = reinterpret_cast<float*>(smem4);
  const int ns = samples_of(wp, geo);
  int4* codes = reinterpret_cast<int4*>(win + deform::window_floats(wp));
  float4* wts = reinterpret_cast<float4*>(codes + ns);
  float* msk = reinterpret_cast<float*>(wts + ns);
  int* rows = reinterpret_cast<int*>(msk + ns);

  const int tp = wp.th * wp.tw;
  const int ty = blockIdx.x / wp.tiles_x, tx = blockIdx.x - ty * wp.tiles_x;
  const int oy0 = ty * wp.th, ox0 = tx * wp.tw;
  const int wy0 = oy0 * geo.sh - geo.ph - wp.margin;
  const int wx0 = ox0 * geo.sw - geo.pw - wp.margin;
  const int b = blockIdx.y;
  const int k2 = geo.k2(), cg = geo.cg();
  const long long L = geo.l(), hw = geo.hw();
  const int per_group = (cg + kChunk - 1) / kChunk;
  const int q0 = blockIdx.z * chunks_per_split;
  const int q1 = min(q0 + chunks_per_split, geo.og * per_group);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  // a lane: sample 4 G + sub of each group G = warp, warp + kWarps, ..., and
  // channels cq .. cq + 3 of the chunk
  const int sub = lane >> 3, cq = 4 * (lane & 7);
  deform::zero_pixel(wp, win);

  int group = -1;
  for (int q = q0; q < q1; ++q) {
    const int g = q / per_group, c0 = (q - g * per_group) * kChunk;
    const int cw = min(kChunk, cg - c0);
    __syncthreads();  // the previous chunk's window and records are read
    if (g != group) {
      // s = tap * tp + p: consecutive threads, consecutive positions
      for (int s = threadIdx.x; s < ns; s += kThreads) {
        const int tap = s / tp, p = s - tap * tp;
        const int py = p / wp.tw, oy = oy0 + py, ox = ox0 + p - py * wp.tw;
        const int zero = wp.wr * wp.wc * deform::kStride;
        int4 code = make_int4(zero, zero, zero, zero);
        float4 w4 = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
        float m = 1.0f;
        int row = -1;
        if (oy < geo.oh && ox < geo.ow) {
          const long long pos = (long long)oy * geo.ow + ox;
          const long long ch = ((long long)b * geo.og + g) * 2 * k2 + 2 * tap;
          const int i = tap / geo.kw, j = tap - i * geo.kw;
          const deform::Corners cs = deform::sample_at(
              offset[ch * L + pos], offset[(ch + 1) * L + pos], oy, ox, i, j,
              geo);
          code = make_int4(deform::corner_code(cs, 0, wy0, wx0, wp, geo),
                           deform::corner_code(cs, 1, wy0, wx0, wp, geo),
                           deform::corner_code(cs, 2, wy0, wx0, wp, geo),
                           deform::corner_code(cs, 3, wy0, wx0, wp, geo));
          w4 = make_float4(cs.hy * cs.hx, cs.hy * cs.lx, cs.ly * cs.hx,
                           cs.ly * cs.lx);
          if (mask != nullptr)
            m = mask[(((long long)b * geo.og + g) * k2 + tap) * L + pos];
          row = (int)(((long long)b * L + pos) * k2 + tap);
        }
        codes[s] = code;
        wts[s] = w4;
        msk[s] = m;
        rows[s] = row;
      }
      group = g;
    }
    const long long plane0 = (long long)b * geo.c + g * cg + c0;
    deform::stage_window(input + plane0 * hw, hw, cw, wy0, wx0, wp, geo, win);
    __syncthreads();
    if (cq >= cw) continue;
    const T* plane = input + (plane0 + cq) * hw;
    const int avail = min(4, cw - cq);
    const float* wl = win + cq;
#pragma unroll 2
    for (int s = 4 * warp + sub; s < ns; s += 4 * kWarps) {
      const int row = rows[s];
      if (row < 0) continue;
      const int4 code = codes[s];
      const float4 w4 = wts[s];
      const float4 v0 = deform::corner_quad(code.x, wl, plane, hw, avail);
      const float4 v1 = deform::corner_quad(code.y, wl, plane, hw, avail);
      const float4 v2 = deform::corner_quad(code.z, wl, plane, hw, avail);
      const float4 v3 = deform::corner_quad(code.w, wl, plane, hw, avail);
      const float a[4][4] = {{v0.x, v0.y, v0.z, v0.w}, {v1.x, v1.y, v1.z, v1.w},
                             {v2.x, v2.y, v2.z, v2.w}, {v3.x, v3.y, v3.z, v3.w}};
      float out[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float acc = w4.x * a[0][e];
        acc = acc + w4.y * a[1][e];
        acc = acc + w4.z * a[2][e];
        acc = acc + w4.w * a[3][e];
        out[e] = mask != nullptr ? acc * msk[s] : acc;
      }
      float* dst = cols + (long long)row * geo.c + g * cg + c0 + cq;
      if (VEC) {
        __stcs(reinterpret_cast<float4*>(dst),
               make_float4(out[0], out[1], out[2], out[3]));
      } else {
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (e < avail) __stcs(dst + e, out[e]);
      }
    }
  }
}

template <typename T, bool VEC>
int launch(const void* input, const float* offset, const float* mask,
           float* cols, const deform::Geometry& geo, const deform::Window& wp,
           int tiles_y, int splits, cudaStream_t stream) {
  const size_t smem = smem_bytes(wp, geo);
  const int chunks = geo.og * ((geo.cg() + kChunk - 1) / kChunk);
  const int per_split = (chunks + splits - 1) / splits;
  splits = (chunks + per_split - 1) / per_split;
  cudaError_t err = cudaFuncSetAttribute(
      im2col_kernel<T, VEC>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((unsigned)(wp.tiles_x * tiles_y), (unsigned)geo.n,
                  (unsigned)splits);
  im2col_kernel<T, VEC><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(input), offset, mask, cols, geo, wp, per_split);
  return (int)cudaGetLastError();
}

template <typename T>
int launch(const void* input, const float* offset, const float* mask,
           float* cols, const deform::Geometry& geo, const deform::Window& wp,
           int tiles_y, int splits, cudaStream_t stream) {
  // 16-byte stores where every row of the group starts on a 16-byte
  // boundary (the buffers themselves are allocated aligned)
  return geo.cg() % 4 == 0 && geo.c % 4 == 0
             ? launch<T, true>(input, offset, mask, cols, geo, wp, tiles_y,
                               splits, stream)
             : launch<T, false>(input, offset, mask, cols, geo, wp, tiles_y,
                                splits, stream);
}

}  // namespace

// input [N, C, H, W] (f32, or bf16 where bf16 != 0), offset and mask f32
// (mask may be null), cols [N, OH, OW, KH*KW, C] f32. The tile (th x tw
// output positions), the window's margin, rows and columns, and the
// channel splits are the host's plan (ops/deform_conv.py:tile_plan).
// Returns the CUDA error of the launch (0 if none).
extern "C" int vt_deform_im2col(const void* input, const float* offset,
                                const float* mask, float* cols, int n, int c,
                                int h, int w, int kh, int kw, int oh, int ow,
                                int og, int sh, int sw, int ph, int pw, int dh,
                                int dw, int th, int tw, int margin, int wr,
                                int wc, int splits, int bf16, void* stream) {
  const deform::Geometry geo{n, c, h, w, kh, kw, oh, ow, og,
                             sh, sw, ph, pw, dh, dw};
  if ((long long)n * oh * ow * kh * kw == 0 || c == 0) return 0;
  const int tiles_x = (ow + tw - 1) / tw, tiles_y = (oh + th - 1) / th;
  const deform::Window wp{th, tw, margin, wr, wc, tiles_x};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return bf16 ? launch<__nv_bfloat16>(input, offset, mask, cols, geo, wp,
                                      tiles_y, splits, s)
              : launch<float>(input, offset, mask, cols, geo, wp, tiles_y,
                              splits, s);
}
