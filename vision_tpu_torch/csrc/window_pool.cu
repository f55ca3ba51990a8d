// Windowed multi-scale RoIAlign contraction.
//
//   out[k, c, p, q] = sum_y sum_x w_y[k, p, y] * w_x[k, q, x]
//                     * stacked[row0[k] + y, x0[k] + x, c]  / div
//
// Replaces the TPU kernel vision_tpu/ops/_pallas/window_pool.py:
// window_pool_pallas. The TPU kernel DMAs each RoI's whole
// [winy, winx, C] window into VMEM. An f32 window at the Faster R-CNN
// box-head shape (32 x 32 x 256) is 1 MB, far above the 227 KB of shared
// memory a Hopper block has, so here C is tiled: one block per
// (RoI, 32-channel slice), 32 x 8 threads, and the contraction runs in
// two stages through shared memory:
//
//   stage 1: rows[p][x][c] = sum_y w_y[p, y] * window[y, x, c]
//            (thread (c, x-group) keeps PH partial sums in registers and
//            reads each window element once, 32 channels = one 128-byte
//            line per warp);
//   stage 2: out[c][p][q]  = sum_x w_x[q, x] * rows[p][x][c]
//            staged in shared memory as [c][p][q], which is one contiguous
//            span of the [K, C, PH, PW] output, then written coalesced.
//
// Window rows (columns) whose weights are all zero are skipped: a RoI's
// samples span ~14 px of the 32-px window at its FPN level.
//
// What bounds it: memory. The window reads (K * winy * winx * C floats,
// ~1 GB at K=1000, 32x32, C=256 before skipping) dwarf the FLOPs; the
// windows overlap on the pyramid, so much of it is served from L2. The
// sampling rules (CUDA edge rules, level extents) live in the weights.
// The RoI layout is channels-last ([R, WMAX, C]); the output is NCHW-like
// [K, C, PH, PW], what the box head flattens.

#include <cuda_runtime.h>

namespace {

constexpr int kCT = 32;     // channels per block (threadIdx.x)
constexpr int kTY = 8;      // thread rows (threadIdx.y)
constexpr int kMaxPH = 16;  // largest pooled height held in registers

__global__ void __launch_bounds__(kCT* kTY)
    window_pool_kernel(const float* __restrict__ stacked,
                       const int* __restrict__ row0,
                       const int* __restrict__ x0,
                       const float* __restrict__ wy,
                       const float* __restrict__ wx, int wmax, int c, int ph,
                       int pw, int winy, int winx, float div,
                       float* __restrict__ out) {
  extern __shared__ float smem[];
  float* s_wy = smem;                          // [ph][winy]
  float* s_wx = s_wy + ph * winy;              // [pw][winx]
  float* s_rows = s_wx + pw * winx;            // [ph][winx][kCT]
  float* s_out = s_rows + ph * winx * kCT;     // [kCT][ph*pw]
  int* s_ynz = (int*)(s_out + kCT * ph * pw);  // [winy]
  int* s_xnz = s_ynz + winy;                   // [winx]

  const int k = blockIdx.x;
  const int c0 = blockIdx.y * kCT;
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int tid = ty * kCT + tx, nthreads = kCT * kTY;

  for (int i = tid; i < ph * winy; i += nthreads)
    s_wy[i] = wy[(size_t)k * ph * winy + i];
  for (int i = tid; i < pw * winx; i += nthreads)
    s_wx[i] = wx[(size_t)k * pw * winx + i];
  __syncthreads();
  for (int y = tid; y < winy; y += nthreads) {
    int nz = 0;
    for (int p = 0; p < ph; ++p) nz |= s_wy[p * winy + y] != 0.0f;
    s_ynz[y] = nz;
  }
  for (int x = tid; x < winx; x += nthreads) {
    int nz = 0;
    for (int q = 0; q < pw; ++q) nz |= s_wx[q * winx + x] != 0.0f;
    s_xnz[x] = nz;
  }
  __syncthreads();

  const int ch = c0 + tx;
  const bool cvalid = ch < c;
  const size_t row_stride = (size_t)wmax * c;
  for (int x = ty; x < winx; x += kTY) {
    float acc[kMaxPH];
#pragma unroll
    for (int p = 0; p < kMaxPH; ++p) acc[p] = 0.0f;
    if (s_xnz[x] && cvalid) {
      const float* src =
          stacked + ((size_t)row0[k] * wmax + x0[k] + x) * c + ch;
      for (int y = 0; y < winy; ++y) {
        if (!s_ynz[y]) continue;
        const float v = src[y * row_stride];
#pragma unroll
        for (int p = 0; p < kMaxPH; ++p)
          if (p < ph) acc[p] += s_wy[p * winy + y] * v;
      }
    }
#pragma unroll
    for (int p = 0; p < kMaxPH; ++p)
      if (p < ph) s_rows[(p * winx + x) * kCT + tx] = acc[p];
  }
  __syncthreads();

  const int npq = ph * pw;
  for (int pq = ty; pq < npq; pq += kTY) {
    const int p = pq / pw, q = pq % pw;
    const float* wq = s_wx + q * winx;
    const float* rp = s_rows + p * winx * kCT + tx;
    float acc = 0.0f;
    for (int x = 0; x < winx; ++x) acc += wq[x] * rp[x * kCT];
    s_out[tx * npq + pq] = acc / div;
  }
  __syncthreads();

  const int nch = min(kCT, c - c0);
  float* dst = out + ((size_t)k * c + c0) * npq;
  for (int i = tid; i < nch * npq; i += nthreads) dst[i] = s_out[i];
}

}  // namespace

// stacked [rrows, wmax, c] f32, row0/x0 [k] int32 (windows in bounds,
// checked by the caller), wy [k, ph, winy] f32, wx [k, pw, winx] f32,
// out [k, c, ph, pw] f32. ph <= 16.
extern "C" int vt_window_pool(const float* stacked, const int* row0,
                              const int* x0, const float* wy, const float* wx,
                              float* out, int rrows, int wmax, int c, int k,
                              int ph, int pw, int winy, int winx, float div,
                              void* stream) {
  (void)rrows;
  if (k == 0 || c == 0) return 0;
  if (ph > kMaxPH) return (int)cudaErrorInvalidValue;
  const size_t smem = sizeof(float) * ((size_t)ph * winy + (size_t)pw * winx +
                                       (size_t)ph * winx * kCT +
                                       (size_t)kCT * ph * pw) +
                      sizeof(int) * (size_t)(winy + winx);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        window_pool_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const dim3 grid(k, (c + kCT - 1) / kCT);
  window_pool_kernel<<<grid, dim3(kCT, kTY), smem,
                       static_cast<cudaStream_t>(stream)>>>(
      stacked, row0, x0, wy, wx, wmax, c, ph, pw, winy, winx, div, out);
  return (int)cudaGetLastError();
}
