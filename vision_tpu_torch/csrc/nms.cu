// Greedy non-maximum suppression over score-sorted boxes, batched.
//
// Replaces the TPU kernel vision_tpu/ops/_pallas/nms.py:
// nms_pallas_bitmask_sorted. That kernel walks 128-box blocks in grid
// order, carrying the "removed" state in VMEM from one block to the next.
// Hopper runs blocks in parallel and in no order, so the work splits into
// the two passes of the classic CUDA bitmask design:
//
//   1. nms_mask_kernel: one 64-thread block per (column tile, row tile,
//      batch row). Thread i holds row box i, the tile's 64 column boxes
//      sit in shared memory, and the thread writes one 64-bit word whose
//      bit j says "row i suppresses column j" (IoU > thr, j > i). Only
//      tiles on or above the diagonal are computed: the scan never reads
//      the others.
//   2. nms_scan_kernel: one 64-thread block per batch row. The "removed"
//      words live in shared memory. Per 64-row chunk, one thread resolves
//      the chunk against its own diagonal word (64 bit operations in a
//      register), then each kept row's thread ORs its mask row into the
//      later words (shared-memory atomics).
//
// What bounds it: the O(N^2) IoU pass is arithmetic on data that stays in
// registers and shared memory (N=1000 gives 16x16 tiles per row), and the
// O(N) scan is a chain of dependent steps; neither comes near the card's
// memory or FP32 rate at the sizes of the detection path. The design keeps
// the serial part to bit operations on shared memory and moves all float
// work into the parallel pass.
//
// Exact rules (vision_tpu/ops/_pallas/nms.py:145,213-215 and
// vision_tpu/ops/nms.py:57-60,92-94): suppress when IoU > thr strictly;
// union <= 0 gives IoU 0; invalid rows start removed, so they are never
// kept and never suppress (the caller also zeroes their coordinates).
// Build with -fmad=false so every float operation rounds as the plain
// PyTorch version rounds it: the keep mask must agree bit for bit.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTile = 64;
typedef unsigned long long u64;

__device__ __forceinline__ bool iou_above(float ax1, float ay1, float ax2,
                                          float ay2, float aarea, float bx1,
                                          float by1, float bx2, float by2,
                                          float barea, float thr) {
  const float w = fmaxf(fminf(ax2, bx2) - fmaxf(ax1, bx1), 0.0f);
  const float h = fmaxf(fminf(ay2, by2) - fmaxf(ay1, by1), 0.0f);
  const float inter = w * h;
  const float uni = (aarea + barea) - inter;
  const float iou = uni > 0.0f ? inter / uni : 0.0f;
  return iou > thr;
}

__global__ void nms_mask_kernel(const float* __restrict__ boxes, int n,
                                int words, float thr, u64* __restrict__ mask) {
  const int cb = blockIdx.x, rb = blockIdx.y, b = blockIdx.z;
  if (cb < rb) return;
  __shared__ float col[kTile * 5];
  const float* bb = boxes + (size_t)b * n * 4;
  const int col0 = cb * kTile;
  const int ncol = min(kTile, n - col0);
  if (threadIdx.x < ncol) {
    const float* p = bb + (size_t)(col0 + threadIdx.x) * 4;
    const float x1 = p[0], y1 = p[1], x2 = p[2], y2 = p[3];
    col[threadIdx.x * 5 + 0] = x1;
    col[threadIdx.x * 5 + 1] = y1;
    col[threadIdx.x * 5 + 2] = x2;
    col[threadIdx.x * 5 + 3] = y2;
    col[threadIdx.x * 5 + 4] = (x2 - x1) * (y2 - y1);
  }
  __syncthreads();
  const int row = rb * kTile + threadIdx.x;
  if (row >= n) return;
  const float* r = bb + (size_t)row * 4;
  const float x1 = r[0], y1 = r[1], x2 = r[2], y2 = r[3];
  const float area = (x2 - x1) * (y2 - y1);
  u64 bits = 0;
  for (int j = (cb == rb) ? threadIdx.x + 1 : 0; j < ncol; ++j) {
    const float* c = col + j * 5;
    if (iou_above(x1, y1, x2, y2, area, c[0], c[1], c[2], c[3], c[4], thr))
      bits |= 1ull << j;
  }
  mask[((size_t)b * n + row) * words + cb] = bits;
}

__global__ void nms_scan_kernel(const u64* __restrict__ mask,
                                const uint8_t* __restrict__ valid, int n,
                                int words, uint8_t* __restrict__ keep) {
  extern __shared__ u64 removed[];  // [words]
  __shared__ u64 diag[kTile];
  __shared__ u64 kept_word;
  const int b = blockIdx.x, t = threadIdx.x;  // blockDim.x == kTile
  const uint8_t* v = valid + (size_t)b * n;
  const u64* mb = mask + (size_t)b * n * words;

  for (int w = t; w < words; w += kTile) {
    u64 bits = 0;
    for (int i = 0; i < kTile; ++i) {
      const int r = w * kTile + i;
      if (r >= n || !v[r]) bits |= 1ull << i;
    }
    removed[w] = bits;
  }
  for (int cb = 0; cb < words; ++cb) {
    const int row = cb * kTile + t;
    const u64* mrow = mb + (size_t)row * words;
    diag[t] = row < n ? mrow[cb] : 0ull;
    __syncthreads();
    if (t == 0) {  // resolve the chunk against itself: bit operations only
      u64 rem = removed[cb], kept = 0;
      const int nrow = min(kTile, n - cb * kTile);
      for (int i = 0; i < nrow; ++i) {
        if (!((rem >> i) & 1ull)) {
          kept |= 1ull << i;
          rem |= diag[i];
        }
      }
      removed[cb] = rem;
      kept_word = kept;
    }
    __syncthreads();
    // each kept row ORs its mask into the later words: independent loads,
    // eight in flight per thread, merged with shared-memory atomics
    const bool kept_me = (kept_word >> t) & 1ull;
    if (kept_me) {
      for (int w0 = cb + 1; w0 < words; w0 += 8) {
        u64 m[8];
#pragma unroll
        for (int j = 0; j < 8; ++j) m[j] = w0 + j < words ? mrow[w0 + j] : 0ull;
#pragma unroll
        for (int j = 0; j < 8; ++j)
          if (m[j]) atomicOr(&removed[w0 + j], m[j]);
      }
    }
    if (row < n) keep[(size_t)b * n + row] = kept_me ? 1 : 0;
    __syncthreads();
  }
}

}  // namespace

// boxes [b, n, 4] f32 (score-sorted per row, invalid rows zeroed),
// valid [b, n] bytes, mask scratch [b, n, ceil(n/64)] u64,
// keep [b, n] bytes (out).
extern "C" int vt_nms_keep(const float* boxes, const uint8_t* valid,
                           u64* mask, uint8_t* keep, int b, int n, float thr,
                           void* stream) {
  if (b == 0 || n == 0) return 0;
  const int words = (n + kTile - 1) / kTile;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  nms_mask_kernel<<<dim3(words, words, b), kTile, 0, s>>>(boxes, n, words,
                                                          thr, mask);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  nms_scan_kernel<<<b, kTile, words * sizeof(u64), s>>>(mask, valid, n, words,
                                                         keep);
  return (int)cudaGetLastError();
}
