// Greedy non-maximum suppression over score-sorted boxes, batched: the
// row-serial form.
//
// Replaces the TPU kernel vision_tpu/ops/_pallas/nms.py: nms_pallas_sorted
// (kernel body _nms_kernel). That kernel walks the boxes in order with the
// whole state in fast memory: a box that is still alive computes its IoU
// against every box in one vector operation and kills the later ones above
// the threshold; a suppressed box skips its row.
//
// Here one block owns one batch row. The row's coordinates and areas sit in
// shared memory, coordinate-major, beside one "removed" byte per box. The
// block walks j = 0 .. N-1: every thread reads the same flags and steps to
// the next j that is not removed (no barrier is needed for that: nothing
// is written between barriers below index j), then the threads share the
// later boxes among them, test each against box j and set its flag. One
// barrier per KEPT box orders the flags written for j before they are read
// for the next j. A row that does not fit in shared memory (5 floats and a
// byte per box: above 11,068 boxes) runs the same loop on global memory,
// with the output buffer holding the flags and the areas recomputed.
//
// What bounds it: the chain of kept boxes. Each link is a barrier and a
// pass of N/threads IoU tests, far from the card's memory or FP32 rate;
// the bitmask kernel (nms.cu) moves the float work out of the chain and is
// the default. This one does N*(kept) tests instead of N*N/2 and needs no
// N*N/64-word scratch.
//
// Exact rules, as nms.cu states them: suppress when IoU > thr strictly;
// union <= 0 gives IoU 0; invalid rows start removed, so they are never
// kept and never suppress. Build with -fmad=false: the IoU below is the
// expression of nms.cu and of the plain PyTorch version, each operation
// rounded on its own, so the three keep masks agree bit for bit.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxShared = 232448;  // bytes a block may ask for on sm_90

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

template <bool kShared>
__global__ void nms_rowscan_kernel(const float* __restrict__ boxes,
                                   const uint8_t* __restrict__ valid, int n,
                                   float thr, uint8_t* keep) {
  extern __shared__ float smem[];  // kShared: x1, y1, x2, y2, area [n] each,
                                   // then n flag bytes
  const int b = blockIdx.x, t = threadIdx.x, nt = blockDim.x;
  const float* bb = boxes + (size_t)b * n * 4;
  const uint8_t* v = valid + (size_t)b * n;
  uint8_t* kp = keep + (size_t)b * n;
  float* sx1 = smem;
  float* sy1 = smem + n;
  float* sx2 = smem + 2 * (size_t)n;
  float* sy2 = smem + 3 * (size_t)n;
  float* sar = smem + 4 * (size_t)n;
  volatile uint8_t* removed =
      kShared ? reinterpret_cast<uint8_t*>(smem + 5 * (size_t)n) : kp;

  for (int i = t; i < n; i += nt) {
    if (kShared) {
      const float* p = bb + (size_t)i * 4;
      const float x1 = p[0], y1 = p[1], x2 = p[2], y2 = p[3];
      sx1[i] = x1, sy1[i] = y1, sx2[i] = x2, sy2[i] = y2;
      sar[i] = (x2 - x1) * (y2 - y1);
    }
    removed[i] = v[i] ? 0 : 1;
  }

  int j = 0;
  while (true) {
    __syncthreads();  // the flags written for the last kept box are visible
    while (j < n && removed[j]) ++j;  // the same j in every thread
    if (j >= n) break;
    float jx1, jy1, jx2, jy2, jar;
    if (kShared) {
      jx1 = sx1[j], jy1 = sy1[j], jx2 = sx2[j], jy2 = sy2[j], jar = sar[j];
    } else {
      const float* p = bb + (size_t)j * 4;
      jx1 = p[0], jy1 = p[1], jx2 = p[2], jy2 = p[3];
      jar = (jx2 - jx1) * (jy2 - jy1);
    }
    for (int i = j + 1 + t; i < n; i += nt) {
      if (removed[i]) continue;
      float x1, y1, x2, y2, ar;
      if (kShared) {
        x1 = sx1[i], y1 = sy1[i], x2 = sx2[i], y2 = sy2[i], ar = sar[i];
      } else {
        const float* p = bb + (size_t)i * 4;
        x1 = p[0], y1 = p[1], x2 = p[2], y2 = p[3];
        ar = (x2 - x1) * (y2 - y1);
      }
      if (iou_above(jx1, jy1, jx2, jy2, jar, x1, y1, x2, y2, ar, thr))
        removed[i] = 1;
    }
    ++j;
  }
  // every thread left the loop behind the same barrier: the flags are final
  for (int i = t; i < n; i += nt) kp[i] = removed[i] ? 0 : 1;
}

}  // namespace

// boxes [b, n, 4] f32 (score-sorted per row, invalid rows zeroed),
// valid [b, n] bytes, keep [b, n] bytes (out).
extern "C" int vt_nms_rowscan(const float* boxes, const uint8_t* valid,
                              uint8_t* keep, int b, int n, float thr,
                              void* stream) {
  if (b == 0 || n == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int threads = n <= 4096 ? 256 : 1024;
  const size_t bytes = (size_t)n * (5 * sizeof(float) + 1);
  if (bytes <= (size_t)kMaxShared) {
    if (bytes > 48 * 1024) {
      cudaError_t err = cudaFuncSetAttribute(
          nms_rowscan_kernel<true>,
          cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxShared);
      if (err != cudaSuccess) return (int)err;
    }
    nms_rowscan_kernel<true><<<b, threads, bytes, s>>>(boxes, valid, n, thr,
                                                       keep);
  } else {
    nms_rowscan_kernel<false><<<b, threads, 0, s>>>(boxes, valid, n, thr,
                                                    keep);
  }
  return (int)cudaGetLastError();
}
