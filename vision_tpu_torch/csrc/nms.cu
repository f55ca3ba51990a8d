// Greedy non-maximum suppression over score-sorted boxes, batched.
//
// Replaces the TPU kernel vision_tpu/ops/_pallas/nms.py:
// nms_pallas_bitmask_sorted. That kernel walks 128-box blocks in grid
// order, carrying the "removed" state in VMEM from one block to the next.
// Hopper runs blocks in parallel and in no order, so the work splits into
// the two passes of the classic CUDA bitmask design:
//
//   1. nms_mask_kernel: one 256-thread block per (64 x 64 tile on or
//      above the diagonal, batch row); the scan never reads the others.
//      The tile's 64 column boxes sit in shared memory; four threads share
//      a row box, sixteen independent tests each, and their parts of the
//      64-bit word whose bit j says "row i suppresses column j" (IoU > thr,
//      j > i) are joined by shuffles.
//   2. nms_scan_kernel: one block per batch row walks the rows 64 at a
//      time (a "chunk"). What bounds it is the latency of that chain, so
//      the chain carries only what decides the next chunk:
//
//      band    chunk c's rows' words c..c+kBand-1 (the diagonal word and
//              the next ones), staged by cp.async kRing chunks ahead, so
//              no global load waits on the chain;
//      resolve one warp, two rows a lane: the chunk's greedy kept set as
//              the fixpoint of "live and not suppressed by a kept row"
//              (greedy is its only fixpoint), one OR-reduction a round;
//      fold    the kept rows' words c+1..c+kBand-1, OR-reduced, ride on in
//              registers to the next chunks;
//      helpers kHelpers warps OR the kept rows' words c+kBand.. into the
//              removed words in shared memory, off the chain, with many
//              loads in flight; word w is read by the chain only once
//              every chunk up to w-kBand has set its flag.
//
// What bounds it: the O(N^2) IoU pass is arithmetic on data that stays in
// registers and shared memory (N=1000 gives 16x16 tiles per row), and the
// O(N) scan is a chain of dependent steps; neither comes near the card's
// memory or FP32 rate at the sizes of the detection path. The design keeps
// the serial part to bit operations in registers and moves all float work
// and all global loads off the chain.
//
// Exact rules (vision_tpu/ops/_pallas/nms.py:145,213-215 and
// vision_tpu/ops/nms.py:57-60,92-94): suppress when IoU > thr strictly;
// union <= 0 gives IoU 0; invalid rows start removed, so they are never
// kept and never suppress (the caller also zeroes their coordinates).
// The IoU test is the exact one of nms_iou.cuh (build with -fmad=false):
// the keep mask agrees bit for bit with the plain version's.

#include <cuda_runtime.h>
#include <stdint.h>

#include "nms_iou.cuh"

namespace {

constexpr int kTile = 64;
constexpr int kMaskThreads = 256;  // 4 threads a row of a 64 x 64 tile
constexpr int kBand = 4;       // words of a chunk's rows that ride the chain
constexpr int kRing = 4;       // chunks whose band is staged ahead
constexpr int kHelpers = 7;    // warps that OR kept rows into later words
constexpr int kLoadBatch = 8;  // words a helper lane loads at once
constexpr unsigned kAll = 0xffffffffu;
typedef unsigned long long u64;

// Tiles on or above the diagonal, t-th in row-major order -> (rb, cb).
__device__ __forceinline__ void tile_of(int t, int words, int& rb, int& cb) {
  // tiles before row r: r * (2 * words - r + 1) / 2
  const double b = 2.0 * words + 1.0;
  int r = (int)((b - sqrt(b * b - 8.0 * t)) / 2.0);
  r = max(0, min(r, words - 1));
  while (r > 0 && (long long)r * (2 * words - r + 1) / 2 > t) --r;
  while (r + 1 < words && (long long)(r + 1) * (2 * words - r) / 2 <= t) ++r;
  rb = r;
  cb = r + t - (int)((long long)r * (2 * words - r + 1) / 2);
}

// One 256-thread block per (tile on or above the diagonal, batch row):
// four threads a row box, sixteen column boxes each, the four parts of the
// 64-bit word joined by shuffles.
__global__ void __launch_bounds__(kMaskThreads)
    nms_mask_kernel(const float4* __restrict__ boxes, int n, int words,
                    Threshold thr, u64* __restrict__ mask) {
  int rb, cb;
  tile_of(blockIdx.x, words, rb, cb);
  const int b = blockIdx.y;
  __shared__ float4 col[kTile];
  const float4* bb = boxes + (size_t)b * n;
  const int col0 = cb * kTile, ncol = min(kTile, n - col0);
  if (threadIdx.x < ncol) col[threadIdx.x] = bb[col0 + threadIdx.x];
  __syncthreads();
  const int i = threadIdx.x >> 2, part = threadIdx.x & 3;
  const int row = rb * kTile + i;
  u64 bits = 0;
  if (row < n) {
    const float4 r = bb[row];
#pragma unroll
    for (int k = 0; k < 16; ++k) {  // independent tests, no branches
      const int j = part * 16 + k;
      const bool later = j < ncol && (cb != rb || j > i);
      bits |= (u64)(later & above(r, col[j], thr)) << j;
    }
  }
  bits |= __shfl_xor_sync(kAll, bits, 1);
  bits |= __shfl_xor_sync(kAll, bits, 2);
  if (part == 0 && row < n) mask[((size_t)b * n + row) * words + cb] = bits;
}

__device__ __forceinline__ u64 warp_or(u64 v) {
  const unsigned lo = __reduce_or_sync(kAll, (unsigned)v);
  const unsigned hi = __reduce_or_sync(kAll, (unsigned)(v >> 32));
  return ((u64)hi << 32) | lo;
}

template <class T>
__device__ __forceinline__ T load_volatile(const T* p) {
  return *const_cast<const volatile T*>(p);
}

template <class T>
__device__ __forceinline__ void store_volatile(T* p, T v) {
  *const_cast<volatile T*>(p) = v;
}

// 8 bytes from global to shared memory, or 8 zero bytes when !in
__device__ __forceinline__ void cp_async8(void* dst, const void* src, bool in) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(s),
               "l"(src), "r"(in ? 8 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending) : "memory");
}

// Dynamic shared bytes of the scan: removed, kept and a flag per word.
__host__ __device__ constexpr size_t scan_shared_bytes(int words) {
  return (size_t)words * (2 * sizeof(u64) + sizeof(int));
}

__global__ void __launch_bounds__(32 * (1 + kHelpers))
    nms_scan_kernel(const u64* __restrict__ mask,
                    const uint8_t* __restrict__ valid, int n, int words,
                    uint8_t* __restrict__ keep) {
  extern __shared__ u64 smem[];
  u64* removed = smem;                                // [words]
  u64* kept = removed + words;                        // [words]
  int* done = reinterpret_cast<int*>(kept + words);   // [words]
  __shared__ u64 band[kRing][kTile][kBand];
  __shared__ int resolved;  // chunks whose kept word is published
  const int b = blockIdx.x, lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const uint8_t* v = valid + (size_t)b * n;
  const u64* mb = mask + (size_t)b * n * words;

  // rows past n and invalid rows start removed
  for (int w = warp; w < words; w += 1 + kHelpers) {
    const int r = w * kTile + lane;
    const unsigned lo = __ballot_sync(kAll, r >= n || !v[r]);
    const unsigned hi = __ballot_sync(kAll, r + 32 >= n || !v[r + 32]);
    if (lane == 0) {
      removed[w] = ((u64)hi << 32) | lo;
      done[w] = 0;
    }
  }
  if (threadIdx.x == 0) resolved = 0;
  __syncthreads();

  if (warp > 0) {
    // Helper: for each of its chunks c, once c is resolved, OR the kept
    // rows' words c+kBand.. into `removed` (a lane holds rows lane and
    // lane+32; one lane ORs each word in), then raise done[c].
    for (int c = warp - 1; c < words; c += kHelpers) {
      if (c + kBand < words) {
        while (load_volatile(&resolved) <= c) {
        }
        __threadfence_block();
        const u64 kw = load_volatile(&kept[c]);
        const bool k0 = (kw >> lane) & 1ull, k1 = (kw >> (lane + 32)) & 1ull;
        const u64* r0 = mb + (size_t)(c * kTile + lane) * words;
        const u64* r1 = r0 + (size_t)32 * words;
        for (int w0 = c + kBand; kw && w0 < words; w0 += kLoadBatch) {
          u64 m[kLoadBatch];
#pragma unroll
          for (int j = 0; j < kLoadBatch; ++j) {
            const int w = w0 + j;
            m[j] = (w < words && k0 ? r0[w] : 0ull) |
                   (w < words && k1 ? r1[w] : 0ull);
          }
#pragma unroll
          for (int j = 0; j < kLoadBatch; ++j) {
            const u64 o = warp_or(m[j]);
            if (lane == j && o) atomicOr(&removed[w0 + j], o);
          }
        }
        __threadfence_block();
      }
      __syncwarp();
      if (lane == 0) store_volatile(&done[c], 1);
    }
    return;
  }

  // The chain (warp 0). Stage chunk c's band into ring slot c % kRing: a
  // lane copies its own two rows, so it alone reads them back.
  auto stage = [&](int c) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int i = lane + 32 * h, row = c * kTile + i;
#pragma unroll
      for (int k = 0; k < kBand; ++k) {
        const bool in = row < n && c + k < words;
        cp_async8(&band[c % kRing][i][k],
                  in ? mb + (size_t)row * words + c + k : mb, in);
      }
    }
    cp_async_commit();
  };
#pragma unroll
  for (int c = 0; c < kRing; ++c) stage(c);

  u64 pend[kBand];  // the chain's ORs into words c .. c+kBand-1
#pragma unroll
  for (int k = 0; k < kBand; ++k) pend[k] = 0ull;
  for (int c = 0; c < words; ++c) {
    cp_async_wait<kRing - 1>();
    u64 d[2][kBand];
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int k = 0; k < kBand; ++k) d[h][k] = band[c % kRing][lane + 32 * h][k];
    stage(c + kRing);

    // word c is complete once chunks <= c-kBand have ORed into it
    if (c >= kBand) {
      while (!load_volatile(&done[c - kBand])) {
      }
      __threadfence_block();
    }
    const u64 live = ~(load_volatile(&removed[c]) | pend[0]);
    u64 kw = live;
    while (true) {
      const u64 s = warp_or(((kw >> lane) & 1ull ? d[0][0] : 0ull) |
                            ((kw >> (lane + 32)) & 1ull ? d[1][0] : 0ull));
      const u64 next = live & ~s;
      if (next == kw) break;
      kw = next;
    }
    if (lane == 0) {
      store_volatile(&kept[c], kw);
      __threadfence_block();
      store_volatile(&resolved, c + 1);
    }
    const bool k0 = (kw >> lane) & 1ull, k1 = (kw >> (lane + 32)) & 1ull;
#pragma unroll
    for (int k = 1; k < kBand; ++k) {
      const u64 o = warp_or((k0 ? d[0][k] : 0ull) | (k1 ? d[1][k] : 0ull));
      pend[k - 1] = pend[k] | o;
    }
    pend[kBand - 1] = 0ull;
  }
  cp_async_wait<0>();
  __syncwarp();
  // the keep mask, once the chain is done: no global store on the chain
  for (int c = 0; c < words; ++c) {
    const u64 kw = kept[c];
    const int row = c * kTile + lane;
    if (row < n) keep[(size_t)b * n + row] = (kw >> lane) & 1ull;
    if (row + 32 < n) keep[(size_t)b * n + row + 32] = (kw >> (lane + 32)) & 1ull;
  }
}

}  // namespace

// boxes [b, n, 4] f32, 16-byte aligned (score-sorted per row, invalid rows
// zeroed), valid [b, n] bytes, mask scratch [b, n, ceil(n/64)] u64,
// keep [b, n] bytes (out).
extern "C" int vt_nms_keep(const float* boxes, const uint8_t* valid,
                           u64* mask, uint8_t* keep, int b, int n, float thr,
                           void* stream) {
  if (b == 0 || n == 0) return 0;
  if (reinterpret_cast<uintptr_t>(boxes) % sizeof(float4) != 0)
    return (int)cudaErrorMisalignedAddress;  // read as float4
  const int words = (n + kTile - 1) / kTile;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int tiles = words * (words + 1) / 2;
  nms_mask_kernel<<<dim3(tiles, b), kMaskThreads, 0, s>>>(
      reinterpret_cast<const float4*>(boxes), n, words, make_threshold(thr),
      mask);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const size_t bytes = scan_shared_bytes(words);
  if (bytes > 40 * 1024) {  // beside the 8 KB static band
    err = cudaFuncSetAttribute(nms_scan_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)bytes);
    if (err != cudaSuccess) return (int)err;
  }
  nms_scan_kernel<<<b, 32 * (1 + kHelpers), bytes, s>>>(mask, valid, n, words,
                                                        keep);
  return (int)cudaGetLastError();
}
