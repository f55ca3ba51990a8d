// Greedy non-maximum suppression over score-sorted boxes, batched: the
// row-serial form.
//
// Replaces the TPU kernel vision_tpu/ops/_pallas/nms.py: nms_pallas_sorted
// (kernel body _nms_kernel). That kernel walks the boxes in order with the
// whole state in fast memory: a box that is still alive computes its IoU
// against every box in one vector operation and kills the later ones above
// the threshold; a suppressed box skips its row.
//
// Here one block owns one batch row and keeps all its state on chip: the
// "removed" state as one bit a box in 32-bit words of shared memory (2.5 KB
// at N = 20,000), and, up to the shared-memory limit (14,256 boxes), the
// boxes as float4; above it they are read from global memory (L2). Nothing
// of size N*N exists.
//
// The chain of kept boxes is walked 32 boxes (one word, one "chunk") at a
// time, with one barrier a chunk instead of one a kept box:
//
//   prepare     up to 4 helper warps, each a share of the pairs, give lane
//               i the bits of the earlier boxes of the chunk that would
//               suppress box 32c+i, and stage the chunk's boxes. This does
//               not depend on which boxes are alive, so it runs two chunks
//               ahead, off the chain;
//   resolve     one warp, once the chunk's word is final: its greedy kept
//               set, as the fixpoint of "live and not suppressed by an
//               earlier kept box", one __ballot_sync a round, a few rounds;
//   suppression every later live box is tested against the chunk's kept
//               boxes (at most 32, eight independent tests at a time);
//               __ballot_sync forms a word's new bits and one lane stores
//               them. A warp owns the words it writes: no atomics.
//
// In iteration c, warp 0 owns word c+1: once it has suppressed in it, that
// word is final, so warp 0 resolves chunk c+1 at once; the helpers prepare
// chunk c+2; the other warps suppress in the words after c+1; then one
// barrier. N/32 + 3 barriers a row.
//
// What bounds it: a row lives on one SM. At N = 1,000 (H100) the skeleton
// of the chain (barriers, resolves, the helpers' tests) takes ~0.03 ms and
// the suppression tests ~0.085 ms, far from the card's memory or FP32 rate;
// the bitmask kernel (nms.cu) spreads the tests over every SM instead.
//
// Exact rules, as nms.cu states them: suppress when IoU > thr strictly;
// union <= 0 gives IoU 0; invalid rows start removed, so they are never
// kept and never suppress. The IoU test is the exact one of nms_iou.cuh,
// shared with nms.cu (build with -fmad=false), so the three keep masks
// agree bit for bit.

#include <cuda_runtime.h>
#include <stdint.h>

#include "nms_iou.cuh"

namespace {

constexpr int kMaxShared = 232448;  // bytes a block may ask for on sm_90
constexpr unsigned kAll = 0xffffffffu;

constexpr int kStep = 8;      // kept boxes a thread tests at a time
constexpr int kMaxParts = 4;  // helper warps preparing one chunk

// Shared bytes of a row: with `coords`, one float4 a box; always three
// chunks' boxes (32 float4 each), the removed words, two chunks' masks of
// earlier suppressors (kMaxParts x 32 words each) and two kept masks.
__host__ __device__ constexpr size_t shared_bytes(int n, bool coords) {
  return (coords ? (size_t)n * sizeof(float4) : 0) + 3 * 32 * sizeof(float4) +
         (size_t)((n + 31) / 32) * sizeof(unsigned) +
         2 * kMaxParts * 32 * sizeof(unsigned) + 2 * sizeof(unsigned);
}

template <bool kShared>
__global__ void nms_rowscan_kernel(const float* __restrict__ boxes,
                                   const uint8_t* __restrict__ valid, int n,
                                   Threshold thr, uint8_t* __restrict__ keep) {
  extern __shared__ float4 smem[];
  const int b = blockIdx.x, t = threadIdx.x, nt = blockDim.x;
  const int lane = t & 31, warp = t >> 5, nwarps = nt >> 5;
  const int words = (n + 31) / 32;
  const float4* bb = reinterpret_cast<const float4*>(boxes) + (size_t)b * n;
  const uint8_t* v = valid + (size_t)b * n;
  uint8_t* kp = keep + (size_t)b * n;

  // kShared: the row's boxes [n]; then, always: chunk c's boxes [32] at
  // c % 3; the removed words; at c % 2 chunk c's "earlier" masks (lane i:
  // the boxes of the chunk before i that suppress it, one word a helper)
  // and its kept mask.
  float4* s_boxes = smem;
  float4* chunk_boxes = smem + (kShared ? n : 0);  // [3][32]
  unsigned* removed = reinterpret_cast<unsigned*>(chunk_boxes + 3 * 32);
  unsigned* earlier = removed + words;
  unsigned* s_kept = earlier + 2 * kMaxParts * 32;
  // helper warps that prepare a chunk, each a share of the earlier boxes;
  // the rest, after warp 0, suppress
  const int parts = max(1, min(kMaxParts, nwarps / 8));

  auto load = [&](int i) {
    if (i >= n) return make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    return kShared ? s_boxes[i] : bb[i];
  };

  // Helper warp `part` of `parts`: give lane i the bits of the earlier
  // boxes j of chunk c, j = part mod parts, that would suppress box 32c+i,
  // whether alive or not (that is settled when the chunk is resolved).
  // Part 0 also stages the chunk's boxes for its suppression pass.
  auto prepare_chunk = [&](int c, int part) {
    const float4 me = load(c * 32 + lane);
    if (part == 0) chunk_boxes[(c % 3) * 32 + lane] = me;
    unsigned sup = 0;
#pragma unroll 8
    for (int j = part; j < 32; j += parts)  // independent tests, no branches
      sup |= (unsigned)((j < lane) & above(load(c * 32 + j), me, thr)) << j;
    earlier[((c & 1) * kMaxParts + part) * 32 + lane] = sup;
  };

  // Warp 0, once chunk c's word is final: its greedy kept set, the fixpoint
  // of kept = live and not suppressed by an earlier kept box. Iterated from
  // kept = live, the first j boxes are settled after j rounds; the greedy
  // set is the only fixpoint, so the first round that changes nothing ends.
  auto resolve = [&](int c) {
    const unsigned live = ~removed[c];
    unsigned mine = 0;
    for (int part = 0; part < parts; ++part)
      mine |= earlier[((c & 1) * kMaxParts + part) * 32 + lane];
    const bool alive = (live >> lane) & 1u;
    unsigned kept = live;
    while (true) {
      const unsigned next = __ballot_sync(kAll, alive && !(mine & kept));
      if (next == kept) break;
      kept = next;
    }
    if (lane == 0) removed[c] = ~kept, s_kept[c & 1] = kept;
  };

  // Clear the bits of word w's live boxes that a kept box of chunk c
  // suppresses; one lane stores the word.
  auto suppress = [&](int w, int c, unsigned kept) {
    const float4* cb = chunk_boxes + (c % 3) * 32;
    const unsigned word = removed[w];
    bool gone = false;
    if (!((word >> lane) & 1u)) {
      const float4 me = load(w * 32 + lane);
      for (int base = 0; base < 32 && !gone; base += kStep) {
        const unsigned some = (kept >> base) & ((1u << kStep) - 1);
        if (!some) continue;
#pragma unroll
        for (int j = 0; j < kStep; ++j)  // independent tests, no branches
          gone |= ((some >> j) & 1u) & above(cb[base + j], me, thr);
      }
    }
    const unsigned bits = __ballot_sync(kAll, gone);
    if (lane == 0 && bits) removed[w] = word | bits;
  };

  if (kShared)
    for (int i = t; i < n; i += nt) s_boxes[i] = bb[i];
  // boxes past n count as removed, so they are never kept
  for (int w = warp; w < words; w += nwarps) {
    const int i = w * 32 + lane;
    const unsigned bits = __ballot_sync(kAll, i >= n || !v[i]);
    if (lane == 0) removed[w] = bits;
  }
  __syncthreads();
  if (warp < 2 * parts && warp / parts < words)
    prepare_chunk(warp / parts, warp % parts);
  __syncthreads();
  if (warp == 0) resolve(0);
  __syncthreads();

  // Chunk c's kept mask is known at the top of iteration c. Warp 0 owns
  // word c+1: once it has suppressed in it, the word is final and warp 0
  // resolves chunk c+1. Warps 1..parts prepare chunk c+2; the others
  // suppress in the words after c+1. One barrier a chunk.
  for (int c = 0; c < words; ++c) {
    const unsigned kept = s_kept[c & 1];
    if (warp == 0) {
      if (c + 1 < words) {
        if (kept) {
          suppress(c + 1, c, kept);
          __syncwarp();
        }
        resolve(c + 1);
      }
    } else if (warp <= parts) {
      if (c + 2 < words) prepare_chunk(c + 2, warp - 1);
    } else if (kept) {
      for (int w = c + 1 + warp - parts; w < words; w += nwarps - 1 - parts)
        suppress(w, c, kept);
    }
    __syncthreads();
  }
  for (int i = t; i < n; i += nt)
    kp[i] = (removed[i >> 5] >> (i & 31)) & 1u ? 0 : 1;
}

}  // namespace

// boxes [b, n, 4] f32, 16-byte aligned (score-sorted per row, invalid rows
// zeroed), valid [b, n] bytes, keep [b, n] bytes (out).
extern "C" int vt_nms_rowscan(const float* boxes, const uint8_t* valid,
                              uint8_t* keep, int b, int n, float thr,
                              void* stream) {
  if (b == 0 || n == 0) return 0;
  if (reinterpret_cast<uintptr_t>(boxes) % sizeof(float4) != 0)
    return (int)cudaErrorMisalignedAddress;  // read as float4
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int threads = n >= 1024 ? 1024 : (n + 31) / 32 * 32;
  const bool on_chip = shared_bytes(n, true) <= (size_t)kMaxShared;
  const size_t bytes = shared_bytes(n, on_chip);
  const Threshold threshold = make_threshold(thr);
  if (on_chip) {
    if (bytes > 48 * 1024) {
      cudaError_t err = cudaFuncSetAttribute(
          nms_rowscan_kernel<true>,
          cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxShared);
      if (err != cudaSuccess) return (int)err;
    }
    nms_rowscan_kernel<true><<<b, threads, bytes, s>>>(boxes, valid, n,
                                                       threshold, keep);
  } else {
    nms_rowscan_kernel<false><<<b, threads, bytes, s>>>(boxes, valid, n,
                                                        threshold, keep);
  }
  return (int)cudaGetLastError();
}
