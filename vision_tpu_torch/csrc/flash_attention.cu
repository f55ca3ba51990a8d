// Flash attention, forward: o = softmax(scale q k^T) v for q, k, v [B, H, S,
// D], with the row statistic lse = m + log(l) (natural log, f32) saved for
// the backward pass (flash_attention_backward.cu). No mask but the sequence
// end; f32 or bf16; D = 64 or 128.
//
// Replaces the TPU kernel reached from vision_tpu/ops/attention.py:80: the
// forward pallas_call of JAX's library flash attention
// (jax/experimental/pallas/ops/tpu/flash_attention.py:758, _flash_attention_
// kernel's body at l.385-474). That kernel walks 128-key blocks in order on
// one core, renormalising its f32 accumulator in VMEM after every block; the
// JAX caller pads S to 128 and masks the padding with segment ids.
//
// Both kernels walk the key tiles of a head in order for a set of query
// rows, keeping each row's running maximum m, its running sum l and the
// output accumulator in registers; the output is divided by l once, at the
// end. Keys at or past S are masked (score -inf) in the last tile only
// (the zero-filled rows there give s = 0, not -inf), query rows past S are
// computed and never stored, and q, k, v are read through their batch,
// head and row strides (a view of the packed q, k, v projection is read
// where it lies). p = ex2(s scale log2 e - m scale log2 e): one exponential
// a score. No atomics: the same inputs give the same bits on every call.
//
// * bf16 (sm_90a: wgmma, TMA; redesigned from a first design on mma.sync,
//   4 warps a block, each ldmatrix-ing the same k and v fragments).
//   What bounds it: 4 B H S^2 D product operations at 989 TFLOP/s and B H
//   S^2 exponentials at the SFUs' ~3.9e12 a second; at D = 64 the two are
//   equal (0.139 and 0.138 ms at ViT-L/16 512), so the exponentials have
//   to run while the tensor cores work. Persistent blocks, one an SM, each
//   walking work items of one (batch, head), head-major (the blocks in
//   flight share k and v in L2). A block has two or three consumer
//   warpgroups of 64 query rows each (items of 128 or 192 rows) and a
//   producer warpgroup whose one working thread keeps the TMA loads in
//   flight and gives its registers to the consumers (setmaxnreg: 40
//   against 232 with two, 24 against 160 with three). Three keep more
//   products in flight, and run at D = 64 unless they leave more
//   warpgroups with no row in a head's last item than two do: S = 1,025
//   takes three, S = 577 (3 x 192 + 1) two. q arrives once an item into
//   one of two buffers, so the next item's q loads during this walk; k and
//   v stream in 128-key tiles through a ring of TMA stages on full/empty
//   mbarriers (4 at D = 64, 2 at D = 128). The tensor maps are 4-D over (D,
//   S, H, B) with the views' own strides: rows past S load as zeros and a
//   box never reaches into the next head. s = q k^T on wgmma m64n128k16
//   with both operands in shared memory (K-major); p becomes a bf16
//   register A operand (the accumulator layout is the A layout) for o +=
//   p v, v read MN-major (the transpose bit). A warpgroup issues tile j's
//   p v and tile j + 1's s together and waits for both; then its softmax
//   (row maxima by quad shuffles, o and l rescaled by exp2 of the maximum's
//   move, p) runs while the other warpgroups' products run. A narrow last
//   tile runs as 80, 64 or 16 keys when that many cover its valid ones (S
//   = 577 leaves 65, 1,025 leaves 1). A warpgroup whose 64 rows all lie
//   past S (the last item at S = 1,025) computes nothing but still waits
//   for every tile and releases it, as the ring's count asks (a wait past
//   ~10 s traps). What holds it back (PERF.md §6): with two warpgroups at
//   ViT-L/16 512 the products alone took ~0.24 ms and the softmax alone
//   ~0.24, and the two overlapped little. Tried and not kept, all slower:
//   the two warpgroups taking turns to issue (named barriers, with the
//   turn passed before or after the wait); within a warpgroup, the softmax
//   of tile j + 1 run under tile j's p v; 64-key tiles (1.2x); the mask
//   compiled out of whole tiles, and the row maxima and sums taken as
//   trees.
// * f32 (redesigned from a first design on the FP32 units, a row on D / 32
//   threads): every product on the tensor cores as three TF32 products,
//   mma.sync m16n8k8 a_hi b_lo + a_lo b_hi + a_hi b_hi into f32 sums
//   (flash_common.cuh: hi rounded to tf32 on the bits, lo = x - hi read
//   truncated by the tensor core), whatever
//   torch.backends.cuda.matmul.allow_tf32 says: ~2^-21 of each product, f32
//   accuracy, held to the plain f32 version at 1e-5 of the largest o and
//   1e-5 on lse (one TF32 product alone misses both in a CPU emulation).
//   What bounds it: the three passes at mma.sync's TF32 rate (~310 TFLOP/s
//   on this card, tools/tf32_probe.py; 495 is wgmma's), and the
//   instructions around them. A block of 4 warps owns 64 query rows, 16 a
//   warp (one m16 slice); q is split into hi and lo once, into A fragments
//   in registers at D = 64 and arrays in shared memory at D = 128. k and v
//   stream in tiles of 32 keys (16 at D = 128, for registers)
//   double-buffered by cp.async, with a pitch of D + 4 floats (fragment
//   reads free of bank conflicts), each element split into hi and lo as
//   its fragment is read (splitting each tile once a block into hi and lo
//   arrays was 1.13x slower: the extra shared-memory traffic and a second
//   sync a tile cost more than the warps' splits). The fragment
//   permutation: p becomes the A operand of p v in place, a thread's
//   accumulator columns 2t and 2t + 1 taken as depth slots t and t + 4, and
//   v's rows 2t and 2t + 1 of each 8-deep slice are read in their place
//   (load_b_kn_tf32). The sums: the tensor core truncates each sum it
//   returns, so s keeps its small passes in a sum of its own, and each
//   tile's p v is summed from zero and added to the running o on the FP32
//   units after o's rescale (1,025 keys x 3 passes into one sum would
//   truncate ~400 times, ~2.4e-5 of |o|).

#include <cmath>
#include <type_traits>

#include "flash_common.cuh"
#include "sm90_common.cuh"

namespace {

using bf16 = __nv_bfloat16;
using flash::Args;
using flash::kLn2;

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// ---- bf16 (sm_90a: wgmma, TMA) ---------------------------------------------

namespace fwd {

using sm90::make_desc;
using sm90::mbar_arrive;
using sm90::mbar_wait;

constexpr int kKeys = 128;  // keys a ring tile
constexpr int kRow = 128;    // bytes of a box row: 64 bf16

// C consumer warpgroups a block, 64 query rows each, then the producer
// warpgroup; the register budgets fill the 65,536 an SM holds. Three
// (D = 64 only: at 128, o and the scores leave no registers for a third)
// keep more products in flight than two.
template <int C>
struct Team {
  static constexpr int kRows = 64 * C;  // query rows a work item
  static constexpr int kThreads = 128 * (C + 1);
  static constexpr int kProducerRegs = C == 3 ? 24 : 40;
  static constexpr int kConsumerRegs = C == 3 ? 160 : 232;
};

template <int D>
__host__ __device__ constexpr int stages() {  // the ring of k, v tiles
  return D == 64 ? 4 : 2;
}

template <int D, int C>
struct Layout {  // bytes from the 1024-aligned base of shared memory
  static constexpr int kStages = stages<D>();
  static constexpr int kQBytes = Team<C>::kRows * D * 2;  // one q buffer
  static constexpr int kTileBytes = kKeys * D * 2;  // one k or v tile
  static constexpr int kRingAt = 2 * kQBytes;       // q: 2 buffers
  static constexpr int kBarsAt = kRingAt + 2 * kStages * kTileBytes;
  static constexpr int kBytes = kBarsAt + 8 * (4 + 2 * kStages) + 1024;
};

struct Params {
  CUtensorMap q;     // Team::kRows-row boxes
  CUtensorMap k, v;  // kKeys-row boxes
  bf16* o;           // contiguous [B, H, S, D]
  float* lse;        // [B, H, S]
  long long items;   // B H blocks_per_head
  int heads, seq, blocks_per_head;
  float scale_log2;
};

// The barriers: q buffer b full (0, 1) and empty (2, 3); ring stage s full
// (4 + s) and empty (4 + kStages + s).
template <int D>
struct Bars {
  uint32_t base;
  __device__ uint32_t q_full(int b) const { return base + 8 * b; }
  __device__ uint32_t q_empty(int b) const { return base + 8 * (2 + b); }
  __device__ uint32_t full(int s) const { return base + 8 * (4 + s); }
  __device__ uint32_t empty(int s) const {
    return base + 8 * (4 + stages<D>() + s);
  }
};

// D / 64 boxes of `rows` rows at dst, one per 64 columns, from map at
// (row0, h, b); the bytes arrive on bar.
template <int D>
__device__ __forceinline__ void load_boxes(uint32_t dst, const CUtensorMap* map,
                                           uint32_t bar, int rows, int row0,
                                           int h, int b) {
#pragma unroll
  for (int x = 0; x < D / 64; ++x)
    sm90::tma_load_4d(dst + x * rows * kRow, map, bar, 64 * x, row0, h, b);
}

// The offset of the 16-deep slice kk of a K-major operand (the depth is
// the head dim) stored as boxes of `rows` rows.
__device__ __forceinline__ uint32_t kmajor(int kk, int rows) {
  return (kk / 4) * rows * kRow + 32 * (kk % 4);
}

// Accumulator element 4 j + e of an m64nN product is, in warp w of the
// warpgroup, (row 16 w + g + 8 (e / 2), column 8 j + 2 t + e % 2), lane =
// 4 g + t: a thread holds two rows, r = (i / 2) % 2 for element i.

// s = q k^T over the head dim into the N / 2 sums of s (N keys: the whole
// tile, or 80, 64 or 16 in a narrow last one): q this warpgroup's 64 rows of
// the q buffer at q_tile (R-row boxes), k the first N rows of the ring tile
// at k_tile (kKeys-row boxes), both K-major; the caller commits.
template <int D, int N, int R>
__device__ __forceinline__ void scores(float (&s)[N / 2], uint32_t q_tile,
                                       uint32_t k_tile) {
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const uint64_t da = make_desc(q_tile + kmajor(kk, R), 16, 1024);
    const uint64_t db = make_desc(k_tile + kmajor(kk, kKeys), 16, 1024);
    if constexpr (N == 128) {
      sm90::wgmma_ss_n128(s, da, db, kk);
    } else if constexpr (N == 80) {
      sm90::wgmma_ss_n80(s, da, db, kk);
    } else if constexpr (N == 64) {
      sm90::wgmma_ss_n64(s, da, db, kk);
    } else {
      sm90::wgmma_ss_n16(s, da, db, kk);
    }
  }
}

// o += p v over the first N keys of the ring tile: p the N / 16 bf16
// fragments, v the tile at v_tile read MN-major; the caller commits.
template <int D, int N>
__device__ __forceinline__ void update(float (&o)[D / 2],
                                       const uint32_t (&pa)[kKeys / 16][4],
                                       uint32_t v_tile) {
#pragma unroll
  for (int kk = 0; kk < N / 16; ++kk) {
    const uint64_t db = make_desc(v_tile + 16 * kRow * kk, kKeys * kRow, 1024);
    if constexpr (D == 64) {
      sm90::wgmma_rs_n64(o, pa[kk], db);
    } else {
      sm90::wgmma_rs_n128(o, pa[kk], db);
    }
  }
}

// One tile's softmax from its scores s (N keys, `valid` of them before S):
// the rows' new maxima m (raw scores), o and l rescaled by exp2 of the
// maxima's move, p = exp2(s scale log2 e - m scale log2 e) added to l (this
// thread's columns; the quad sums at the end) and rounded to bf16 into the
// A fragments pa. o's products must have retired.
template <int D, int N>
__device__ __forceinline__ void softmax(float (&s)[N / 2], float (&o)[D / 2],
                                        float (&m)[2], float (&l)[2],
                                        uint32_t (&pa)[kKeys / 16][4],
                                        int valid, float sl2, int t) {
  if (valid < N) {
#pragma unroll
    for (int j = 0; j < N / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        if (8 * j + 2 * t + (e & 1) >= valid) s[4 * j + e] = -INFINITY;
  }
  float mx[2] = {m[0], m[1]};
#pragma unroll
  for (int i = 0; i < N / 2; ++i)
    mx[(i / 2) % 2] = fmaxf(mx[(i / 2) % 2], s[i]);
  float msl[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
    // every tile holds a key before S, so mx is finite; ex2(-inf) = 0
    msl[r] = mx[r] * sl2;
    const float alpha = ex2(fmaf(m[r], sl2, -msl[r]));
    m[r] = mx[r];
    l[r] *= alpha;
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      o[4 * j + 2 * r] *= alpha;
      o[4 * j + 2 * r + 1] *= alpha;
    }
  }
#pragma unroll
  for (int i = 0; i < N / 2; ++i) {
    s[i] = ex2(fmaf(s[i], sl2, -msl[(i / 2) % 2]));
    l[(i / 2) % 2] += s[i];
  }
#pragma unroll
  for (int kk = 0; kk < N / 16; ++kk)
    flash::acc_to_a(pa[kk], s + 8 * kk, s + 8 * kk + 4);
}

// Issues o += p v over the NP keys of one ring tile (NP = 0: none) and the
// scores of the NS keys of the next (NS = 0: none), and waits for both; q
// in R-row boxes.
template <int D, int NP, int NS, int R>
__device__ __forceinline__ void products(float (&o)[D / 2],
                                         uint32_t (&pa)[kKeys / 16][4],
                                         float (&s)[NS ? NS / 2 : 1],
                                         uint32_t q_tile, uint32_t v_tile,
                                         uint32_t k_next) {
  sm90::fence_operand(o);
  sm90::fence_operand(s);
  sm90::fence_frags(pa);
  sm90::wgmma_fence();
  if constexpr (NP != 0) update<D, NP>(o, pa, v_tile);
  if constexpr (NS != 0) scores<D, NS, R>(s, q_tile, k_next);
  sm90::wgmma_commit();
  sm90::wgmma_wait<0>();
  sm90::fence_operand(o);
  sm90::fence_operand(s);
  sm90::fence_frags(pa);
}

// f(width) for a tile with `valid` keys before S: the whole tile, or 80, 64
// or 16 keys in a narrow last one (S = 577 leaves 65, 1,025 leaves 1).
template <typename F>
__device__ __forceinline__ void by_width(int valid, F&& f) {
  if (valid > 80) {
    f(std::integral_constant<int, kKeys>{});
  } else if (valid > 64) {
    f(std::integral_constant<int, 80>{});
  } else if (valid > 16) {
    f(std::integral_constant<int, 64>{});
  } else {
    f(std::integral_constant<int, 16>{});
  }
}

template <int N>
__device__ __forceinline__ void zero(float (&a)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) a[i] = 0.f;
}

// A work item is 128 query rows of one (batch, head): consumer warpgroup w
// owns rows 64 w .. 64 w + 63, their q rows in the q buffer, o, m and l in
// registers; k and v stream through the ring in kKeys-key tiles. Per tile j:
//   o += bf16(p_{j-1}) v_{j-1}, s_j = q k_j^T   (wgmma, then wait)
//   m, o, l rescaled; p_j = exp2(s_j scale log2 e - m scale log2 e)
template <int D, int C>
__global__ void __launch_bounds__(Team<C>::kThreads, 1)
    vt_flash_fwd_bf16(const __grid_constant__ Params p) {
  using L = Layout<D, C>;
  using T = Team<C>;
  constexpr int kStages = L::kStages;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (sm90::smem_u32(smem_raw) + 1023u) & ~1023u;
  const Bars<D> bars{base + L::kBarsAt};
  const int tid = threadIdx.x, wg = tid / 128, lane = tid % 32;
  const int ntiles = (p.seq + kKeys - 1) / kKeys;

  if (tid == 0) {
    for (int b = 0; b < 2; ++b) {
      sm90::mbar_init(bars.q_full(b), 1);
      sm90::mbar_init(bars.q_empty(b), 4 * C);
    }
    for (int s = 0; s < kStages; ++s) {
      sm90::mbar_init(bars.full(s), 1);
      sm90::mbar_init(bars.empty(s), 4 * C);
    }
    sm90::fence_barrier_init();
  }
  __syncthreads();

  if (wg == C) {  // producer: one thread loads, the others leave
    sm90::regs_dec<T::kProducerRegs>();
    if (tid == 128 * C) {
      int n = 0, c = 0;
      for (long long item = blockIdx.x; item < p.items;
           item += gridDim.x, ++n) {
        const int bh = (int)(item / p.blocks_per_head);
        const int blk = (int)(item % p.blocks_per_head);
        const int b = bh / p.heads, h = bh % p.heads;
        const int buf = n & 1;
        if (n >= 2) mbar_wait(bars.q_empty(buf), ((n >> 1) - 1) & 1);
        sm90::mbar_expect_tx(bars.q_full(buf), L::kQBytes);
        load_boxes<D>(base + buf * L::kQBytes, &p.q, bars.q_full(buf),
                      T::kRows, blk * T::kRows, h, b);
        for (int j = 0; j < ntiles; ++j, ++c) {
          const int s = c % kStages;
          if (c >= kStages) mbar_wait(bars.empty(s), ((c / kStages) - 1) & 1);
          const uint32_t dst = base + L::kRingAt + s * 2 * L::kTileBytes;
          sm90::mbar_expect_tx(bars.full(s), 2 * L::kTileBytes);
          load_boxes<D>(dst, &p.k, bars.full(s), kKeys, j * kKeys, h, b);
          load_boxes<D>(dst + L::kTileBytes, &p.v, bars.full(s), kKeys,
                        j * kKeys, h, b);
        }
      }
    }
    return;
  }

  sm90::regs_inc<T::kConsumerRegs>();
  // the warpgroup through a shuffle, so that ptxas sees it warp-uniform:
  // taken from threadIdx alone, ptxas serialised the products under the
  // branches on it (warning C7518)
  const int cw = __shfl_sync(0xffffffffu, wg, 0);
  const int wq = (tid / 32) % 4, g = lane / 4, t = lane % 4;
  const float sl2 = p.scale_log2;
  auto k_tile = [&](int c) {
    return base + L::kRingAt + (c % kStages) * 2 * L::kTileBytes;
  };
  int n = 0, c = 0;
  float o[D / 2];
  uint32_t pa[kKeys / 16][4] = {};
  for (long long item = blockIdx.x; item < p.items; item += gridDim.x, ++n) {
    const int bh = (int)(item / p.blocks_per_head);
    const int blk = (int)(item % p.blocks_per_head);
    const int buf = n & 1;
    const uint32_t qt = base + buf * L::kQBytes + cw * 64 * kRow;
    const int row0 = blk * T::kRows + cw * 64;
    // A warpgroup whose rows all lie past S computes nothing, but waits
    // for every tile and releases it, as the ring's count asks.
    const bool active = row0 < p.seq;
    float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
    zero(o);
    mbar_wait(bars.q_full(buf), (n >> 1) & 1);
    // the first tile's scores, and its softmax
    mbar_wait(bars.full(c % kStages), (c / kStages) & 1);
    if (active) {
      by_width(p.seq, [&](auto ws) {
        constexpr int NS = decltype(ws)::value;
        float s[NS / 2];
        products<D, 0, NS, T::kRows>(o, pa, s, qt, 0, k_tile(c));
        softmax<D, NS>(s, o, m, l, pa, p.seq, sl2, t);
      });
    }
    for (int j = 0; j < ntiles; ++j, ++c) {
      const uint32_t vt = k_tile(c) + L::kTileBytes;
      const int valid = p.seq - j * kKeys;   // keys of tile j before S
      const int valid_next = valid - kKeys;  // of tile j + 1
      if (valid_next > 0) {  // tile j is whole
        mbar_wait(bars.full((c + 1) % kStages), ((c + 1) / kStages) & 1);
        if (active) {
          by_width(valid_next, [&](auto ws) {
            constexpr int NS = decltype(ws)::value;
            float s[NS / 2];
            products<D, kKeys, NS, T::kRows>(o, pa, s, qt, vt,
                                             k_tile(c + 1));
            softmax<D, NS>(s, o, m, l, pa, valid_next, sl2, t);
          });
        }
      } else if (active) {
        by_width(valid, [&](auto wp) {
          float none[1];
          products<D, decltype(wp)::value, 0, T::kRows>(o, pa, none, qt, vt,
                                                        0);
        });
      }
      if (lane == 0) mbar_arrive(bars.empty(c % kStages));
    }
    if (lane == 0) mbar_arrive(bars.q_empty(buf));
    if (active) {
      bf16* const out = p.o + (long long)bh * p.seq * D;
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
        l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
        const int row = row0 + 16 * wq + g + 8 * r;
        if (row < p.seq) {
          const float inv = 1.f / l[r];
#pragma unroll
          for (int j = 0; j < D / 8; ++j)
            *reinterpret_cast<__nv_bfloat162*>(out + (long long)row * D +
                                               8 * j + 2 * t) =
                __floats2bfloat162_rn(o[4 * j + 2 * r] * inv,
                                      o[4 * j + 2 * r + 1] * inv);
          if (t == 0)
            p.lse[(long long)bh * p.seq + row] =
                (m[r] * sl2 + log2f(l[r])) * kLn2;
        }
      }
    }
  }
}

// Launches vt_flash_fwd_bf16<D, C> over min(items, the blocks the card
// holds at once) persistent blocks.
template <int D, int C>
cudaError_t launch(Params& p, int bh, cudaStream_t stream) {
  auto kernel = vt_flash_fwd_bf16<D, C>;
  constexpr int smem = Layout<D, C>::kBytes, threads = Team<C>::kThreads;
  static int resident[64] = {};  // blocks the device holds, once a device
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 0 || dev >= 64) return cudaErrorInvalidDevice;
  if (!resident[dev]) {
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
    int per_sm = 0, sms = 0;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                        threads, smem);
    if (err != cudaSuccess) return err;
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return err;
    if (per_sm < 1) return cudaErrorLaunchOutOfResources;
    resident[dev] = per_sm * sms;
  }
  p.blocks_per_head = (p.seq + Team<C>::kRows - 1) / Team<C>::kRows;
  p.items = (long long)bh * p.blocks_per_head;
  const int grid = p.items < resident[dev] ? (int)p.items : resident[dev];
  kernel<<<grid, threads, smem, stream>>>(p);
  return cudaGetLastError();
}

// The consumer warpgroups a block for a call: three at D = 64 unless they
// leave more warpgroups with no row in a head's last item than two do
// (S = 577 = 3 x 192 + 1 leaves two of three idle there, and two
// warpgroups none: PERF.md §6 measures both sides).
inline int consumers(int seq, int d) {
  if (d != 64) return 2;
  const int units = (seq + 63) / 64;  // 64-row slices of a head
  auto idle = [units](int c) { return (units + c - 1) / c * c - units; };
  return idle(3) <= idle(2) ? 3 : 2;
}

// The bf16 call: its tensor maps, then the launch. -1 when the driver
// refuses a map.
int run(const Args& a, int batch, int d, cudaStream_t stream) {
  Params p{};
  const int c = consumers(a.seq, d);
  const flash::Tensor4* in[3] = {&a.q, &a.k, &a.v};
  CUtensorMap* maps[3] = {&p.q, &p.k, &p.v};
  for (int i = 0; i < 3; ++i)
    if (!sm90::make_map_bhsd(maps[i], in[i]->ptr, batch, a.heads, a.seq, d,
                             in[i]->sb, in[i]->sh, in[i]->ss,
                             i == 0 ? 64 * c : kKeys))
      return -1;
  p.o = static_cast<bf16*>(a.out0);
  p.lse = a.lse_out;
  p.heads = a.heads;
  p.seq = a.seq;
  p.scale_log2 = a.scale_log2;
  const int bh = batch * a.heads;
  if (d == 128) return (int)launch<128, 2>(p, bh, stream);
  return c == 3 ? (int)launch<64, 3>(p, bh, stream)
                : (int)launch<64, 2>(p, bh, stream);
}

}  // namespace fwd

// ---- f32 (3xTF32 on mma.sync) ----------------------------------------------

namespace f32 {

constexpr int kRows = 64;  // query rows a block: 4 warps of 16 (one m16 each)
constexpr int kThreads = 128;

template <int D>
__host__ __device__ constexpr int walk_keys() {  // keys of a walked tile
  return D == 64 ? 32 : 16;                      // (registers at D = 128)
}

// k and v double-buffered [2][2][W][D + 4]; at D = 128 q split into hi
// and lo [2][kRows][D + 4] (at D = 64 q's fragments stay in registers)
template <int D>
constexpr int smem_bytes() {
  return (4 * walk_keys<D>() * (D + 4) + (D == 64 ? 0 : 2 * kRows * (D + 4))) *
         static_cast<int>(sizeof(float));
}

// The A fragments (hi, lo) of q's rows row0 + g, + 8 over depth slice kc,
// for every kc: D = 64 keeps them in registers for the whole walk.
template <int D>
__device__ __forceinline__ void q_frags(uint32_t (&hi)[D / 8][4],
                                        uint32_t (&lo)[D / 8][4],
                                        const float* qg, long long ss,
                                        int row0, int seq, int lane) {
  const int g = lane / 4, t = lane % 4;
#pragma unroll
  for (int kc = 0; kc < D / 8; ++kc)
#pragma unroll
    for (int i = 0; i < 4; ++i) {  // a0 (g, t), a1 (g+8, t), a2 (g, t+4), a3
      const int row = row0 + g + 8 * (i & 1), col = kc * 8 + t + 4 * (i >> 1);
      flash::split_tf32(row < seq ? qg[row * ss + col] : 0.f, hi[kc][i],
                        lo[kc][i]);
    }
}

template <int D>
__global__ void __launch_bounds__(kThreads) vt_flash_fwd_f32(Args a) {
  using namespace flash;
  constexpr int W = walk_keys<D>(), P = D + 4, TILE = W * P;
  constexpr bool kQRegs = D == 64;
  extern __shared__ float4 smem4[];
  float* const raw = reinterpret_cast<float*>(smem4);  // [2][k, v][TILE]
  float* const q_hi = raw + 4 * TILE;  // D = 128: [kRows][P], then q_lo
  float* const q_lo = q_hi + kRows * P;

  const int tid = threadIdx.x, lane = tid % 32, t = lane % 4;
  const int r0 = (tid / 32) * 16;
  const int q0 = blockIdx.x * kRows, bh = a.bh0 + blockIdx.y, seq = a.seq;
  const float* const kg = head_ptr<float>(a.k, bh, a.heads);
  const float* const vg = head_ptr<float>(a.v, bh, a.heads);
  const float* const qg = head_ptr<float>(a.q, bh, a.heads);
  auto load_tile = [&](int j) {
    float* const dst = raw + (j & 1) * 2 * TILE;
    load_rows<float, W, D, P, kThreads>(dst, kg, a.k.ss, j * W, seq, tid);
    load_rows<float, W, D, P, kThreads>(dst + TILE, vg, a.v.ss, j * W, seq,
                                        tid);
  };
  load_tile(0);
  cp_async_commit();

  uint32_t qh[kQRegs ? D / 8 : 1][4], ql[kQRegs ? D / 8 : 1][4];
  if constexpr (kQRegs) {
    q_frags<D>(qh, ql, qg, a.q.ss, q0 + r0, seq, lane);
  } else {  // split once into shared memory, read by the first sync
#pragma unroll 4
    for (int c = tid; c < kRows * D / 4; c += kThreads) {
      const int r = c / (D / 4), col = (c % (D / 4)) * 4;
      const float4 x =
          q0 + r < seq
              ? *reinterpret_cast<const float4*>(qg + (q0 + r) * a.q.ss + col)
              : make_float4(0.f, 0.f, 0.f, 0.f);
      uint4 h, l;
      split_tf32(x.x, h.x, l.x);
      split_tf32(x.y, h.y, l.y);
      split_tf32(x.z, h.z, l.z);
      split_tf32(x.w, h.w, l.w);
      *reinterpret_cast<uint4*>(q_hi + r * P + col) = h;
      *reinterpret_cast<uint4*>(q_lo + r * P + col) = l;
    }
  }

  float o[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};

  const int ntiles = (seq + W - 1) / W;
  for (int j = 0; j < ntiles; ++j) {
    if (j + 1 < ntiles) {
      load_tile(j + 1);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();  // tile j landed (and, at D = 128, q's split)
    const float* const kt = raw + (j & 1) * 2 * TILE;
    const float* const vt = kt + TILE;

    // s = q k^T for this warp's 16 rows x W keys: the small passes (hi lo,
    // lo hi) in s_lo, hi hi in s
    float s[W / 8][4], s_lo[W / 8][4];
#pragma unroll
    for (int n = 0; n < W / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = s_lo[n][e] = 0.f;
#pragma unroll
    for (int kc = 0; kc < D / 8; ++kc) {
      uint32_t ah[4], al[4];
      if constexpr (kQRegs) {
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          ah[i] = qh[kc][i];
          al[i] = ql[kc][i];
        }
      } else {
        load_a_tf32<P>(ah, q_hi, r0, kc * 8, lane);
        load_a_tf32<P>(al, q_lo, r0, kc * 8, lane);
      }
#pragma unroll
      for (int n = 0; n < W / 8; ++n) {
        uint32_t bh[2], bl[2];
        load_b_nk_tf32<P>(bh, bl, kt, n * 8, kc * 8, lane);
        mma_tf32(s_lo[n], ah, bl[0], bl[1]);
        mma_tf32(s_lo[n], al, bh[0], bh[1]);
        mma_tf32(s[n], ah, bh[0], bh[1]);
      }
    }

    // mask, the rows' new maxima, o and l rescaled, p
    const int valid = seq - j * W;
    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int n = 0; n < W / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float x = s[n][e] + s_lo[n][e];
        s[n][e] = n * 8 + 2 * t + (e & 1) < valid ? x : -INFINITY;
        mx[e / 2] = fmaxf(mx[e / 2], s[n][e]);
      }
    float msl[2], alpha[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      msl[r] = mx[r] * a.scale_log2;  // finite: the tile holds a key before S
      alpha[r] = ex2(fmaf(m[r], a.scale_log2, -msl[r]));
      m[r] = mx[r];
      l[r] *= alpha[r];
    }
#pragma unroll
    for (int n = 0; n < W / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[n][e] = ex2(fmaf(s[n][e], a.scale_log2, -msl[e / 2]));
        l[e / 2] += s[n][e];
      }

    // this tile's p v summed from zero, then o = o alpha + p v in f32
    float pv[D / 8][4];
#pragma unroll
    for (int n = 0; n < D / 8; ++n)
      pv[n][0] = pv[n][1] = pv[n][2] = pv[n][3] = 0.f;
#pragma unroll
    for (int kc = 0; kc < W / 8; ++kc) {
      uint32_t ah[4], al[4];
      acc_to_a_tf32(ah, al, s[kc]);
#pragma unroll
      for (int n = 0; n < D / 8; ++n) {
        uint32_t bh[2], bl[2];
        load_b_kn_tf32<P>(bh, bl, vt, kc * 8, n * 8, lane);
        mma_3xtf32(pv[n], ah, al, bh, bl);
      }
    }
#pragma unroll
    for (int n = 0; n < D / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        o[n][e] = fmaf(o[n][e], alpha[e / 2], pv[n][e]);
    __syncthreads();  // every warp is done with the buffer refilled next
  }

  float* const og = static_cast<float*>(a.out0) + (long long)bh * seq * D;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    const int row = q0 + r0 + lane / 4 + 8 * r;
    if (row < seq) {
      const float inv = 1.f / l[r];
#pragma unroll
      for (int n = 0; n < D / 8; ++n)
        *reinterpret_cast<float2*>(og + (long long)row * D + n * 8 + 2 * t) =
            make_float2(o[n][2 * r] * inv, o[n][2 * r + 1] * inv);
      if (t == 0)
        a.lse_out[(long long)bh * seq + row] =
            (m[r] * a.scale_log2 + log2f(l[r])) * kLn2;
    }
  }
}

template <int D>
cudaError_t launch(const Args& a, int bh, cudaStream_t stream) {
  return flash::launch_heads(vt_flash_fwd_f32<D>, smem_bytes<D>(),
                             (a.seq + kRows - 1) / kRows, bh, kThreads, a,
                             stream);
}

}  // namespace f32

}  // namespace

extern "C" int vt_flash_attention_forward(
    const void* q, const void* k, const void* v, void* o, void* lse,
    int batch, int heads, int seq, int d, long long q_sb, long long q_sh,
    long long q_ss, long long k_sb, long long k_sh, long long k_ss,
    long long v_sb, long long v_sh, long long v_ss, float scale, int bf16,
    cudaStream_t stream) {
  const int bh = batch * heads;
  if (bh == 0 || seq == 0) return cudaSuccess;
  if (d != 64 && d != 128) return cudaErrorInvalidValue;
  Args a{};
  a.q = {q, q_sb, q_sh, q_ss};
  a.k = {k, k_sb, k_sh, k_ss};
  a.v = {v, v_sb, v_sh, v_ss};
  a.out0 = o;
  a.lse_out = static_cast<float*>(lse);
  a.heads = heads;
  a.seq = seq;
  a.scale = scale;
  a.scale_log2 = scale * flash::kLog2e;
  if (bf16) return fwd::run(a, batch, d, stream);
  return d == 64 ? f32::launch<64>(a, bh, stream)
                 : f32::launch<128>(a, bh, stream);
}
