// Flash attention, backward: the gradients of o = softmax(scale q k^T) v
// from do, the forward's row statistic lse = m + log(l) and di = sum(o do)
// over the head dim (a torch reduction, as JAX takes it outside its
// kernels). Two kernels, as in JAX's library:
//
//   dk, dv  (vt_flash_attention_dkv)  replaces _flash_attention_bwd_dkv's
//            pallas_call, jax/experimental/pallas/ops/tpu/flash_attention.py
//            :1121 (body l.894-918)
//   dq      (vt_flash_attention_dq)   replaces _flash_attention_bwd_dq's
//            pallas_call, the same file :1456 (body l.1225-1261)
//
// both reached from vision_tpu/ops/attention.py:80 under jax.grad. Each
// recomputes p = exp(scale q k^T - lse), then
//   dv = p^T do    (p rounded to do's type)
//   ds = p (do v^T - di) scale
//   dk = ds^T q    (ds rounded to do's type)       dq = ds k  (ds rounded)
// with f32 sums, each gradient rounded once to its input's type.
//
// What bounds them on an H100: the products, 8 B H S^2 D operations for
// dk, dv (q k^T, do v^T, p^T do, ds^T q) and 6 B H S^2 D for dq (q k^T,
// do v^T, ds k), at 989 TFLOP/s in bf16 and, in f32, three TF32 products
// each at 495 (165 TFLOP/s of f32-accurate products, against 67 on the
// FP32 units), and one exponential a score in each at ~3.9e12 a second.
// The bytes are far below.
//
// Design: no atomics, so the same inputs give the same bits on every call
// (the repo's backward kernels keep to that). The dk/dv kernel gives a
// block's keys to it alone and walks every query tile in order, summing dk
// and dv in registers; the dq kernel gives a block's query rows to it alone
// and walks every key tile in order. Rows past S are never stored.
// * bf16 (sm_90a; redesigned from a first mma.sync design): persistent
//   blocks, as many as the card holds at once (one an SM), each walking
//   work items of 128 rows of one (batch, head), with 384 threads: two
//   consumer warpgroups of 64 rows each and a producer warpgroup, whose
//   one working warp keeps the loads in flight and gives its registers to
//   the consumers (setmaxnreg: 40 against 232). The item's own rows (k and
//   v, or q and do) arrive once by TMA into one of two buffers, so the
//   next item's load overlaps this one's walk; the walked tensors stream
//   in 64-row tiles through a ring of TMA stages on mbarriers (4 at D = 64,
//   2 at D = 128), released by each consumer warp when its products have
//   read them. The tensor maps are 4-D over (D, S, H, B) with the views'
//   own strides: rows past S load as zeros and a box never reaches into the
//   next head. lse and di (S * 4 bytes a head, not a multiple of 16: no
//   TMA) come by 4-byte cp.async into the stage (dk/dv) or the fixed
//   buffer (dq), completing on the same mbarrier. Every product is
//   wgmma.mma_async: s and dp (m64n64k16) with both operands from shared
//   memory; p and ds become bf16 A fragments in registers (the
//   accumulator layout is the A layout) for dv += p^T do, dk += ds^T q and
//   dq += ds k, whose B (do, q or k) is read MN-major from the same tile.
//   p = ex2.approx(fma(s, scale log2 e, -lse log2 e)); the mask (p = 0 past
//   S) runs in the last tile only: there the zero-filled rows give s = 0
//   and would add exp(-lse) terms. A last tile with at most 16 valid rows
//   (S = 577 leaves 1) runs as 16 rows: s and dp on m64n16k16, the update
//   one 16-deep step. Tried and not kept (PERF.md §6): the next tile's
//   s and dp issued before this tile's update (ptxas serialises the
//   products; slower); the two consumer warpgroups taking turns to issue
//   (no faster); at D = 64 the fixed rows as register A fragments for s
//   and dp (wrong after the first tile); two blocks an SM (the consumers'
//   registers leave room for one).
// * f32 (redesigned from a first design on the FP32 units, a row on D / 16
//   threads): every product on the tensor cores as three TF32 products,
//   mma.sync m16n8k8 a_hi b_lo + a_lo b_hi + a_hi b_hi into f32 sums
//   (flash_common.cuh: hi rounded to tf32 on the bits, lo = x - hi read
//   truncated by the tensor core), whatever
//   torch.backends.cuda.matmul.allow_tf32 says: ~2^-21 of each product, f32
//   accuracy, held to the plain f32 versions at 1e-4 of the largest
//   gradient (one TF32 product alone reads 5e-4 to 1e-3 in a CPU
//   emulation). What bounds them now: the three passes, on mma.sync, whose
//   TF32 rate on this card is ~300-320 TFLOP/s (tools/tf32_probe.py; 495
//   is wgmma's),
//   and the instructions around them: each walked element is split into hi
//   and lo as its fragment is read (an add, a mask and a subtraction), and
//   the exponentials. A block of 4 warps owns 64 fixed rows (keys in dk/dv,
//   queries in dq), 16 a warp (one m16 slice); those rows arrive once,
//   split into hi and lo arrays in shared memory. The walked tensors (q and
//   do with lse and di, or k and v) stream in tiles of 32 rows (16 at D =
//   128, for registers) double-buffered by cp.async; lse and di of dq's
//   own rows sit in registers. Shared rows have a pitch of D + 4 floats, so
//   every fragment read is free of bank conflicts (score products' B: bank
//   4g + t; updates' B: 8t + g). The fragment permutation: p and ds become
//   the update's A operand in place, a thread's accumulator columns 2t and
//   2t + 1 taken as depth slots t and t + 4; the update's B then reads rows
//   2t and 2t + 1 of each 8-deep slice (load_b_kn_tf32) in place of rows t
//   and t + 4. The sums: the tensor core truncates each sum it returns, so
//   the score products keep their small passes in sums of their own and dp
//   - di restarts its big sum every second step (scores); exp2 runs once a
//   score; p = 0 past S. 105 KB of shared memory a block at D = 64 (two
//   blocks an SM), 169 KB at D = 128 (one).

#include "flash_common.cuh"
#include "sm90_common.cuh"

namespace {

using bf16 = __nv_bfloat16;
using flash::Args;

// ---- bf16 (sm_90a: wgmma, TMA) ---------------------------------------------

namespace bwd {

using flash::kLog2e;
using sm90::make_desc;
using sm90::mbar_arrive;
using sm90::mbar_wait;

constexpr int kFixed = 128;    // rows a work item owns: keys (dk/dv), queries (dq)
constexpr int kStream = 64;    // rows a streamed tile: queries (dk/dv), keys (dq)
constexpr int kThreads = 384;  // consumer warpgroups 0 and 1, producer 2
constexpr int kProducerRegs = 40;
constexpr int kConsumerRegs = 232;  // 128 x 40 + 256 x 232 <= 65,536
constexpr int kRow = 128;           // bytes of a box row: 64 bf16

template <int D>
struct Layout {  // bytes from the 1024-aligned base of shared memory
  static constexpr int kFixedBytes = kFixed * D * 2;    // one fixed tensor
  static constexpr int kStreamBytes = kStream * D * 2;  // one streamed tensor
  static constexpr int kStages = D == 64 ? 4 : 2;       // the streamed ring
  // fixed tiles: 2 buffers x 2 tensors; the ring: stages x 2 tensors; row
  // statistics (lse, di): a slot of 2 x kFixed floats a fixed buffer
  // (dq) and a stage (dk/dv); the barriers
  static constexpr int kRingAt = 4 * kFixedBytes;
  static constexpr int kStatsAt = kRingAt + 2 * kStages * kStreamBytes;
  static constexpr int kSlot = 2 * kFixed;  // floats
  static constexpr int kBarsAt = kStatsAt + (2 + kStages) * kSlot * 4;
  static constexpr int kBytes = kBarsAt + 8 * (4 + 2 * kStages) + 1024;
};

struct Params {
  CUtensorMap fixed0, fixed1;    // k, v (dk/dv) or q, do (dq): kFixed-row boxes
  CUtensorMap stream0, stream1;  // q, do (dk/dv) or k, v (dq): kStream-row boxes
  const float* lse;              // [B, H, S]
  const float* di;               // [B, H, S]
  bf16* out0;                    // dk or dq, contiguous [B, H, S, D]
  bf16* out1;                    // dv
  long long items;               // B H blocks_per_head
  int heads, seq, blocks_per_head;
  float scale, scale_log2;
};

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// The barriers: fixed buffer b full (0, 1) and empty (2, 3); ring stage s
// full (4 + s) and empty (4 + kStages + s).
template <int D>
struct Bars {
  uint32_t base;
  __device__ uint32_t fix_full(int b) const { return base + 8 * b; }
  __device__ uint32_t fix_empty(int b) const { return base + 8 * (2 + b); }
  __device__ uint32_t full(int s) const { return base + 8 * (4 + s); }
  __device__ uint32_t empty(int s) const {
    return base + 8 * (4 + Layout<D>::kStages + s);
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
// 4 g + t.

// Stores one warpgroup's 64 x D f32 sums, rounded to bf16, as rows
// row0 .. row0 + 63 of one head of a contiguous [S, D] output; rows at or
// past seq are not stored.
template <int D>
__device__ __forceinline__ void store_rows(bf16* out, const float (&acc)[D / 2],
                                           int row0, int seq, int wq, int lane) {
  const int g = lane / 4, t = lane % 4;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + 16 * wq + g + 8 * r;
    if (row < seq) {
#pragma unroll
      for (int j = 0; j < D / 8; ++j)
        *reinterpret_cast<__nv_bfloat162*>(out + (long long)row * D + 8 * j +
                                           2 * t) =
            __floats2bfloat162_rn(acc[4 * j + 2 * r], acc[4 * j + 2 * r + 1]);
    }
  }
}

template <int N>
__device__ __forceinline__ void zero(float (&a)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) a[i] = 0.f;
}

// p = exp(scale s - lse) from s (N columns) in place, given lse * log2 e
// of this thread's columns (lse2[j]: columns 8 j + 2 t and + 1); zero at
// columns at or past `valid`.
template <int N>
__device__ __forceinline__ void probs_by_column(float (&s)[N / 2],
                                                const float2 (&lse2)[N / 8],
                                                float sl2, int valid, int t) {
#pragma unroll
  for (int j = 0; j < N / 8; ++j) {
    const float2 l = lse2[j];
#pragma unroll
    for (int e = 0; e < 4; ++e)
      s[4 * j + e] = ex2(fmaf(s[4 * j + e], sl2, -((e & 1) ? l.y : l.x)));
  }
  if (valid < N) {
#pragma unroll
    for (int j = 0; j < N / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        if (8 * j + 2 * t + (e & 1) >= valid) s[4 * j + e] = 0.f;
  }
}

// p = exp(scale s - lse) from s (N columns) in place, given lse * log2 e
// of this thread's two rows; zero at columns at or past `valid`.
template <int N>
__device__ __forceinline__ void probs_by_row(float (&s)[N / 2],
                                             const float (&lse2)[2], float sl2,
                                             int valid, int t) {
#pragma unroll
  for (int i = 0; i < N / 2; ++i)
    s[i] = ex2(fmaf(s[i], sl2, -lse2[(i / 2) % 2]));
  if (valid < N) {
#pragma unroll
    for (int j = 0; j < N / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        if (8 * j + 2 * t + (e & 1) >= valid) s[4 * j + e] = 0.f;
  }
}

// N / 16 bf16 A fragments (16-deep slices) from N / 2 f32 sums.
template <int N>
__device__ __forceinline__ void to_frags(uint32_t (&a)[N / 16][4],
                                         const float (&c)[N / 2]) {
#pragma unroll
  for (int kk = 0; kk < N / 16; ++kk)
    flash::acc_to_a(a[kk], c + 8 * kk, c + 8 * kk + 4);
}

template <int D>
__device__ __forceinline__ void product_d(float (&d)[D / 2],
                                          const uint32_t (&a)[4],
                                          uint64_t db) {
  if constexpr (D == 64) {
    sm90::wgmma_rs_n64(d, a, db);
  } else {
    sm90::wgmma_rs_n128(d, a, db);
  }
}

// s = a b^T or dp = a b^T over the head dim (one committed group): a
// from the fixed tile at a_tile (kFixed-row boxes), b the first N rows of
// the ring stage at b_tile (kStream-row boxes), both K-major.
template <int D, int N>
__device__ __forceinline__ void score_product(float (&d)[N / 2],
                                              uint32_t a_tile, uint32_t b_tile) {
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const uint64_t da = make_desc(a_tile + kmajor(kk, kFixed), 16, 1024);
    const uint64_t db = make_desc(b_tile + kmajor(kk, kStream), 16, 1024);
    if constexpr (N == 64) {
      sm90::wgmma_ss_n64(d, da, db, kk);
    } else {
      sm90::wgmma_ss_n16(d, da, db, kk);
    }
  }
  sm90::wgmma_commit();
}

// d += a b over the first N rows of a ring tile (the depth of the product):
// a the N / 16 fragments, b the tile at `tile` read MN-major; the caller
// commits.
template <int D, int N>
__device__ __forceinline__ void update(float (&d)[D / 2],
                                       uint32_t (&a)[N / 16][4], uint32_t tile) {
#pragma unroll
  for (int kk = 0; kk < N / 16; ++kk)
    product_d<D>(d, a[kk], make_desc(tile + 16 * kRow * kk, kStream * kRow, 1024));
}

// One ring tile of the dk/dv walk: its first N queries (64, or 16 when
// the tile holds no more valid ones), s and dp in the given sums.
template <int D, int N>
__device__ __forceinline__ void dkv_tile(float (&s)[N / 2], float (&dp)[N / 2],
                                         float (&dk)[D / 2], float (&dv)[D / 2],
                                         uint32_t kt, uint32_t vt, uint32_t qt,
                                         uint32_t dt, const float* st, int valid,
                                         const Params& p, int t) {
  sm90::fence_operand(s);
  sm90::fence_operand(dp);
  sm90::wgmma_fence();
  score_product<D, N>(s, kt, qt);
  score_product<D, N>(dp, vt, dt);
  // lse times log2 e of this thread's columns 8 j + 2 t, + 1
  float2 lse2[N / 8];
#pragma unroll
  for (int j = 0; j < N / 8; ++j) {
    const float2 l = reinterpret_cast<const float2*>(st)[4 * j + t];
    lse2[j] = make_float2(l.x * kLog2e, l.y * kLog2e);
  }
  sm90::wgmma_wait<1>();
  sm90::fence_operand(s);
  probs_by_column<N>(s, lse2, p.scale_log2, valid, t);
  sm90::wgmma_wait<0>();
  sm90::fence_operand(dp);
  const float2* const di2 = reinterpret_cast<const float2*>(st + kFixed);
#pragma unroll
  for (int j = 0; j < N / 8; ++j) {
    const float2 d = di2[4 * j + t];
#pragma unroll
    for (int e = 0; e < 4; ++e)
      dp[4 * j + e] =
          s[4 * j + e] * (dp[4 * j + e] - ((e & 1) ? d.y : d.x)) * p.scale;
  }
  uint32_t pa[N / 16][4], da[N / 16][4];
  to_frags<N>(pa, s);
  to_frags<N>(da, dp);
  sm90::fence_operand(dk);
  sm90::fence_operand(dv);
  sm90::fence_frags(pa);
  sm90::fence_frags(da);
  sm90::wgmma_fence();
  update<D, N>(dv, pa, dt);
  update<D, N>(dk, da, qt);
  sm90::wgmma_commit();
  sm90::wgmma_wait<0>();
  sm90::fence_operand(dk);
  sm90::fence_operand(dv);
  sm90::fence_frags(pa);
  sm90::fence_frags(da);
}

// One ring tile of the dq walk: its first N keys (64, or 16 when the tile
// holds no more valid ones), s and dp in the given sums.
template <int D, int N>
__device__ __forceinline__ void dq_tile(float (&s)[N / 2], float (&dp)[N / 2],
                                        float (&dq)[D / 2], uint32_t qt,
                                        uint32_t dt, uint32_t kt, uint32_t vt,
                                        const float (&lse2)[2],
                                        const float (&di)[2], int valid,
                                        const Params& p, int t) {
  sm90::fence_operand(s);
  sm90::fence_operand(dp);
  sm90::wgmma_fence();
  score_product<D, N>(s, qt, kt);
  score_product<D, N>(dp, dt, vt);
  sm90::wgmma_wait<1>();
  sm90::fence_operand(s);
  probs_by_row<N>(s, lse2, p.scale_log2, valid, t);
  sm90::wgmma_wait<0>();
  sm90::fence_operand(dp);
#pragma unroll
  for (int i = 0; i < N / 2; ++i)
    dp[i] = s[i] * (dp[i] - di[(i / 2) % 2]) * p.scale;
  uint32_t da[N / 16][4];
  to_frags<N>(da, dp);
  sm90::fence_operand(dq);
  sm90::fence_frags(da);
  sm90::wgmma_fence();
  update<D, N>(dq, da, kt);
  sm90::wgmma_commit();
  sm90::wgmma_wait<0>();
  sm90::fence_operand(dq);
  sm90::fence_frags(da);
}

// dk, dv. A work item is 128 keys of one (batch, head): consumer
// warpgroup w owns keys 64 w .. 64 w + 63 of it, their k and v rows in
// the fixed buffer, dk and dv in registers; q and do stream through the
// ring in 64-query tiles with lse and di. Per tile:
//   s^T = k q^T, dp^T = v do^T         (wgmma, both from shared memory)
//   p^T = exp2(s^T scale log2 e - lse log2 e), zero past S (last tile)
//   ds^T = p^T (dp^T - di) scale
//   dv += bf16(p^T) do, dk += bf16(ds^T) q  (A from registers, do and q
//                                            read MN-major)
template <int D>
__global__ void __launch_bounds__(kThreads, 1)
    vt_flash_dkv_bf16(const __grid_constant__ Params p) {
  using L = Layout<D>;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = sm90::smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  float* const stats = reinterpret_cast<float*>(smem_raw + (base - raw) +
                                                L::kStatsAt);
  const Bars<D> bars{base + L::kBarsAt};
  const int tid = threadIdx.x, wg = tid / 128, lane = tid % 32;
  const int ntiles = (p.seq + kStream - 1) / kStream;

  if (tid == 0) {
    for (int b = 0; b < 2; ++b) {
      sm90::mbar_init(bars.fix_full(b), 1);
      sm90::mbar_init(bars.fix_empty(b), 8);
    }
    for (int s = 0; s < L::kStages; ++s) {
      sm90::mbar_init(bars.full(s), 33);  // 32 lanes' stats + the TMA
      sm90::mbar_init(bars.empty(s), 8);
    }
    sm90::fence_barrier_init();
  }
  __syncthreads();

  if (wg == 2) {  // producer: one warp loads, the others leave
    sm90::regs_dec<kProducerRegs>();
    if (tid / 32 == 8) {
      int n = 0, c = 0;
      for (long long item = blockIdx.x; item < p.items;
           item += gridDim.x, ++n) {
        const int bh = (int)(item / p.blocks_per_head);
        const int blk = (int)(item % p.blocks_per_head);
        const int b = bh / p.heads, h = bh % p.heads;
        const int buf = n & 1;
        if (lane == 0) {
          if (n >= 2) mbar_wait(bars.fix_empty(buf), ((n >> 1) - 1) & 1);
          const uint32_t dst = base + buf * 2 * L::kFixedBytes;
          sm90::mbar_expect_tx(bars.fix_full(buf), 2 * L::kFixedBytes);
          load_boxes<D>(dst, &p.fixed0, bars.fix_full(buf), kFixed,
                        blk * kFixed, h, b);
          load_boxes<D>(dst + L::kFixedBytes, &p.fixed1, bars.fix_full(buf),
                        kFixed, blk * kFixed, h, b);
        }
        const float* const lse = p.lse + (long long)bh * p.seq;
        const float* const di = p.di + (long long)bh * p.seq;
        for (int i = 0; i < ntiles; ++i, ++c) {
          const int s = c % L::kStages;
          if (c >= L::kStages) mbar_wait(bars.empty(s), ((c / L::kStages) - 1) & 1);
          float* const st = stats + (2 + s) * L::kSlot;
#pragma unroll
          for (int r = lane; r < kStream; r += 32) {
            const int q = i * kStream + r;
            const bool ok = q < p.seq;
            flash::cp_async_4(st + r, ok ? lse + q : lse, ok);
            flash::cp_async_4(st + kFixed + r, ok ? di + q : di, ok);
          }
          sm90::mbar_arrive_cp_async(bars.full(s));
          if (lane == 0) {
            const uint32_t dst = base + L::kRingAt + s * 2 * L::kStreamBytes;
            sm90::mbar_expect_tx(bars.full(s), 2 * L::kStreamBytes);
            load_boxes<D>(dst, &p.stream0, bars.full(s), kStream, i * kStream,
                          h, b);
            load_boxes<D>(dst + L::kStreamBytes, &p.stream1, bars.full(s),
                          kStream, i * kStream, h, b);
          }
        }
      }
      asm volatile("cp.async.wait_all;\n" ::: "memory");
    }
    return;
  }

  sm90::regs_inc<kConsumerRegs>();
  const int wq = (tid / 32) % 4, t = lane % 4;
  int n = 0, c = 0;
  float sacc[32], dpacc[32], dk[D / 2], dv[D / 2];
  zero(sacc);
  zero(dpacc);
  for (long long item = blockIdx.x; item < p.items; item += gridDim.x, ++n) {
    const int bh = (int)(item / p.blocks_per_head);
    const int blk = (int)(item % p.blocks_per_head);
    const int buf = n & 1;
    // this warpgroup's 64 keys: rows 64 wg .. of the fixed boxes
    const uint32_t kt = base + buf * 2 * L::kFixedBytes + wg * 64 * kRow;
    const uint32_t vt = kt + L::kFixedBytes;
    zero(dk);
    zero(dv);
    mbar_wait(bars.fix_full(buf), (n >> 1) & 1);
    for (int i = 0; i < ntiles; ++i, ++c) {
      const int s = c % L::kStages;
      const uint32_t qt = base + L::kRingAt + s * 2 * L::kStreamBytes;
      const uint32_t dt = qt + L::kStreamBytes;
      const float* const st = stats + (2 + s) * L::kSlot;
      const int valid = p.seq - i * kStream;
      mbar_wait(bars.full(s), (c / L::kStages) & 1);
      if (valid > 16) {
        dkv_tile<D, 64>(sacc, dpacc, dk, dv, kt, vt, qt, dt, st, valid, p, t);
      } else {  // the last tile, at most 16 valid queries: a quarter of it
        float s16[8], dp16[8];
        zero(s16);
        zero(dp16);
        dkv_tile<D, 16>(s16, dp16, dk, dv, kt, vt, qt, dt, st, valid, p, t);
      }
      if (lane == 0) mbar_arrive(bars.empty(s));
    }
    if (lane == 0) mbar_arrive(bars.fix_empty(buf));
    const long long head = (long long)bh * p.seq * D;
    const int row0 = blk * kFixed + wg * 64;
    store_rows<D>(p.out0 + head, dk, row0, p.seq, wq, lane);
    store_rows<D>(p.out1 + head, dv, row0, p.seq, wq, lane);
  }
}

// dq. A work item is 128 query rows of one (batch, head): consumer
// warpgroup w owns rows 64 w .. 64 w + 63, their q and do rows in the fixed
// buffer, lse and di in registers, dq in registers; k and v stream through
// the ring in 64-key tiles. Per tile:
//   s = q k^T, dp = do v^T              (wgmma, both from shared memory)
//   p = exp2(s scale log2 e - lse log2 e), zero past S (last tile)
//   ds = p (dp - di) scale
//   dq += bf16(ds) k                     (A from registers, k MN-major)
template <int D>
__global__ void __launch_bounds__(kThreads, 1)
    vt_flash_dq_bf16(const __grid_constant__ Params p) {
  using L = Layout<D>;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = sm90::smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  float* const stats = reinterpret_cast<float*>(smem_raw + (base - raw) +
                                                L::kStatsAt);
  const Bars<D> bars{base + L::kBarsAt};
  const int tid = threadIdx.x, wg = tid / 128, lane = tid % 32;
  const int ntiles = (p.seq + kStream - 1) / kStream;

  if (tid == 0) {
    for (int b = 0; b < 2; ++b) {
      sm90::mbar_init(bars.fix_full(b), 33);  // 32 lanes' stats + the TMA
      sm90::mbar_init(bars.fix_empty(b), 8);
    }
    for (int s = 0; s < L::kStages; ++s) {
      sm90::mbar_init(bars.full(s), 1);
      sm90::mbar_init(bars.empty(s), 8);
    }
    sm90::fence_barrier_init();
  }
  __syncthreads();

  if (wg == 2) {
    sm90::regs_dec<kProducerRegs>();
    if (tid / 32 == 8) {
      int n = 0, c = 0;
      for (long long item = blockIdx.x; item < p.items;
           item += gridDim.x, ++n) {
        const int bh = (int)(item / p.blocks_per_head);
        const int blk = (int)(item % p.blocks_per_head);
        const int b = bh / p.heads, h = bh % p.heads;
        const int buf = n & 1;
        if (n >= 2) mbar_wait(bars.fix_empty(buf), ((n >> 1) - 1) & 1);
        const float* const lse = p.lse + (long long)bh * p.seq;
        const float* const di = p.di + (long long)bh * p.seq;
        float* const st = stats + buf * L::kSlot;
#pragma unroll
        for (int r = lane; r < kFixed; r += 32) {
          const int q = blk * kFixed + r;
          const bool ok = q < p.seq;
          flash::cp_async_4(st + r, ok ? lse + q : lse, ok);
          flash::cp_async_4(st + kFixed + r, ok ? di + q : di, ok);
        }
        sm90::mbar_arrive_cp_async(bars.fix_full(buf));
        if (lane == 0) {
          const uint32_t dst = base + buf * 2 * L::kFixedBytes;
          sm90::mbar_expect_tx(bars.fix_full(buf), 2 * L::kFixedBytes);
          load_boxes<D>(dst, &p.fixed0, bars.fix_full(buf), kFixed,
                        blk * kFixed, h, b);
          load_boxes<D>(dst + L::kFixedBytes, &p.fixed1, bars.fix_full(buf),
                        kFixed, blk * kFixed, h, b);
          for (int j = 0; j < ntiles; ++j, ++c) {
            const int s = c % L::kStages;
            if (c >= L::kStages)
              mbar_wait(bars.empty(s), ((c / L::kStages) - 1) & 1);
            const uint32_t dst2 = base + L::kRingAt + s * 2 * L::kStreamBytes;
            sm90::mbar_expect_tx(bars.full(s), 2 * L::kStreamBytes);
            load_boxes<D>(dst2, &p.stream0, bars.full(s), kStream, j * kStream,
                          h, b);
            load_boxes<D>(dst2 + L::kStreamBytes, &p.stream1, bars.full(s),
                          kStream, j * kStream, h, b);
          }
        }
      }
      asm volatile("cp.async.wait_all;\n" ::: "memory");
    }
    return;
  }

  sm90::regs_inc<kConsumerRegs>();
  const int wq = (tid / 32) % 4, g = lane / 4, t = lane % 4;
  int n = 0, c = 0;
  float sacc[32], dpacc[32], dq[D / 2];
  zero(sacc);
  zero(dpacc);
  for (long long item = blockIdx.x; item < p.items; item += gridDim.x, ++n) {
    const int bh = (int)(item / p.blocks_per_head);
    const int blk = (int)(item % p.blocks_per_head);
    const int buf = n & 1;
    const uint32_t qt = base + buf * 2 * L::kFixedBytes + wg * 64 * kRow;
    const uint32_t dt = qt + L::kFixedBytes;
    zero(dq);
    mbar_wait(bars.fix_full(buf), (n >> 1) & 1);
    float lse2[2], di[2];
    {
      const float* const st = stats + buf * L::kSlot;
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int row = wg * 64 + 16 * wq + g + 8 * r;
        lse2[r] = st[row] * kLog2e;
        di[r] = st[kFixed + row];
      }
    }
    for (int j = 0; j < ntiles; ++j, ++c) {
      const int s = c % L::kStages;
      const uint32_t kt = base + L::kRingAt + s * 2 * L::kStreamBytes;
      const uint32_t vt = kt + L::kStreamBytes;
      const int valid = p.seq - j * kStream;
      mbar_wait(bars.full(s), (c / L::kStages) & 1);
      if (valid > 16) {
        dq_tile<D, 64>(sacc, dpacc, dq, qt, dt, kt, vt, lse2, di, valid, p, t);
      } else {  // the last tile, at most 16 valid keys: a quarter of it
        float s16[8], dp16[8];
        zero(s16);
        zero(dp16);
        dq_tile<D, 16>(s16, dp16, dq, qt, dt, kt, vt, lse2, di, valid, p, t);
      }
      if (lane == 0) mbar_arrive(bars.empty(s));
    }
    if (lane == 0) mbar_arrive(bars.fix_empty(buf));
    store_rows<D>(p.out0 + (long long)bh * p.seq * D, dq,
                  blk * kFixed + wg * 64, p.seq, wq, lane);
  }
}

// Launches kernel<D> over min(items, the blocks the card holds at once)
// persistent blocks.
template <int D, bool kDkv>
cudaError_t launch(Params& p, int bh, cudaStream_t stream) {
  auto kernel = kDkv ? vt_flash_dkv_bf16<D> : vt_flash_dq_bf16<D>;
  constexpr int smem = Layout<D>::kBytes;
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
                                                        kThreads, smem);
    if (err != cudaSuccess) return err;
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return err;
    if (per_sm < 1) return cudaErrorLaunchOutOfResources;
    resident[dev] = per_sm * sms;
  }
  p.blocks_per_head = (p.seq + kFixed - 1) / kFixed;
  p.items = (long long)bh * p.blocks_per_head;
  const int grid =
      p.items < resident[dev] ? (int)p.items : resident[dev];
  kernel<<<grid, kThreads, smem, stream>>>(p);
  return cudaGetLastError();
}

// The bf16 call of either kernel: its tensor maps, then the launch. -1 when
// the driver refuses a map.
template <bool kDkv>
int run(const void* q, const void* k, const void* v, const void* dout,
        const void* lse, const void* di, void* out0, void* out1, int batch,
        int heads, int seq, int d, const long long* st, float scale,
        cudaStream_t stream) {
  Params p{};
  const void* fixed[2] = {kDkv ? k : q, kDkv ? v : dout};
  const void* streamed[2] = {kDkv ? q : k, kDkv ? dout : v};
  const long long* fs[2] = {kDkv ? st + 3 : st, kDkv ? st + 6 : st + 9};
  const long long* ss[2] = {kDkv ? st : st + 3, kDkv ? st + 9 : st + 6};
  CUtensorMap* fm[2] = {&p.fixed0, &p.fixed1};
  CUtensorMap* sm[2] = {&p.stream0, &p.stream1};
  for (int i = 0; i < 2; ++i) {
    if (!sm90::make_map_bhsd(fm[i], fixed[i], batch, heads, seq, d, fs[i][0],
                             fs[i][1], fs[i][2], kFixed) ||
        !sm90::make_map_bhsd(sm[i], streamed[i], batch, heads, seq, d,
                             ss[i][0], ss[i][1], ss[i][2], kStream))
      return -1;
  }
  p.lse = static_cast<const float*>(lse);
  p.di = static_cast<const float*>(di);
  p.out0 = static_cast<bf16*>(out0);
  p.out1 = static_cast<bf16*>(out1);
  p.heads = heads;
  p.seq = seq;
  p.scale = scale;
  p.scale_log2 = scale * kLog2e;
  const int bh = batch * heads;
  return d == 64 ? (int)launch<64, kDkv>(p, bh, stream)
                 : (int)launch<128, kDkv>(p, bh, stream);
}

}  // namespace bwd

// ---- f32 (3xTF32 on mma.sync) ----------------------------------------------

namespace f32 {

constexpr int kRows = 64;  // fixed rows a block: 4 warps of 16 (one m16 each)
constexpr int kThreads = 128;

template <int D>
__host__ __device__ constexpr int walk_rows() {  // rows of a walked tile
  return D == 64 ? 32 : 16;                      // (registers at D = 128)
}

// the fixed rows of two tensors split into hi and lo [4][kRows][D + 4];
// the walked tiles of two tensors double-buffered [4][W][D + 4]; dk/dv
// also lse and di [2][2][W]
template <int D, bool kDkv>
constexpr int smem_bytes() {
  return (4 * kRows * (D + 4) + 4 * walk_rows<D>() * (D + 4) +
          (kDkv ? 4 * walk_rows<D>() : 0)) *
         static_cast<int>(sizeof(float));
}

// Rows row0 .. row0 + kRows - 1 of one head ([S, D], row stride ss) split
// into tf32 hi and lo [kRows][P]; rows at or past seq are zeros.
template <int D, int P>
__device__ __forceinline__ void load_split(float* hi, float* lo,
                                           const float* g, long long ss,
                                           int row0, int seq, int tid) {
  constexpr int kPer = D / 4;  // float4 chunks a row
#pragma unroll 4
  for (int c = tid; c < kRows * kPer; c += kThreads) {
    const int r = c / kPer, col = (c % kPer) * 4;
    const float4 x =
        row0 + r < seq
            ? *reinterpret_cast<const float4*>(g + (row0 + r) * ss + col)
            : make_float4(0.f, 0.f, 0.f, 0.f);
    uint4 h, l;
    flash::split_tf32(x.x, h.x, l.x);
    flash::split_tf32(x.y, h.y, l.y);
    flash::split_tf32(x.z, h.z, l.z);
    flash::split_tf32(x.w, h.w, l.w);
    *reinterpret_cast<uint4*>(hi + r * P + col) = h;
    *reinterpret_cast<uint4*>(lo + r * P + col) = l;
  }
}

// This warp's 16 fixed rows (split in shared memory) against the W walked
// rows of a tile, over depth D: s (+)= a walk_s^T and dp (+)= c walk_d^T.
// Each product is three passes, a_hi b_lo + a_lo b_hi into a small sum
// (s_lo, dp_lo) and a_hi b_hi into a big one. The tensor core truncates
// the sums it returns, which biases a long chain into one sum by up to half
// an f32 step a link; dp - di (dp summed from -di) is a difference of two
// near-equal sums where attention is near-uniform (one key gives exactly
// 0), so dp's big sum restarts from zero every second 8-deep step and is
// added to dp in f32 (to nearest). At one key, where dq and dk are round-off
// alone, they then read 7.3e-7 from the plain version's at most, against
// 2.0e-6 with every pass in one sum (the tests allow 1e-6).
template <int D, int W, int P>
__device__ __forceinline__ void scores(float (*s)[4], float (*s_lo)[4],
                                       float (*dp)[4], float (*dp_lo)[4],
                                       const float* a_hi, const float* a_lo,
                                       const float* c_hi, const float* c_lo,
                                       const float* walk_s,
                                       const float* walk_d, int r0,
                                       int lane) {
  using namespace flash;
  static_assert(D % 16 == 0, "dp's big sum restarts every second step");
  constexpr int kUnroll = D == 64 ? 8 : 4;  // at D = 128, no spills
  float t[W / 8][4];
#pragma unroll kUnroll
  for (int kc = 0; kc < D / 8; ++kc) {
    uint32_t ah[4], al[4], ch[4], cl[4];
    load_a_tf32<P>(ah, a_hi, r0, kc * 8, lane);
    load_a_tf32<P>(al, a_lo, r0, kc * 8, lane);
    load_a_tf32<P>(ch, c_hi, r0, kc * 8, lane);
    load_a_tf32<P>(cl, c_lo, r0, kc * 8, lane);
#pragma unroll
    for (int n = 0; n < W / 8; ++n) {
      uint32_t bh[2], bl[2];
      load_b_nk_tf32<P>(bh, bl, walk_s, n * 8, kc * 8, lane);
      mma_tf32(s_lo[n], ah, bl[0], bl[1]);
      mma_tf32(s_lo[n], al, bh[0], bh[1]);
      mma_tf32(s[n], ah, bh[0], bh[1]);
      load_b_nk_tf32<P>(bh, bl, walk_d, n * 8, kc * 8, lane);
      mma_tf32(dp_lo[n], ch, bl[0], bl[1]);
      mma_tf32(dp_lo[n], cl, bh[0], bh[1]);
      if (kc % 2 == 0) t[n][0] = t[n][1] = t[n][2] = t[n][3] = 0.f;
      mma_tf32(t[n], ch, bh[0], bh[1]);
      if (kc % 2 == 1) {
#pragma unroll
        for (int e = 0; e < 4; ++e) dp[n][e] += t[n][e];
      }
    }
  }
}

// out[16 x D] += a[16 x W] walk[W x D]: a (p or ds, this warp's sums) as
// the A operand in place (acc_to_a_tf32), walk's rows read as B
// (load_b_kn_tf32)
template <int D, int W, int P>
__device__ __forceinline__ void update(float (*out)[4], const float (*a)[4],
                                       const float* walk, int lane) {
  using namespace flash;
#pragma unroll
  for (int kc = 0; kc < W / 8; ++kc) {
    uint32_t ah[4], al[4];
    acc_to_a_tf32(ah, al, a[kc]);
#pragma unroll
    for (int n = 0; n < D / 8; ++n) {
      uint32_t bh[2], bl[2];
      load_b_kn_tf32<P>(bh, bl, walk, kc * 8, n * 8, lane);
      mma_3xtf32(out[n], ah, al, bh, bl);
    }
  }
}

// this warp's 16 rows (r0 + g, r0 + g + 8) of a [*, D] f32 output, from
// sums over D / 8 column tiles; rows at or past seq are not stored
template <int D>
__device__ __forceinline__ void store_rows(float* out, const float (*c)[4],
                                           int row0, int seq, int lane) {
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + lane / 4 + 8 * r;
    if (row < seq) {
#pragma unroll
      for (int n = 0; n < D / 8; ++n)
        *reinterpret_cast<float2*>(out + (long long)row * D + n * 8 +
                                   2 * (lane % 4)) =
            make_float2(c[n][2 * r], c[n][2 * r + 1]);
    }
  }
}

template <int D>
__global__ void __launch_bounds__(kThreads) vt_flash_dkv_f32(Args a) {
  using namespace flash;
  constexpr int W = walk_rows<D>(), P = D + 4, FIX = kRows * P, WALK = W * P;
  extern __shared__ float4 smem4[];
  float* const k_hi = reinterpret_cast<float*>(smem4);  // [kRows][P] each
  float* const k_lo = k_hi + FIX;
  float* const v_hi = k_lo + FIX;
  float* const v_lo = v_hi + FIX;
  float* const qs = v_lo + FIX;         // [2][WALK]
  float* const dos = qs + 2 * WALK;     // [2][WALK]
  float* const stats = dos + 2 * WALK;  // [2][lse, di][W]

  const int tid = threadIdx.x, lane = tid % 32, r0 = (tid / 32) * 16;
  const int k0 = blockIdx.x * kRows, bh = a.bh0 + blockIdx.y, seq = a.seq;
  const float* const qg = head_ptr<float>(a.q, bh, a.heads);
  const float* const dg = head_ptr<float>(a.dout, bh, a.heads);
  const float* const lse_g = a.lse + (long long)bh * seq;
  const float* const di_g = a.di + (long long)bh * seq;

  auto load_queries = [&](int i, int buf) {
    load_rows<float, W, D, P, kThreads>(qs + buf * WALK, qg, a.q.ss, i * W,
                                        seq, tid);
    load_rows<float, W, D, P, kThreads>(dos + buf * WALK, dg, a.dout.ss, i * W,
                                        seq, tid);
    float* const st = stats + buf * 2 * W;
    if (tid < W) {
      load_stat(st + tid, lse_g, i * W + tid, seq);
    } else if (tid < 2 * W) {
      load_stat(st + tid, di_g, i * W + tid - W, seq);
    }
  };
  load_queries(0, 0);
  cp_async_commit();
  load_split<D, P>(k_hi, k_lo, head_ptr<float>(a.k, bh, a.heads), a.k.ss, k0,
                   seq, tid);
  load_split<D, P>(v_hi, v_lo, head_ptr<float>(a.v, bh, a.heads), a.v.ss, k0,
                   seq, tid);

  float dk[D / 8][4], dv[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk[n][e] = dv[n][e] = 0.f;

  const int ntiles = (seq + W - 1) / W;
  for (int i = 0; i < ntiles; ++i) {
    if (i + 1 < ntiles) {
      load_queries(i + 1, (i + 1) & 1);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const float* const qt = qs + (i & 1) * WALK;
    const float* const dt = dos + (i & 1) * WALK;
    const float* const lse_s = stats + (i & 1) * 2 * W;
    const float* const di_s = lse_s + W;

    // this warp's 16 keys x W queries: p^T = exp(scale k q^T - lse), 0 for
    // queries past S; ds^T = p^T (v do^T - di) scale
    float p[W / 8][4], p_lo[W / 8][4], ds[W / 8][4], ds_lo[W / 8][4];
#pragma unroll
    for (int n = 0; n < W / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        p[n][e] = p_lo[n][e] = ds_lo[n][e] = 0.f;
        ds[n][e] = -di_s[n * 8 + (lane % 4) * 2 + (e & 1)];
      }
    scores<D, W, P>(p, p_lo, ds, ds_lo, k_hi, k_lo, v_hi, v_lo, qt, dt, r0,
                    lane);
#pragma unroll
    for (int n = 0; n < W / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = n * 8 + (lane % 4) * 2 + (e & 1);
        p[n][e] = i * W + col < seq ? exp2f((p[n][e] + p_lo[n][e]) * a.scale_log2 -
                                            lse_s[col] * kLog2e)
                                    : 0.f;
        ds[n][e] = p[n][e] * (ds[n][e] + ds_lo[n][e]) * a.scale;
      }
    update<D, W, P>(dv, p, dt, lane);   // dv += p^T do
    update<D, W, P>(dk, ds, qt, lane);  // dk += ds^T q
    __syncthreads();
  }

  const long long head = (long long)bh * seq * D;
  store_rows<D>(static_cast<float*>(a.out0) + head, dk, k0 + r0, seq, lane);
  store_rows<D>(static_cast<float*>(a.out1) + head, dv, k0 + r0, seq, lane);
}

template <int D>
__global__ void __launch_bounds__(kThreads) vt_flash_dq_f32(Args a) {
  using namespace flash;
  constexpr int W = walk_rows<D>(), P = D + 4, FIX = kRows * P, WALK = W * P;
  extern __shared__ float4 smem4[];
  float* const q_hi = reinterpret_cast<float*>(smem4);  // [kRows][P] each
  float* const q_lo = q_hi + FIX;
  float* const d_hi = q_lo + FIX;
  float* const d_lo = d_hi + FIX;
  float* const ks = d_lo + FIX;     // [2][WALK]
  float* const vs = ks + 2 * WALK;  // [2][WALK]

  const int tid = threadIdx.x, lane = tid % 32, r0 = (tid / 32) * 16;
  const int q0 = blockIdx.x * kRows, bh = a.bh0 + blockIdx.y, seq = a.seq;
  const float* const kg = head_ptr<float>(a.k, bh, a.heads);
  const float* const vg = head_ptr<float>(a.v, bh, a.heads);
  load_rows<float, W, D, P, kThreads>(ks, kg, a.k.ss, 0, seq, tid);
  load_rows<float, W, D, P, kThreads>(vs, vg, a.v.ss, 0, seq, tid);
  cp_async_commit();
  load_split<D, P>(q_hi, q_lo, head_ptr<float>(a.q, bh, a.heads), a.q.ss, q0,
                   seq, tid);
  load_split<D, P>(d_hi, d_lo, head_ptr<float>(a.dout, bh, a.heads),
                   a.dout.ss, q0, seq, tid);

  float lse2[2], di[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = q0 + r0 + lane / 4 + 8 * r;
    const long long at = (long long)bh * seq + row;
    lse2[r] = row < seq ? a.lse[at] * kLog2e : 0.f;
    di[r] = row < seq ? a.di[at] : 0.f;
  }
  float dq[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n) dq[n][0] = dq[n][1] = dq[n][2] = dq[n][3] = 0.f;

  const int ntiles = (seq + W - 1) / W;
  for (int j = 0; j < ntiles; ++j) {
    if (j + 1 < ntiles) {
      const int nb = (j + 1) & 1;
      load_rows<float, W, D, P, kThreads>(ks + nb * WALK, kg, a.k.ss,
                                          (j + 1) * W, seq, tid);
      load_rows<float, W, D, P, kThreads>(vs + nb * WALK, vg, a.v.ss,
                                          (j + 1) * W, seq, tid);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const float* const kt = ks + (j & 1) * WALK;
    const float* const vt = vs + (j & 1) * WALK;

    // this warp's 16 rows x W keys: p = exp(scale q k^T - lse), 0 for keys
    // past S; ds = p (do v^T - di) scale
    float p[W / 8][4], p_lo[W / 8][4], ds[W / 8][4], ds_lo[W / 8][4];
#pragma unroll
    for (int n = 0; n < W / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        p[n][e] = p_lo[n][e] = ds_lo[n][e] = 0.f;
        ds[n][e] = -di[e / 2];
      }
    scores<D, W, P>(p, p_lo, ds, ds_lo, q_hi, q_lo, d_hi, d_lo, kt, vt, r0,
                    lane);
#pragma unroll
    for (int n = 0; n < W / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = j * W + n * 8 + (lane % 4) * 2 + (e & 1);
        p[n][e] = key < seq ? exp2f((p[n][e] + p_lo[n][e]) * a.scale_log2 -
                                    lse2[e / 2])
                            : 0.f;
        ds[n][e] = p[n][e] * (ds[n][e] + ds_lo[n][e]) * a.scale;
      }
    update<D, W, P>(dq, ds, kt, lane);  // dq += ds k
    __syncthreads();
  }

  store_rows<D>(static_cast<float*>(a.out0) + (long long)bh * seq * D, dq,
                q0 + r0, seq, lane);
}

template <int D, bool kDkv>
cudaError_t launch(const Args& a, int bh, cudaStream_t stream) {
  const int tiles = (a.seq + kRows - 1) / kRows;
  if (kDkv)
    return flash::launch_heads(vt_flash_dkv_f32<D>, smem_bytes<D, true>(),
                               tiles, bh, kThreads, a, stream);
  return flash::launch_heads(vt_flash_dq_f32<D>, smem_bytes<D, false>(), tiles,
                             bh, kThreads, a, stream);
}

}  // namespace f32

bool fill(Args& a, const void* q, const void* k, const void* v,
          const void* dout, const void* lse, const void* di, int heads,
          int seq, int d, const long long* st, float scale) {
  a.q = {q, st[0], st[1], st[2]};
  a.k = {k, st[3], st[4], st[5]};
  a.v = {v, st[6], st[7], st[8]};
  a.dout = {dout, st[9], st[10], st[11]};
  a.lse = static_cast<const float*>(lse);
  a.di = static_cast<const float*>(di);
  a.heads = heads;
  a.seq = seq;
  a.scale = scale;
  a.scale_log2 = scale * flash::kLog2e;
  return d == 64 || d == 128;
}

}  // namespace

extern "C" int vt_flash_attention_dkv(
    const void* q, const void* k, const void* v, const void* dout,
    const void* lse, const void* di, void* dk, void* dv, int batch, int heads,
    int seq, int d, long long q_sb, long long q_sh, long long q_ss,
    long long k_sb, long long k_sh, long long k_ss, long long v_sb,
    long long v_sh, long long v_ss, long long d_sb, long long d_sh,
    long long d_ss, float scale, int bf16, cudaStream_t stream) {
  const int bh = batch * heads;
  if (bh == 0 || seq == 0) return cudaSuccess;
  const long long st[12] = {q_sb, q_sh, q_ss, k_sb, k_sh, k_ss,
                            v_sb, v_sh, v_ss, d_sb, d_sh, d_ss};
  Args a{};
  if (!fill(a, q, k, v, dout, lse, di, heads, seq, d, st, scale))
    return cudaErrorInvalidValue;
  a.out0 = dk;
  a.out1 = dv;
  if (bf16)
    return bwd::run<true>(q, k, v, dout, lse, di, dk, dv, batch, heads, seq, d,
                          st, scale, stream);
  return d == 64 ? f32::launch<64, true>(a, bh, stream)
                 : f32::launch<128, true>(a, bh, stream);
}

extern "C" int vt_flash_attention_dq(
    const void* q, const void* k, const void* v, const void* dout,
    const void* lse, const void* di, void* dq, int batch, int heads, int seq,
    int d, long long q_sb, long long q_sh, long long q_ss, long long k_sb,
    long long k_sh, long long k_ss, long long v_sb, long long v_sh,
    long long v_ss, long long d_sb, long long d_sh, long long d_ss,
    float scale, int bf16, cudaStream_t stream) {
  const int bh = batch * heads;
  if (bh == 0 || seq == 0) return cudaSuccess;
  const long long st[12] = {q_sb, q_sh, q_ss, k_sb, k_sh, k_ss,
                            v_sb, v_sh, v_ss, d_sb, d_sh, d_ss};
  Args a{};
  if (!fill(a, q, k, v, dout, lse, di, heads, seq, d, st, scale))
    return cudaErrorInvalidValue;
  a.out0 = dq;
  if (bf16)
    return bwd::run<false>(q, k, v, dout, lse, di, dq, nullptr, batch, heads,
                           seq, d, st, scale, stream);
  return d == 64 ? f32::launch<64, false>(a, bh, stream)
                 : f32::launch<128, false>(a, bh, stream);
}
