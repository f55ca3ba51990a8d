// bf16 matrix product on the tensor cores (wgmma) with a normalise+ReLU
// prologue and a column-statistics epilogue: the 1x1 convolutions of a
// ResNet bottleneck in training mode, in bf16.
//
// Replaces the TPU kernel vision_tpu/ops/_pallas/conv1x1_bn.py:
// _pallas_impl (entry matmul_stats), for bf16 operands. For x [M, K] bf16,
// w [K, N] bf16 (either stride may be the unit one) and optional scale,
// shift [K] f32:
//
//   xn = scale ? bf16(relu(f32(x) * scale + shift)) : x      (never stored)
//   y  = bf16(sum_k xn * w)                                  (f32 accumulation)
//   s1[n] = sum_m f32(y[m, n])      s2[n] = sum_m f32(y[m, n])^2
//
// The statistics are those of the CAST y. As in matmul_stats.cu, each block
// writes the column sums of its own rows into a [tiles_m, N] f32 workspace
// and column_sums_kernel adds the tiles in a fixed order: no float atomics,
// the same bits from run to run.
//
// What bounds it: at ResNet-50's shapes (M up to 100,352, K and N from 64 to
// 2048) the bf16 product needs 2*M*K*N operations at the tensor cores' rate
// against (M*K + K*N + M*N) * 2 bytes, and every one of the 16 cases is
// bound by the bytes. So the kernel has to stream x once and y once at
// memory speed and hide the product under that.
//
// Design.
// * The product is wgmma.mma_async m64n128k16 (m64n64k16 for 64-column
//   tiles), f32 accumulators in registers, both operands read from shared
//   memory through 128-byte-swizzle descriptors. One warpgroup owns 64 rows;
//   a block is one or two warpgroups (64 or 128 rows) by 64 or 128 columns,
//   chosen per call so that the grid fills the 132 SMs.
// * K tiles of 64 bf16 (128 bytes: one swizzle row) arrive by TMA
//   (cp.async.bulk.tensor, completing on an mbarrier) into a ring of two or
//   three stages; one thread starts the loads, a ring ahead. The tensor maps
//   are encoded per call by the C entry point (they hold device pointers;
//   two driver calls of about a microsecond) and passed as
//   __grid_constant__ parameters.
// * The blocks are persistent: as many as the card holds at once (two an
//   SM: <= 128 registers, <= 112 KB of shared memory), each walking over
//   output tiles. The K tiles of all its output tiles form one sequence
//   through the ring, so the next tile's loads are in flight while this
//   tile's epilogue runs, and the other block of the SM fills the gaps.
//   Most cases have one to four K tiles, so without this the load latency
//   would be exposed once per output tile.
// * w is read where it lies. When K is its unit stride (the transposed view
//   of a conv weight [N, K]) the B tile is K-major like A; when N is its
//   unit stride, the tile is loaded as 64-column boxes and wgmma reads it
//   N-major (the transpose bit of the instruction). No copy in either case.
// * The prologue rewrites the x tile in shared memory in place: each
//   warpgroup transforms its own 64 rows (multiply and add rounded
//   separately, ReLU, round to bf16, as the plain version does), masks the
//   rows past M to zero (TMA fills them with zeros, but relu(0*scale+shift)
//   is not zero), then fence.proxy.async and a warpgroup barrier before the
//   wgmma reads it. In place rather than A-from-registers: it keeps one
//   wgmma path for both variants, the tile still makes a single trip
//   (shared memory -> registers -> shared memory, 16 bytes a thread), and
//   the registers stay free for two blocks an SM.
// * The epilogue casts the accumulators to bf16, sums the cast values and
//   their squares over each thread's two rows, over the warp's 16 rows with
//   a shuffle butterfly that halves the vector at every exchange (fixed
//   order, 56 shuffles a thread in place of 192), and across warps through
//   shared memory in a fixed order; y goes through a padded shared-memory
//   tile and leaves as 16-byte stores, whole rows coalesced.
//
// Takes: K >= 8, K and N multiples of 8 (16-byte rows for TMA and the
// stores), 16-byte aligned pointers. Anything else belongs to the guarded
// kernel of matmul_stats.cu; the Python wrapper chooses.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "matmul_stats_common.cuh"

namespace {

constexpr int kBK = 64;      // bf16 per K tile: 128 bytes
constexpr int kRowBytes = 128;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
                   bar),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

__device__ __forceinline__ void tma_load_2d(uint32_t dst, const CUtensorMap* map,
                                            uint32_t bar, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::"
      "bytes [%0], [%1, {%3, %4}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1)
      : "memory");
}

// Shared-memory matrix descriptor, 128-byte swizzle.
__device__ __forceinline__ uint64_t make_desc(uint32_t addr, uint32_t lbo_bytes,
                                              uint32_t sbo_bytes) {
  uint64_t d = 0;
  d |= static_cast<uint64_t>((addr & 0x3FFFF) >> 4);
  d |= static_cast<uint64_t>(lbo_bytes >> 4) << 16;
  d |= static_cast<uint64_t>(sbo_bytes >> 4) << 32;
  d |= static_cast<uint64_t>(1) << 62;
  return d;
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// d[64 x 128] += a[64 x 16] * b[16 x 128]; kTransB: b is N-major in memory.
template <int kTransB>
__device__ __forceinline__ void wgmma_tile(float (&d)[64], uint64_t da,
                                           uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "
      "%30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, "
      "%44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, "
      "%58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, %67;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]),
        "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),
        "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),
        "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]),
        "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]),
        "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]),
        "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]),
        "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(1), "n"(kTransB));
}

// d[64 x 64] += a[64 x 16] * b[16 x 64]
template <int kTransB>
__device__ __forceinline__ void wgmma_tile(float (&d)[32], uint64_t da,
                                           uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "
      "%30, %31}, "
      "%32, %33, p, 1, 1, 0, %35;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]),
        "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),
        "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),
        "+f"(d[31])
      : "l"(da), "l"(db), "r"(1), "n"(kTransB));
}

__device__ __forceinline__ void named_barrier(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

// relu(v * sc + sh) of two bf16 values, the multiply and the add rounded
// separately, rounded to bf16 (nearest even).
__device__ __forceinline__ uint32_t prologue_pair(uint32_t v, float sc0,
                                                  float sh0, float sc1,
                                                  float sh1) {
  const __nv_bfloat162 in = *reinterpret_cast<const __nv_bfloat162*>(&v);
  const float a =
      fmaxf(__fadd_rn(__fmul_rn(__bfloat162float(in.x), sc0), sh0), 0.0f);
  const float b =
      fmaxf(__fadd_rn(__fmul_rn(__bfloat162float(in.y), sc1), sh1), 0.0f);
  __nv_bfloat162 out;
  out.x = __float2bfloat16_rn(a);
  out.y = __float2bfloat16_rn(b);
  return *reinterpret_cast<const uint32_t*>(&out);
}

// Ring depth: three K tiles where two blocks of that depth still share an
// SM's shared memory, else two.
template <int BN, int kWG>
struct Smem {
  static constexpr int kTile = (64 * kWG + BN) * kRowBytes;        // x + w
  static constexpr int kStaged = kWG * 64 * (BN + 8) * 2;          // y, padded
  static constexpr int kRed = 2 * 4 * kWG * BN * (int)sizeof(float);
  static constexpr int kFixed = 1024 + 64 + kStaged + kRed;        // + barriers
  static constexpr int kStages = 3 * kTile + kFixed <= 112 * 1024 ? 3 : 2;
  static constexpr int kBytes = kStages * kTile + kFixed;
};

// One exchange of a butterfly that halves the vector: the lanes whose `bit`
// is clear keep v[0..H) and send v[H..2H), the others the reverse; v[i] then
// holds the sum of the pair for the element kept.
template <int H>
__device__ __forceinline__ void halve(float* v, bool upper, int mask) {
#pragma unroll
  for (int i = 0; i < H; ++i) {
    const float keep = upper ? v[i + H] : v[i];
    const float send = upper ? v[i] : v[i + H];
    v[i] = keep + __shfl_xor_sync(0xffffffffu, send, mask);
  }
}

// A persistent block of kWG warpgroups (64 rows each) walks over output
// tiles of (64 * kWG) x BN, tile index = m_tile * tiles_n + n_tile: the
// blocks that run together share x tiles, so x comes from device memory
// once. The K tiles of all its output tiles form one sequence through the
// ring, so the next output tile's loads are in flight during the epilogue.
// kWN: w is N-major (unit stride along N).
template <int BN, int kWG, bool kPrologue, bool kWN>
__global__ void __launch_bounds__(128 * kWG, 2)
    matmul_stats_wgmma_kernel(const __grid_constant__ CUtensorMap map_x,
                              const __grid_constant__ CUtensorMap map_w,
                              const float* __restrict__ scale,
                              const float* __restrict__ shift,
                              __nv_bfloat16* __restrict__ y,
                              float* __restrict__ ws1, float* __restrict__ ws2,
                              int M, int K, int N) {
  using S = Smem<BN, kWG>;
  constexpr int kStages = S::kStages;
  constexpr int BM = 64 * kWG;
  constexpr int kThreads = 128 * kWG;
  constexpr int kWarps = 4 * kWG;
  constexpr int kABytes = BM * kRowBytes;
  constexpr int kBBytes = BN * kRowBytes;
  constexpr int kAcc = BN / 2;          // f32 accumulators a thread
  constexpr int kStagePitch = BN + 8;   // bf16 per staged row of y (padded)

  extern __shared__ uint8_t smem_raw[];
  // the swizzle pattern repeats every 1024 bytes: align the ring to it
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  uint8_t* const gen = smem_raw + (base - smem_u32(smem_raw));
  const uint32_t a_ring = base;
  const uint32_t b_ring = base + kStages * kABytes;
  const uint32_t bars = b_ring + kStages * kBBytes;
  uint8_t* const after = gen + kStages * (kABytes + kBBytes) + 64;
  float* const red = reinterpret_cast<float*>(after);
  __nv_bfloat16* const staged =
      reinterpret_cast<__nv_bfloat16*>(after + S::kRed);

  const int t = threadIdx.x;
  const int wg = t / 128;
  const int tw = t % 128;
  const int warp = t / 32;
  const int lane = t % 32;
  const int nk = (K + kBK - 1) / kBK;
  const int tiles_n = (N + BN - 1) / BN;
  const int tiles = ((M + BM - 1) / BM) * tiles_n;
  const int first = blockIdx.x, step = gridDim.x;
  const int mine = (tiles - first + step - 1) / step;  // output tiles here
  const int total = mine * nk;                         // K tiles here

  if (t == 0) {
    for (int s = 0; s < kStages; ++s) mbar_init(bars + 8 * s, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const CUtensorMap* const px = &map_x;  // addresses in parameter space
  const CUtensorMap* const pw = &map_w;
  auto load_tile = [=](int f) {  // one thread: K tile f of the sequence
    const int tile = first + (f / nk) * step, kt = f % nk;
    const int m0 = (tile / tiles_n) * BM, n0 = (tile % tiles_n) * BN;
    const int s = f % kStages;
    const uint32_t bar = bars + 8 * s;
    mbar_expect_tx(bar, kABytes + kBBytes);
    tma_load_2d(a_ring + s * kABytes, px, bar, kt * kBK, m0);
    if (kWN) {
#pragma unroll
      for (int h = 0; h < BN / 64; ++h)
        tma_load_2d(b_ring + s * kBBytes + h * 64 * kRowBytes, pw, bar,
                    n0 + 64 * h, kt * kBK);
    } else {
      tma_load_2d(b_ring + s * kBBytes, pw, bar, kt * kBK, n0);
    }
  };
  if (t == 0)
    for (int f = 0; f < kStages && f < total; ++f) load_tile(f);

  // Thread (warp, lane = 4g + q) holds, for each 8-column group j, rows
  // 16*warp + g and + 8, columns 8j + 2q and + 1 of its warpgroup's 64 rows.
  const int g = lane / 4, q = lane % 4;
  const int r0 = 16 * (warp % 4) + g;
  __nv_bfloat16* const stage = staged + wg * 64 * kStagePitch;
  // the prologue's 16-byte chunks: row (tw >> 3) + 16i, the same k for all i
  const int pro_pc = tw & 7;
  const int pro_k = (pro_pc ^ ((tw >> 3) & 7)) << 3;  // undo the swizzle

  int f = 0;
  for (int tile = first; tile < tiles; tile += step) {
    const int m_tile = tile / tiles_n;
    const int m0 = m_tile * BM, n0 = (tile % tiles_n) * BN;
    float acc[kAcc];
#pragma unroll
    for (int i = 0; i < kAcc; ++i) acc[i] = 0.0f;

    for (int kt = 0; kt < nk; ++kt, ++f) {
      const int s = f % kStages;
      mbar_wait(bars + 8 * s, (f / kStages) & 1);
      const uint32_t a_tile = a_ring + s * kABytes + wg * 64 * kRowBytes;
      const uint32_t b_tile = b_ring + s * kBBytes;

      if (kPrologue) {
        // this warpgroup's 64 rows x 64 k, in place
        uint8_t* const rows = gen + (a_tile - base);
        const int k = kt * kBK + pro_k;
        float4 sc0, sc1, sh0, sh1;
        if (k < K) {
          sc0 = __ldg(reinterpret_cast<const float4*>(scale + k));
          sc1 = __ldg(reinterpret_cast<const float4*>(scale + k + 4));
          sh0 = __ldg(reinterpret_cast<const float4*>(shift + k));
          sh1 = __ldg(reinterpret_cast<const float4*>(shift + k + 4));
        }
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int r = (tw >> 3) + 16 * i;
          uint4* const p =
              reinterpret_cast<uint4*>(rows + r * kRowBytes + pro_pc * 16);
          uint4 v = make_uint4(0u, 0u, 0u, 0u);
          if (m0 + wg * 64 + r < M && k < K) {
            v = *p;
            v.x = prologue_pair(v.x, sc0.x, sh0.x, sc0.y, sh0.y);
            v.y = prologue_pair(v.y, sc0.z, sh0.z, sc0.w, sh0.w);
            v.z = prologue_pair(v.z, sc1.x, sh1.x, sc1.y, sh1.y);
            v.w = prologue_pair(v.w, sc1.z, sh1.z, sc1.w, sh1.w);
          }
          *p = v;  // rows past M and columns past K stay 0
        }
        asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
        named_barrier(1 + wg, 128);
      }

      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kBK / 16; ++kk) {
        const uint64_t da = make_desc(a_tile + 32 * kk, 16, 8 * kRowBytes);
        const uint64_t db =
            kWN ? make_desc(b_tile + 16 * kRowBytes * kk, 64 * kRowBytes,
                            8 * kRowBytes)
                : make_desc(b_tile + 32 * kk, 16, 8 * kRowBytes);
        wgmma_tile<kWN ? 1 : 0>(acc, da, db);
      }
      wgmma_commit();
      wgmma_wait_all();
      // every warp has read stage s (and is past the last tile's epilogue)
      __syncthreads();
      if (t == 0 && f + kStages < total) {
        asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
        load_tile(f + kStages);
      }
    }

    // Epilogue: cast, stage y, and sum the cast values (rows past M hold 0).
    // v[4j + {0, 1}]: sums of columns 8j + 2q + {0, 1} over this thread's
    // two rows; v[4j + {2, 3}]: of their squares.
    float v[2 * BN / 4];
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
      __nv_bfloat162 top, bot;
      top.x = __float2bfloat16_rn(acc[4 * j + 0]);
      top.y = __float2bfloat16_rn(acc[4 * j + 1]);
      bot.x = __float2bfloat16_rn(acc[4 * j + 2]);
      bot.y = __float2bfloat16_rn(acc[4 * j + 3]);
      const int c = 8 * j + 2 * q;
      *reinterpret_cast<__nv_bfloat162*>(stage + r0 * kStagePitch + c) = top;
      *reinterpret_cast<__nv_bfloat162*>(stage + (r0 + 8) * kStagePitch + c) =
          bot;
      const float f0 = __bfloat162float(top.x), f1 = __bfloat162float(top.y);
      const float f2 = __bfloat162float(bot.x), f3 = __bfloat162float(bot.y);
      v[4 * j + 0] = f0 + f2;
      v[4 * j + 1] = f1 + f3;
      v[4 * j + 2] = f0 * f0 + f2 * f2;
      v[4 * j + 3] = f1 * f1 + f3 * f3;
    }
    // Over the warp's 8 values of g, in a fixed order, halving the vector at
    // each exchange: BN/4 + BN/8 + BN/16 shuffles in place of 3 * BN/2.
    // Afterwards v[i], i < BN/16, belongs to column group
    // j = i/4 + (BN/64) * (g's bits, lowest first, as a number).
    const bool b0 = g & 1, b1 = g & 2, b2 = g & 4;
    halve<BN / 4>(v, b0, 4);
    halve<BN / 8>(v, b1, 8);
    halve<BN / 16>(v, b2, 16);
    const int j0 = (BN / 64) * ((b0 ? 4 : 0) + (b1 ? 2 : 0) + (b2 ? 1 : 0));
#pragma unroll
    for (int i = 0; i < BN / 16; ++i) {
      const int c = 8 * (j0 + i / 4) + 2 * q + (i & 1);
      red[(((i >> 1) & 1) * kWarps + warp) * BN + c] = v[i];
    }
    __syncthreads();

    // y: 16 bytes a thread, a row of the tile by BN/8 neighbouring threads
    constexpr int kChunks = BN / 8;
#pragma unroll
    for (int i = 0; i < 64 * kChunks / 128; ++i) {
      const int idx = tw + 128 * i;
      const int r = idx / kChunks, c = (idx % kChunks) * 8;
      const int gm = m0 + wg * 64 + r, gn = n0 + c;
      if (gm < M && gn < N)
        *reinterpret_cast<uint4*>(y + (size_t)gm * N + gn) =
            *reinterpret_cast<const uint4*>(stage + r * kStagePitch + c);
    }
    for (int c = t; c < 2 * BN; c += kThreads) {
      const int which = c / BN, lc = c % BN;
      if (n0 + lc >= N) continue;
      float sum = 0.0f;
#pragma unroll
      for (int w = 0; w < kWarps; ++w)  // fixed order
        sum += red[(which * kWarps + w) * BN + lc];
      (which ? ws2 : ws1)[(size_t)m_tile * N + n0 + lc] = sum;
    }
  }
}

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                 void*, const cuuint64_t*, const cuuint64_t*,
                                 const cuuint32_t*, const cuuint32_t*,
                                 CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled is a driver call: fetch it through the runtime so
// that the library needs no -lcuda.
EncodeTiled encode_tiled() {
  static EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault,
                                &q) != cudaSuccess ||
        q != cudaDriverEntryPointSuccess)
      p = nullptr;
    return reinterpret_cast<EncodeTiled>(p);
  }();
  return fn;
}

// A [rows, cols] bf16 matrix with unit stride along cols, cut into boxes of
// box_rows x 64 columns (128 bytes, the swizzle width). Past the edges the
// loads fill zeros.
bool make_map(CUtensorMap* map, const void* ptr, int rows, int cols,
              long long row_stride, int box_rows) {
  EncodeTiled encode = encode_tiled();
  if (!encode) return false;
  const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)row_stride * 2};
  const cuuint32_t box[2] = {64, (cuuint32_t)box_rows};
  const cuuint32_t elem[2] = {1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2,
                const_cast<void*>(ptr), dims, strides, box, elem,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int BN, int kWG, bool kPrologue, bool kWN>
cudaError_t launch_tile(const CUtensorMap& map_x, const CUtensorMap& map_w,
                        const float* scale, const float* shift,
                        __nv_bfloat16* y, float* ws1, float* ws2, int M, int K,
                        int N, cudaStream_t s) {
  constexpr int BM = 64 * kWG;
  constexpr int smem = Smem<BN, kWG>::kBytes;
  auto kernel = matmul_stats_wgmma_kernel<BN, kWG, kPrologue, kWN>;
  static int resident[64] = {};  // blocks the device holds, once a variant
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
                                                        128 * kWG, smem);
    if (err != cudaSuccess) return err;
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return err;
    if (per_sm < 1) return cudaErrorLaunchOutOfResources;
    resident[dev] = per_sm * sms;
  }
  const long long tiles =
      (long long)((M + BM - 1) / BM) * ((N + BN - 1) / BN);
  const int grid = tiles < resident[dev] ? (int)tiles : resident[dev];
  kernel<<<grid, 128 * kWG, smem, s>>>(map_x, map_w, scale, shift, y, ws1, ws2,
                                       M, K, N);
  return cudaGetLastError();
}

template <int BN, int kWG>
cudaError_t launch_variant(const CUtensorMap& map_x, const CUtensorMap& map_w,
                           const float* scale, const float* shift,
                           __nv_bfloat16* y, float* ws1, float* ws2, int M,
                           int K, int N, bool w_n_major, cudaStream_t s) {
  if (scale) {
    if (w_n_major)
      return launch_tile<BN, kWG, true, true>(map_x, map_w, scale, shift, y,
                                              ws1, ws2, M, K, N, s);
    return launch_tile<BN, kWG, true, false>(map_x, map_w, scale, shift, y, ws1,
                                             ws2, M, K, N, s);
  }
  if (w_n_major)
    return launch_tile<BN, kWG, false, true>(map_x, map_w, scale, shift, y, ws1,
                                             ws2, M, K, N, s);
  return launch_tile<BN, kWG, false, false>(map_x, map_w, scale, shift, y, ws1,
                                            ws2, M, K, N, s);
}

}  // namespace

// Rows of y per block at this M and N: the wrapper sizes the workspace
// with it.
extern "C" int vt_matmul_stats_wgmma_tile_m(int M, int N) {
  int bm, bn;
  choose_tile(M, N, &bm, &bn);
  return bm;
}

// x [M, K] bf16 with row stride x_stride (elements); w [K, N] bf16 with
// strides (w_stride_k, w_stride_n), one of them 1; y [M, N] bf16 (out,
// contiguous); scale, shift [K] f32 or both null (no prologue);
// ws [2, tiles_m, N] f32 scratch; s1, s2 [N] f32 (out). K >= 8; K, N and the
// non-unit strides multiples of 8; pointers 16-byte aligned. Returns a
// cudaError_t, or -1 when a tensor map could not be encoded.
extern "C" int vt_matmul_stats_wgmma(const void* x, const void* w,
                                     const float* scale, const float* shift,
                                     void* y, float* ws, float* s1, float* s2,
                                     int M, int K, int N, long long x_stride,
                                     long long w_stride_k,
                                     long long w_stride_n, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int bm, bn;
  choose_tile(M, N, &bm, &bn);
  const bool w_n_major = w_stride_n == 1 && w_stride_k != 1;
  CUtensorMap map_x, map_w;
  if (!make_map(&map_x, x, M, K, x_stride, bm)) return -1;
  // N-major: w as it lies is [K, N], boxes of 64 k x 64 n. K-major: the
  // memory holds [N, K], boxes of bn n x 64 k.
  const bool ok = w_n_major ? make_map(&map_w, w, K, N, w_stride_k, 64)
                            : make_map(&map_w, w, N, K, w_stride_n, bn);
  if (!ok) return -1;
  const int tiles_m = (M + bm - 1) / bm;
  float* ws1 = ws;
  float* ws2 = ws + (size_t)tiles_m * N;
  __nv_bfloat16* yp = static_cast<__nv_bfloat16*>(y);
  cudaError_t err;
  if (bm == 128 && bn == 128)
    err = launch_variant<128, 2>(map_x, map_w, scale, shift, yp, ws1, ws2, M, K,
                                 N, w_n_major, s);
  else if (bm == 128)
    err = launch_variant<64, 2>(map_x, map_w, scale, shift, yp, ws1, ws2, M, K,
                                N, w_n_major, s);
  else
    err = launch_variant<64, 1>(map_x, map_w, scale, shift, yp, ws1, ws2, M, K,
                                N, w_n_major, s);
  if (err != cudaSuccess) return (int)err;
  column_sums_kernel<<<dim3((N + 31) / 32, 2), dim3(32, 8), 0, s>>>(
      ws1, ws2, tiles_m, N, s1, s2);
  return (int)cudaGetLastError();
}
