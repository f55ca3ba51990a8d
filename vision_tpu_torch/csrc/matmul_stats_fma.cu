// f32 matrix product on the FP32 units with a normalise+ReLU prologue and a
// column-statistics epilogue: the 1x1 convolutions of a ResNet bottleneck in
// training mode, in full f32 (no TF32).
//
// Replaces the TPU kernel vision_tpu/ops/_pallas/conv1x1_bn.py:
// _pallas_impl (entry matmul_stats), for f32 operands. For x [M, K] f32,
// w [K, N] f32 (either stride may be the unit one) and optional scale,
// shift [K] f32:
//
//   xn = scale ? relu(x * scale + shift) : x                 (never stored)
//   y  = sum_k xn * w
//   s1[n] = sum_m y[m, n]           s2[n] = sum_m y[m, n]^2
//
// As in matmul_stats.cu, each block writes the column sums of its own rows
// into a [tiles_m, N] f32 workspace and column_sums_kernel adds the tiles in
// a fixed order: no float atomics, the same bits from run to run.
//
// What bounds it: 2*M*K*N operations at the card's FP32 rate (67 TFLOP/s
// outside the tensor cores) wherever K and N exceed 64; the bytes only at the
// 64-wide cases. So the FMA pipes have to stay fed: operands must come from
// shared memory in 16-byte loads that cost few instruction slots, the global loads
// must cost no registers, and every SM must have work.
//
// Design.
// * K tiles of 32 arrive by cp.async (16 bytes a thread, zero-filled past
//   the edges) into a ring of three stages in dynamic shared memory, two
//   tiles ahead of the product; one __syncthreads() a tile. No registers
//   hold loads in flight, so 256 threads fit in 128 registers each and two
//   blocks share an SM; the 128x128 tile runs one block an SM at 168
//   registers (no spills) where K >= 256 and the product dominates.
// * x tiles lie in shared memory as they lie in memory, [m][k], and so do
//   w tiles when K is w's unit stride (the transposed view of a conv weight
//   [N, K]): a thread reads 4 consecutive k of one row or column as a float4
//   and does 4 k-steps on it. Rows are padded to 36 floats and a thread owns
//   rows ty + 16i and columns tx + 16j, which keeps these reads free of bank
//   conflicts. When N is w's unit stride the tile lies [k][n] and a thread
//   owns groups of 4 neighbouring columns, read as float4 per k.
// * The prologue runs in place in shared memory after the copy lands: each
//   thread rewrites the chunks it copied itself (visible to it after
//   cp.async.wait_group, before the tile's barrier), so every element is
//   normalised once a block, not once a reader. Rows past M and columns past
//   K were zero-filled and stay zero.
// * Tile 128x128, 128x64 or 64x64 (8x8, 8x4 or 4x4 sums a thread), the
//   largest whose grid covers the 132 SMs.
//
// Takes: K >= 4, K and N multiples of 4 (16-byte chunks), 16-byte aligned
// pointers and strides. Anything else belongs to the guarded kernel of
// matmul_stats.cu; the Python wrapper chooses.

#include <cuda_runtime.h>
#include <stdint.h>

#include "matmul_stats_common.cuh"

namespace {

constexpr int kBK = 32;        // depth of one shared-memory tile
constexpr int kPitch = 36;     // floats per [row][k] line: 32 + 4 of padding
constexpr int kStages = 3;
constexpr int kThreads = 256;  // 16 (tx, columns) x 16 (ty, rows)

__device__ __forceinline__ void cp_async_16(float* dst, const float* src,
                                            bool valid) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  const int bytes = valid ? 16 : 0;  // the rest of the 16 is filled with 0
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
               "l"(src), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ float comp(const float4& v, int i) {
  return i == 0 ? v.x : i == 1 ? v.y : i == 2 ? v.z : v.w;
}

// kWK: w has unit stride along K (tile [n][k]); else along N (tile [k][n]).
// grid (tiles_n, tiles_m): blocks that share an x tile are neighbours.
// kBlocks: blocks an SM must hold, i.e. 128 registers a thread at 2.
template <int BM, int BN, bool kPrologue, bool kWK, int kBlocks>
__global__ void __launch_bounds__(kThreads, kBlocks)
    matmul_stats_fma_kernel(const float* __restrict__ x,
                            const float* __restrict__ w,
                            const float* __restrict__ scale,
                            const float* __restrict__ shift,
                            float* __restrict__ y, float* __restrict__ ws1,
                            float* __restrict__ ws2, int M, int K, int N,
                            long long x_stride, long long w_stride) {
  constexpr int TM = BM / 16, TN = BN / 16;
  constexpr int kAFloats = BM * kPitch;
  constexpr int kBFloats = BN * kPitch;  // >= kBK * BN, the [k][n] form
  constexpr int kAChunks = BM * (kBK / 4) / kThreads;  // 16-byte copies a thread
  constexpr int kBChunks = BN * (kBK / 4) / kThreads;
  static_assert(2 * 16 * BN <= kStages * (kAFloats + kBFloats),
                "the partial sums reuse the ring");

  extern __shared__ __align__(16) float smem[];
  float* const a_ring = smem;
  float* const b_ring = smem + kStages * kAFloats;

  const int t = threadIdx.x;
  const int tx = t % 16, ty = t / 16;
  const int n0 = blockIdx.x * BN;
  const int m0 = blockIdx.y * BM;
  const int nk = (K + kBK - 1) / kBK;

  auto load = [&](int kt) {  // this thread's share of tile kt
    const int s = kt % kStages, k0 = kt * kBK;
    float* const as = a_ring + s * kAFloats;
    float* const bs = b_ring + s * kBFloats;
#pragma unroll
    for (int i = 0; i < kAChunks; ++i) {
      const int idx = t + kThreads * i;
      const int r = idx / 8, c = (idx % 8) * 4;
      const bool ok = m0 + r < M && k0 + c < K;
      cp_async_16(as + r * kPitch + c,
                  ok ? x + (size_t)(m0 + r) * x_stride + k0 + c : x, ok);
    }
#pragma unroll
    for (int i = 0; i < kBChunks; ++i) {
      const int idx = t + kThreads * i;
      if (kWK) {
        const int r = idx / 8, c = (idx % 8) * 4;
        const bool ok = n0 + r < N && k0 + c < K;
        cp_async_16(bs + r * kPitch + c,
                    ok ? w + (size_t)(n0 + r) * w_stride + k0 + c : w, ok);
      } else {
        const int r = idx / (BN / 4), c = (idx % (BN / 4)) * 4;
        const bool ok = k0 + r < K && n0 + c < N;
        cp_async_16(bs + r * BN + c,
                    ok ? w + (size_t)(k0 + r) * w_stride + n0 + c : w, ok);
      }
    }
  };

  // columns of thread tx: tx + 16j, or groups of 4 neighbours 64 apart
  auto col = [&](int j) {
    return kWK ? tx + 16 * j : (j / 4) * 64 + tx * 4 + (j % 4);
  };

  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.0f;

#pragma unroll
  for (int kt = 0; kt < kStages - 1; ++kt) {
    if (kt < nk) load(kt);
    asm volatile("cp.async.commit_group;\n" ::: "memory");
  }

  for (int kt = 0; kt < nk; ++kt) {
    const int s = kt % kStages;
    float* const as = a_ring + s * kAFloats;
    const float* const bs = b_ring + s * kBFloats;
    // all but the newest group have landed: tile kt is here
    asm volatile("cp.async.wait_group %0;\n" ::"n"(kStages - 2) : "memory");
    if (kPrologue) {
      const int k0 = kt * kBK;
#pragma unroll
      for (int i = 0; i < kAChunks; ++i) {  // the chunks this thread copied
        const int idx = t + kThreads * i;
        const int r = idx / 8, c = (idx % 8) * 4;
        if (m0 + r < M && k0 + c < K) {
          float4* const p = reinterpret_cast<float4*>(as + r * kPitch + c);
          const float4 sc = __ldg(reinterpret_cast<const float4*>(scale + k0 + c));
          const float4 sh = __ldg(reinterpret_cast<const float4*>(shift + k0 + c));
          float4 v = *p;
          v.x = fmaxf(__fadd_rn(__fmul_rn(v.x, sc.x), sh.x), 0.0f);
          v.y = fmaxf(__fadd_rn(__fmul_rn(v.y, sc.y), sh.y), 0.0f);
          v.z = fmaxf(__fadd_rn(__fmul_rn(v.z, sc.z), sh.z), 0.0f);
          v.w = fmaxf(__fadd_rn(__fmul_rn(v.w, sc.w), sh.w), 0.0f);
          *p = v;
        }
      }
    }
    // tile kt is visible to all, and all have left tile kt - 1, whose stage
    // the next copy overwrites
    __syncthreads();
    if (kt + kStages - 1 < nk) load(kt + kStages - 1);
    asm volatile("cp.async.commit_group;\n" ::: "memory");

#pragma unroll
    for (int k4 = 0; k4 < kBK / 4; ++k4) {
      float4 a[TM];
#pragma unroll
      for (int i = 0; i < TM; ++i)
        a[i] = *reinterpret_cast<const float4*>(as + (ty + 16 * i) * kPitch +
                                                4 * k4);
      if (kWK) {
#pragma unroll
        for (int j = 0; j < TN; ++j) {
          const float4 b = *reinterpret_cast<const float4*>(
              bs + (tx + 16 * j) * kPitch + 4 * k4);
#pragma unroll
          for (int i = 0; i < TM; ++i) {
            acc[i][j] = fmaf(a[i].x, b.x, acc[i][j]);
            acc[i][j] = fmaf(a[i].y, b.y, acc[i][j]);
            acc[i][j] = fmaf(a[i].z, b.z, acc[i][j]);
            acc[i][j] = fmaf(a[i].w, b.w, acc[i][j]);
          }
        }
      } else {
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
          for (int g = 0; g < TN / 4; ++g) {
            const float4 b = *reinterpret_cast<const float4*>(
                bs + (4 * k4 + kk) * BN + g * 64 + tx * 4);
#pragma unroll
            for (int i = 0; i < TM; ++i) {
              const float av = comp(a[i], kk);
              acc[i][g * 4 + 0] = fmaf(av, b.x, acc[i][g * 4 + 0]);
              acc[i][g * 4 + 1] = fmaf(av, b.y, acc[i][g * 4 + 1]);
              acc[i][g * 4 + 2] = fmaf(av, b.z, acc[i][g * 4 + 2]);
              acc[i][g * 4 + 3] = fmaf(av, b.w, acc[i][g * 4 + 3]);
            }
          }
        }
      }
    }
  }
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
  __syncthreads();  // the ring is free: the partial sums go there

  // epilogue: store, and sum over this thread's rows (rows past M hold 0)
  float p1[TN], p2[TN];
#pragma unroll
  for (int j = 0; j < TN; ++j) p1[j] = p2[j] = 0.0f;
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int gm = m0 + ty + 16 * i;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      p1[j] += acc[i][j];
      p2[j] += acc[i][j] * acc[i][j];
    }
    if (gm >= M) continue;
    float* const row = y + (size_t)gm * N + n0;
    if (kWK) {
#pragma unroll
      for (int j = 0; j < TN; ++j)
        if (n0 + col(j) < N) row[col(j)] = acc[i][j];
    } else {
#pragma unroll
      for (int g = 0; g < TN / 4; ++g)
        if (n0 + col(4 * g) < N)  // N is a multiple of 4: whole groups
          *reinterpret_cast<float4*>(row + col(4 * g)) = make_float4(
              acc[i][4 * g], acc[i][4 * g + 1], acc[i][4 * g + 2],
              acc[i][4 * g + 3]);
    }
  }
  float* const red = smem;  // [2][16][BN]
#pragma unroll
  for (int j = 0; j < TN; ++j) {
    red[ty * BN + col(j)] = p1[j];
    red[(16 + ty) * BN + col(j)] = p2[j];
  }
  __syncthreads();
  for (int c = t; c < 2 * BN; c += kThreads) {
    const int which = c / BN, lc = c % BN;
    if (n0 + lc >= N) continue;
    float sum = 0.0f;
#pragma unroll
    for (int r = 0; r < 16; ++r) sum += red[(which * 16 + r) * BN + lc];  // fixed order
    (which ? ws2 : ws1)[(size_t)blockIdx.y * N + n0 + lc] = sum;
  }
}

template <int BM, int BN, bool kPrologue, bool kWK, int kBlocks>
cudaError_t launch_tile(const float* x, const float* w, const float* scale,
                        const float* shift, float* y, float* ws1, float* ws2,
                        int M, int K, int N, long long x_stride,
                        long long w_stride, cudaStream_t s) {
  constexpr int smem = kStages * (BM + BN) * kPitch * (int)sizeof(float);
  auto kernel = matmul_stats_fma_kernel<BM, BN, kPrologue, kWK, kBlocks>;
  static bool allowed[64] = {};  // once a variant and device
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 0 || dev >= 64 || !allowed[dev]) {
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
    if (dev >= 0 && dev < 64) allowed[dev] = true;
  }
  const dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
  kernel<<<grid, kThreads, smem, s>>>(x, w, scale, shift, y, ws1, ws2, M, K, N,
                                      x_stride, w_stride);
  return cudaGetLastError();
}

template <int BM, int BN, int kBlocks>
cudaError_t launch_variant(const float* x, const float* w, const float* scale,
                           const float* shift, float* y, float* ws1,
                           float* ws2, int M, int K, int N, long long x_stride,
                           long long w_stride, bool w_k_major,
                           cudaStream_t s) {
  if (scale) {
    if (w_k_major)
      return launch_tile<BM, BN, true, true, kBlocks>(
          x, w, scale, shift, y, ws1, ws2, M, K, N, x_stride, w_stride, s);
    return launch_tile<BM, BN, true, false, kBlocks>(
        x, w, scale, shift, y, ws1, ws2, M, K, N, x_stride, w_stride, s);
  }
  if (w_k_major)
    return launch_tile<BM, BN, false, true, kBlocks>(
        x, w, scale, shift, y, ws1, ws2, M, K, N, x_stride, w_stride, s);
  return launch_tile<BM, BN, false, false, kBlocks>(
      x, w, scale, shift, y, ws1, ws2, M, K, N, x_stride, w_stride, s);
}

}  // namespace

// Rows of y per block at this M and N: the wrapper sizes the workspace
// with it.
extern "C" int vt_matmul_stats_fma_tile_m(int M, int N) {
  int bm, bn;
  choose_tile(M, N, &bm, &bn);
  return bm;
}

// x [M, K] f32 with row stride x_stride (elements); w [K, N] f32 with
// strides (w_stride_k, w_stride_n), one of them 1; y [M, N] f32 (out,
// contiguous); scale, shift [K] f32 or both null (no prologue);
// ws [2, tiles_m, N] f32 scratch; s1, s2 [N] f32 (out). K >= 4; K, N and the
// non-unit strides multiples of 4; pointers 16-byte aligned.
extern "C" int vt_matmul_stats_fma(const void* x, const void* w,
                                   const float* scale, const float* shift,
                                   void* y, float* ws, float* s1, float* s2,
                                   int M, int K, int N, long long x_stride,
                                   long long w_stride_k, long long w_stride_n,
                                   void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int bm, bn;
  choose_tile(M, N, &bm, &bn);
  const bool w_k_major = !(w_stride_n == 1 && w_stride_k != 1);
  const long long w_stride = w_k_major ? w_stride_n : w_stride_k;
  const int tiles_m = (M + bm - 1) / bm;
  float* ws1 = ws;
  float* ws2 = ws + (size_t)tiles_m * N;
  const float* xp = static_cast<const float*>(x);
  const float* wp = static_cast<const float*>(w);
  float* yp = static_cast<float*>(y);
  cudaError_t err;
  // The 8x8 sums a thread of the 128x128 tile want 168 registers: one block
  // an SM, without spills, where the product dominates (K >= 256), and two
  // blocks at 128 registers where the loads and stores do.
  if (bm == 128 && bn == 128 && K >= 256)
    err = launch_variant<128, 128, 1>(xp, wp, scale, shift, yp, ws1, ws2, M, K,
                                      N, x_stride, w_stride, w_k_major, s);
  else if (bm == 128 && bn == 128)
    err = launch_variant<128, 128, 2>(xp, wp, scale, shift, yp, ws1, ws2, M, K,
                                      N, x_stride, w_stride, w_k_major, s);
  else if (bm == 128)
    err = launch_variant<128, 64, 2>(xp, wp, scale, shift, yp, ws1, ws2, M, K,
                                     N, x_stride, w_stride, w_k_major, s);
  else
    err = launch_variant<64, 64, 2>(xp, wp, scale, shift, yp, ws1, ws2, M, K, N,
                                    x_stride, w_stride, w_k_major, s);
  if (err != cudaSuccess) return (int)err;
  column_sums_kernel<<<dim3((N + 31) / 32, 2), dim3(32, 8), 0, s>>>(
      ws1, ws2, tiles_m, N, s1, s2);
  return (int)cudaGetLastError();
}
