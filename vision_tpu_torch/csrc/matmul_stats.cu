// Matrix product with a normalise+ReLU prologue and a column-statistics
// epilogue: the 1x1 convolutions of a ResNet bottleneck in training mode.
//
// Replaces the TPU kernel vision_tpu/ops/_pallas/conv1x1_bn.py:
// _pallas_impl (entry matmul_stats). For x [M, K], w [K, N], both f32 or
// both bf16, and optional scale, shift [K] f32:
//
//   xn = scale ? cast(relu(f32(x) * scale + shift), T) : x   (never stored)
//   y  = cast(sum_k f32(xn) * f32(w), T)                     (f32 accumulation)
//   s1[n] = sum_m f32(y[m, n])      s2[n] = sum_m f32(y[m, n])^2
//
// The statistics are taken from the CAST y, the tensor an unfused batch norm
// would have read, so for bf16 they are not the sums of the accumulator.
//
// The TPU kernel sweeps the M tiles of one N tile in grid order and adds
// into a statistics block that stays resident between grid steps. Hopper
// runs blocks in no order, so the sums cross blocks in two passes instead:
// each block writes the column sums of its own 128 rows into a
// [tiles_m, N] f32 workspace, and column_sums_kernel adds the tiles in a
// fixed order. No float atomics: the result is the same from run to run.
//
// Design: a plain shared-memory tiled product. A block of 256 threads owns
// a 128 x (64 or 128) tile of y; tiles of x (transposed, so a thread reads
// its rows as float4) and w, 16 deep, sit in shared memory as f32; each
// thread keeps 8 x (4 or 8) f32 sums in registers and the next tile's
// global loads are in flight while the current one is multiplied. The
// prologue runs on the x tile as it is loaded, with the multiply and the add
// rounded separately (__fmul_rn, __fadd_rn), as the plain version rounds
// them, so the cast to bf16 cannot flip. Edges are guarded: any M, K, N.
//
// What bounds it: 2*M*K*N operations against M*K + K*N + M*N elements moved.
// At ResNet-50's shapes (K, N from 64 to 2048) f32 is bound by operations
// at the card's FP32 rate except where K or N is 64, and bf16 would be bound
// by bytes at the tensor cores' rate. This kernel multiplies with FP32 FMAs
// in both types (bf16 values are widened on the way into shared memory) and
// reaches a quarter of the FP32 rate. It is the guarded general kernel: the
// shapes whose rows are whole 16-byte units go to matmul_stats_wgmma.cu
// (bf16, tensor cores, TMA) and matmul_stats_fma.cu (f32, cp.async ring);
// this one takes the rest, K = 0 included.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "matmul_stats_common.cuh"

namespace {

constexpr int kBM = 128;       // rows of y per block
constexpr int kBK = 16;        // depth of one shared-memory tile
constexpr int kThreads = 256;  // 16 (tx, columns) x 16 (ty, rows)
constexpr int kTM = 8;         // rows per thread: two groups of 4, 64 apart
constexpr int kPad = 4;        // keeps float4 alignment, spreads the banks

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) {
  return v;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);  // round to nearest even
}

// kTN columns per thread: groups of 4, 64 apart. Block tile 128 x (16*kTN).
template <typename T, bool kPrologue, int kTN>
__global__ void __launch_bounds__(kThreads)
    matmul_stats_kernel(const T* __restrict__ x, const T* __restrict__ w,
                        const float* __restrict__ scale,
                        const float* __restrict__ shift, T* __restrict__ y,
                        float* __restrict__ ws1, float* __restrict__ ws2,
                        int M, int K, int N) {
  constexpr int BN = 16 * kTN;
  __shared__ __align__(16) float As[kBK][kBM + kPad];  // [k][m]
  __shared__ __align__(16) float Bs[kBK][BN];          // [k][n]
  __shared__ float red[2][16][BN];

  const int t = threadIdx.x;
  const int tx = t % 16, ty = t / 16;
  const int m0 = blockIdx.x * kBM;
  const int n0 = blockIdx.y * BN;

  float acc[kTM][kTN];
#pragma unroll
  for (int i = 0; i < kTM; ++i)
#pragma unroll
    for (int j = 0; j < kTN; ++j) acc[i][j] = 0.0f;

  float a_next[kTM], b_next[kTN];

  // x tile: thread (tx, ty) loads column k0+tx of rows m0+ty+16i
  auto load_a = [&](int k0) {
    const int gk = k0 + tx;
    float sc = 0.0f, sh = 0.0f;
    if (kPrologue && gk < K) {
      sc = scale[gk];
      sh = shift[gk];
    }
#pragma unroll
    for (int i = 0; i < kTM; ++i) {
      const int gm = m0 + ty + 16 * i;
      float v = 0.0f;
      if (gm < M && gk < K) {
        v = to_f32(x[(size_t)gm * K + gk]);
        if (kPrologue) {
          const float z = fmaxf(__fadd_rn(__fmul_rn(v, sc), sh), 0.0f);
          v = to_f32(from_f32<T>(z));
        }
      }
      a_next[i] = v;  // rows and columns past the edge stay 0
    }
  };
  // w tile: element t + 256i of the [kBK, BN] tile, row-major
  auto load_b = [&](int k0) {
#pragma unroll
    for (int i = 0; i < kTN; ++i) {
      const int idx = t + kThreads * i;
      const int gk = k0 + idx / BN, gn = n0 + idx % BN;
      b_next[i] = (gk < K && gn < N) ? to_f32(w[(size_t)gk * N + gn]) : 0.0f;
    }
  };

  load_a(0);
  load_b(0);
  for (int k0 = 0; k0 < K; k0 += kBK) {
#pragma unroll
    for (int i = 0; i < kTM; ++i) As[tx][ty + 16 * i] = a_next[i];
#pragma unroll
    for (int i = 0; i < kTN; ++i) {
      const int idx = t + kThreads * i;
      Bs[idx / BN][idx % BN] = b_next[i];
    }
    __syncthreads();
    if (k0 + kBK < K) {  // in flight while this tile is multiplied
      load_a(k0 + kBK);
      load_b(k0 + kBK);
    }
#pragma unroll
    for (int kk = 0; kk < kBK; ++kk) {
      float a[kTM], b[kTN];
#pragma unroll
      for (int g = 0; g < kTM / 4; ++g) {
        const float4 v =
            *reinterpret_cast<const float4*>(&As[kk][g * 64 + ty * 4]);
        a[g * 4 + 0] = v.x, a[g * 4 + 1] = v.y;
        a[g * 4 + 2] = v.z, a[g * 4 + 3] = v.w;
      }
#pragma unroll
      for (int g = 0; g < kTN / 4; ++g) {
        const float4 v =
            *reinterpret_cast<const float4*>(&Bs[kk][g * 64 + tx * 4]);
        b[g * 4 + 0] = v.x, b[g * 4 + 1] = v.y;
        b[g * 4 + 2] = v.z, b[g * 4 + 3] = v.w;
      }
#pragma unroll
      for (int i = 0; i < kTM; ++i)
#pragma unroll
        for (int j = 0; j < kTN; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }

  // epilogue: cast, store, and sum the cast values over this thread's rows
  float p1[kTN], p2[kTN];
#pragma unroll
  for (int j = 0; j < kTN; ++j) p1[j] = p2[j] = 0.0f;
  const bool vec = (N % 4) == 0;  // then every group of 4 is whole and aligned
#pragma unroll
  for (int i = 0; i < kTM; ++i) {
    const int gm = m0 + (i / 4) * 64 + ty * 4 + (i % 4);
    if (gm >= M) continue;
#pragma unroll
    for (int g = 0; g < kTN / 4; ++g) {
      const int gn = n0 + g * 64 + tx * 4;
      __align__(16) T out[4];
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        out[jj] = from_f32<T>(acc[i][g * 4 + jj]);
        const float f = to_f32(out[jj]);  // columns past N hold 0
        p1[g * 4 + jj] += f;
        p2[g * 4 + jj] += f * f;
      }
      T* dst = y + (size_t)gm * N + gn;
      if (vec && gn < N) {
        if constexpr (sizeof(T) == 4)
          *reinterpret_cast<float4*>(dst) = *reinterpret_cast<float4*>(out);
        else
          *reinterpret_cast<uint2*>(dst) = *reinterpret_cast<uint2*>(out);
      } else {
#pragma unroll
        for (int jj = 0; jj < 4; ++jj)
          if (gn + jj < N) dst[jj] = out[jj];
      }
    }
  }
#pragma unroll
  for (int j = 0; j < kTN; ++j) {
    const int lc = (j / 4) * 64 + tx * 4 + (j % 4);
    red[0][ty][lc] = p1[j];
    red[1][ty][lc] = p2[j];
  }
  __syncthreads();
  for (int c = t; c < 2 * BN; c += kThreads) {
    const int which = c / BN, lc = c % BN;
    if (n0 + lc >= N) continue;
    float s = 0.0f;
#pragma unroll
    for (int r = 0; r < 16; ++r) s += red[which][r][lc];  // fixed order
    (which ? ws2 : ws1)[(size_t)blockIdx.x * N + n0 + lc] = s;
  }
}

template <typename T>
cudaError_t launch(const void* x, const void* w, const float* scale,
                   const float* shift, void* y, float* ws, float* s1,
                   float* s2, int M, int K, int N, cudaStream_t s) {
  const int tiles_m = (M + kBM - 1) / kBM;
  float* ws1 = ws;
  float* ws2 = ws + (size_t)tiles_m * N;
  const T* xp = static_cast<const T*>(x);
  const T* wp = static_cast<const T*>(w);
  T* yp = static_cast<T*>(y);
  if (N <= 64) {
    const dim3 grid(tiles_m, (N + 63) / 64);
    if (scale)
      matmul_stats_kernel<T, true, 4><<<grid, kThreads, 0, s>>>(
          xp, wp, scale, shift, yp, ws1, ws2, M, K, N);
    else
      matmul_stats_kernel<T, false, 4><<<grid, kThreads, 0, s>>>(
          xp, wp, scale, shift, yp, ws1, ws2, M, K, N);
  } else {
    const dim3 grid(tiles_m, (N + 127) / 128);
    if (scale)
      matmul_stats_kernel<T, true, 8><<<grid, kThreads, 0, s>>>(
          xp, wp, scale, shift, yp, ws1, ws2, M, K, N);
    else
      matmul_stats_kernel<T, false, 8><<<grid, kThreads, 0, s>>>(
          xp, wp, scale, shift, yp, ws1, ws2, M, K, N);
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  column_sums_kernel<<<dim3((N + 31) / 32, 2), dim3(32, 8), 0, s>>>(
      ws1, ws2, tiles_m, N, s1, s2);
  return cudaGetLastError();
}

}  // namespace

// Rows of y per block: the wrapper sizes the workspace with it.
extern "C" int vt_matmul_stats_tile_m() { return kBM; }

// x [M, K], w [K, N], y [M, N] (out): f32, or bf16 when is_bf16 != 0;
// scale, shift [K] f32 or both null (no prologue); ws [2, tiles_m, N] f32
// scratch; s1, s2 [N] f32 (out). M, N >= 1, K >= 0.
extern "C" int vt_matmul_stats(const void* x, const void* w,
                               const float* scale, const float* shift, void* y,
                               float* ws, float* s1, float* s2, int M, int K,
                               int N, int is_bf16, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return (int)launch<__nv_bfloat16>(x, w, scale, shift, y, ws, s1, s2, M, K,
                                      N, s);
  return (int)launch<float>(x, w, scale, shift, y, ws, s1, s2, M, K, N, s);
}
