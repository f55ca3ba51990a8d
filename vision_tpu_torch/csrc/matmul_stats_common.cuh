// Shared by the three matmul_stats kernels (matmul_stats.cu,
// matmul_stats_fma.cu, matmul_stats_wgmma.cu): the second pass that adds the
// per-tile column sums, and the choice of output tile of the two fast ones.
// Each source is its own library, so everything here has internal linkage.

#pragma once

#include <cuda_runtime.h>

namespace {

// s[n] = sum over the M tiles of ws[tile, n], in a fixed order.
// grid (ceil(N/32), 2), block (32, 8).
__global__ void column_sums_kernel(const float* __restrict__ ws1,
                                   const float* __restrict__ ws2, int tiles_m,
                                   int N, float* __restrict__ s1,
                                   float* __restrict__ s2) {
  __shared__ float part[8][33];
  const float* ws = blockIdx.y ? ws2 : ws1;
  float* out = blockIdx.y ? s2 : s1;
  const int n = blockIdx.x * 32 + threadIdx.x;
  float acc = 0.0f;
  if (n < N)
    for (int r = threadIdx.y; r < tiles_m; r += 8) acc += ws[(size_t)r * N + n];
  part[threadIdx.y][threadIdx.x] = acc;
  __syncthreads();
  if (threadIdx.y == 0 && n < N) {
    float s = 0.0f;
#pragma unroll
    for (int r = 0; r < 8; ++r) s += part[r][threadIdx.x];
    out[n] = s;
  }
}

constexpr int kFullWave = 132;  // SMs of an H100

// Tile of the call: the largest of 128x128, 128x64, 64x64 whose grid still
// covers every SM once; 64x64 where none does.
void choose_tile(int M, int N, int* bm, int* bn) {
  auto blocks = [&](int m, int n) {
    return (long long)((M + m - 1) / m) * ((N + n - 1) / n);
  };
  if (N > 64 && blocks(128, 128) >= kFullWave) {
    *bm = 128, *bn = 128;
  } else if (blocks(128, 64) >= kFullWave) {
    *bm = 128, *bn = 64;
  } else {
    *bm = 64, *bn = 64;
  }
}

}  // namespace
