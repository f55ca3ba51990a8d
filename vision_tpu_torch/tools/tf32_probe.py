"""What the f32 flash-attention backward kernels rely on in the card's
``mma.sync`` on TF32 operands, measured: whether an operand's low 13 bits
(below tf32's last place) are read, how the f32 sum it returns is rounded,
and the rate of ``m16n8k8`` TF32 products (and, beside it, of ``m16n8k16``
bf16) with every warp keeping 8 independent sums.

    python -m vision_tpu_torch.tools.tf32_probe

A small CUDA program is written to a temporary directory, built with
``nvcc`` for ``sm_90a`` and run; it prints one JSON line per probe, then
the card's name and power limit. Needs a CUDA device and ``nvcc``.
"""

from __future__ import annotations

import subprocess
import sys
import tempfile
from pathlib import Path

from vision_tpu_torch import _kernels

SOURCE = r"""
#include <cstdio>
#include <cstdint>
#include <cuda_runtime.h>

// D(0, 0) = c + a0 b0 + a1 b1: lane 0 holds A(0, 0), B(0, 0); lane 1
// A(0, 1), B(1, 0); every other element is 0
__global__ void one(const float* in, float* out) {
  const int lane = threadIdx.x;
  uint32_t a[4] = {0, 0, 0, 0}, b0 = 0, b1 = 0;
  float c[4] = {in[4], in[4], in[4], in[4]};
  if (lane < 2) {
    a[0] = __float_as_uint(in[2 * lane]);
    b0 = __float_as_uint(in[2 * lane + 1]);
  }
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
  if (lane == 0) out[0] = c[0];
}

float run_one(float a0, float b0, float a1, float b1, float c) {
  float h[5] = {a0, b0, a1, b1, c}, r, *d_in, *d_out;
  cudaMalloc(&d_in, sizeof h);
  cudaMalloc(&d_out, 4);
  cudaMemcpy(d_in, h, sizeof h, cudaMemcpyHostToDevice);
  one<<<1, 32>>>(d_in, d_out);
  cudaMemcpy(&r, d_out, 4, cudaMemcpyDeviceToHost);
  cudaFree(d_in);
  cudaFree(d_out);
  return r;
}

template <bool kTf32>
__global__ void rate(float* out, int iters) {
  float c[8][4] = {};
  const uint32_t a[4] = {threadIdx.x, 1u, 2u, 3u}, b0 = 5u, b1 = 7u;
  for (int i = 0; i < iters; ++i) {
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      if (kTf32)
        asm volatile(
            "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
            "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
            : "+f"(c[j][0]), "+f"(c[j][1]), "+f"(c[j][2]), "+f"(c[j][3])
            : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
      else
        asm volatile(
            "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
            "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
            : "+f"(c[j][0]), "+f"(c[j][1]), "+f"(c[j][2]), "+f"(c[j][3])
            : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
    }
  }
  float s = 0.f;
  for (int j = 0; j < 8; ++j) s += c[j][0] + c[j][1] + c[j][2] + c[j][3];
  out[blockIdx.x * blockDim.x + threadIdx.x] = s;
}

int main() {
  const float u13 = 1.0f / 8192, half_ulp = 1.0f / (1 << 24);
  printf("{\"probe\": \"operand low 13 bits\", \"1+2^-13 times 1\": %.9g, "
         "\"1+3*2^-13 times 1\": %.9g, \"if read\": %.9g}\n",
         run_one(1 + u13, 1, 0, 0, 0), run_one(1 + 3 * u13, 1, 0, 0, 0),
         1 + u13);
  printf("{\"probe\": \"rounding of the sum\", \"1 + 1.5 half-ulps\": %.9g, "
         "\"-1 - 1.5 half-ulps\": %.9g, \"1 + 2 x 1.2 half-ulps\": %.9g, "
         "\"to nearest would give\": [%.9g, %.9g, %.9g]}\n",
         run_one(1.5f * half_ulp, 1, 0, 0, 1.f),
         run_one(-1.5f * half_ulp, 1, 0, 0, -1.f),
         run_one(1.2f * half_ulp, 1, 1.2f * half_ulp, 1, 1.f),
         1.f + 2 * half_ulp, -1.f - 2 * half_ulp, 1.f + 2 * half_ulp);
  float* out;
  int sms = 0;
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, 0);
  cudaMalloc(&out, (size_t)sms * 4 * 512 * 4);
  cudaEvent_t e0, e1;
  cudaEventCreate(&e0);
  cudaEventCreate(&e1);
  const int iters = 4096;
  for (int warps : {4, 8, 16}) {
    for (int tf32 = 1; tf32 >= 0; --tf32) {
      float ms = 0.f;
      for (int rep = 0; rep < 2; ++rep) {  // the first run warms up
        cudaEventRecord(e0);
        if (tf32)
          rate<true><<<sms * 4, warps * 32>>>(out, iters);
        else
          rate<false><<<sms * 4, warps * 32>>>(out, iters);
        cudaEventRecord(e1);
        cudaEventSynchronize(e1);
        cudaEventElapsedTime(&ms, e0, e1);
      }
      const double flops =
          (double)sms * 4 * warps * iters * 8 * (tf32 ? 2048.0 : 4096.0);
      printf("{\"probe\": \"mma.sync rate\", \"product\": \"%s\", "
             "\"warps_a_block\": %d, \"blocks_an_sm\": 4, \"tflops\": %.1f}\n",
             tf32 ? "tf32 m16n8k8" : "bf16 m16n8k16", warps,
             flops / ms / 1e9);
    }
  }
  return cudaGetLastError() != cudaSuccess;
}
"""


def main() -> int:
    with tempfile.TemporaryDirectory() as tmp:
        src, exe = Path(tmp) / "tf32_probe.cu", Path(tmp) / "tf32_probe"
        src.write_text(SOURCE)
        subprocess.run([_kernels._nvcc(), "-gencode",
                        "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
                        "-o", str(exe), str(src)], check=True)
        code = subprocess.run([str(exe)]).returncode
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip(), flush=True)
    return code


if __name__ == "__main__":
    sys.exit(main())
