// Pieces shared by the flash-attention kernels (flash_attention.cu and
// flash_attention_backward.cu): the tile loads by cp.async, the bf16 A
// fragment of a product from an f32 sum, the f32 product as three TF32
// products (mma.sync m16n8k8) with its operand loads, the arguments of a
// call and the launch over heads.
//
// Layout: q, k, v, do are [B, H, S, D] read through their batch, head and
// row strides (elements; the head dim has unit stride); o, dq, dk, dv are
// written contiguous [B, H, S, D]; lse and di are [B, H, S] f32.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace flash {

constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

struct Tensor4 {  // one [B, H, S, D] input and its strides
  const void* ptr;
  long long sb, sh, ss;
};

struct Args {
  Tensor4 q, k, v, dout;
  const float* lse;  // [B, H, S]
  const float* di;   // [B, H, S]
  void* out0;        // o (forward), dq, or dk
  void* out1;        // dv
  float* lse_out;    // forward only
  int heads, seq;
  int bh0;           // the first (batch, head) of this launch: blockIdx.y + bh0
  float scale;       // the softmax scale
  float scale_log2;  // scale * log2(e): exp(x * scale) = exp2(x * scale_log2)
};

template <typename T>
__device__ __forceinline__ const T* head_ptr(const Tensor4& t, int bh,
                                             int heads) {
  const int b = bh / heads, h = bh % heads;
  return static_cast<const T*>(t.ptr) + b * t.sb + h * t.sh;
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes from global to shared; zero-filled when !valid (src is then
// any readable address and nothing is read from it)
__device__ __forceinline__ void cp_async_16(void* dst, const void* src,
                                            bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_4(void* dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(valid ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Rows row0 .. row0 + ROWS - 1 of one head ([S, D], row stride ss) into
// shared memory [ROWS][PITCH], by NT threads; rows at or past seq are
// zero-filled.
template <typename T, int ROWS, int D, int PITCH, int NT>
__device__ __forceinline__ void load_rows(T* smem, const T* g, long long ss,
                                          int row0, int seq, int tid) {
  constexpr int kPer = 16 / sizeof(T);  // elements in a 16-byte chunk
  constexpr int kChunks = ROWS * D / kPer;
#pragma unroll
  for (int c = tid; c < kChunks; c += NT) {
    const int r = c / (D / kPer), col = (c % (D / kPer)) * kPer;
    const bool ok = row0 + r < seq;
    cp_async_16(smem + r * PITCH + col, ok ? g + (row0 + r) * ss + col : g,
                ok);
  }
}

// element idx of a [S] row statistic (lse or di), zero at or past seq
__device__ __forceinline__ void load_stat(float* dst, const float* g, int idx,
                                          int seq) {
  const bool ok = idx < seq;
  cp_async_4(dst, ok ? g + idx : g, ok);
}

// ---- bf16 pieces -------------------------------------------------------------

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // .x (low half) = lo
  return *reinterpret_cast<uint32_t*>(&v);
}

// The A fragment of a 16x16 block from two 16x8 f32 sums (the columns of
// c_lo, then c_hi), rounded to bf16: P or dS as the left operand of the
// next product (the register A layout of mma.sync m16n8k16 and, a warp's
// 16 rows, of wgmma). Fragments (lane = 4 g + t): a0 (row g, k 2t..2t+1),
// a1 (row g+8), a2 (row g, k 2t+8..), a3 (row g+8, k 2t+8..).
__device__ __forceinline__ void acc_to_a(uint32_t* a, const float* c_lo,
                                         const float* c_hi) {
  a[0] = pack_bf16(c_lo[0], c_lo[1]);
  a[1] = pack_bf16(c_lo[2], c_lo[3]);
  a[2] = pack_bf16(c_hi[0], c_hi[1]);
  a[3] = pack_bf16(c_hi[2], c_hi[3]);
}

// ---- TF32 tensor-core pieces: f32 products as three TF32 products -----------
//
// x = hi + lo: hi is x rounded to tf32 (10 mantissa bits; to nearest, ties
// away, as cvt.rna.tf32.f32 rounds, but on the bits: two integer
// operations, where ptxas expands the cvt into several), lo = x - hi in f32. An
// mma.sync on tf32 operands ignores their low 13 bits (measured on the
// H100), so lo enters truncated to tf32 with no operation. a b ~ a_hi b_lo
// + a_lo b_hi + a_hi b_hi in f32 sums (CUTLASS's OpMultiplyAddFastF32,
// "3xTF32"): the dropped a_lo b_lo and the truncation of lo leave ~2^-21 of
// each product. The tensor core truncates each sum it returns (rounds
// toward zero; measured), so a long chain of products into one sum
// carries a bias of up to half an f32 step a product; where that matters
// the caller sums short chains from zero and adds them in f32 itself.

__device__ __forceinline__ void split_tf32(float x, uint32_t& hi,
                                           uint32_t& lo) {
  hi = (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
  lo = __float_as_uint(x - __uint_as_float(hi));
}

// c[16x8] += a[16x8] * b[8x8], tf32 operands, f32 sums. Fragments (lane =
// 4 g + t): a0 (row g, k t), a1 (row g+8, k t), a2 (row g, k t+4), a3 (row
// g+8, k t+4); b0 (k t, col g), b1 (k t+4, col g); c0, c1 (row g, cols 2t,
// 2t+1), c2, c3 (row g+8).
__device__ __forceinline__ void mma_tf32(float* c, const uint32_t* a,
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// c += a b at f32 accuracy: the two small terms first, then hi hi
__device__ __forceinline__ void mma_3xtf32(float* c, const uint32_t* a_hi,
                                           const uint32_t* a_lo,
                                           const uint32_t* b_hi,
                                           const uint32_t* b_lo) {
  mma_tf32(c, a_hi, b_lo[0], b_lo[1]);
  mma_tf32(c, a_lo, b_hi[0], b_hi[1]);
  mma_tf32(c, a_hi, b_hi[0], b_hi[1]);
}

// The A fragment of rows r0..r0+15, depth k0..k0+7 of a [rows][PITCH]
// array that already holds tf32 values (one of a hi / lo pair).
template <int PITCH>
__device__ __forceinline__ void load_a_tf32(uint32_t* a, const float* s,
                                            int r0, int k0, int lane) {
  const float* const p = s + (r0 + lane / 4) * PITCH + k0 + lane % 4;
  a[0] = __float_as_uint(p[0]);
  a[1] = __float_as_uint(p[8 * PITCH]);
  a[2] = __float_as_uint(p[4]);
  a[3] = __float_as_uint(p[8 * PITCH + 4]);
}

// The B fragment, split, of an f32 tile stored [n][k] (B = tile^T: the
// walked rows of s = q k^T): n rows n0..n0+7, depth k0..k0+7.
template <int PITCH>
__device__ __forceinline__ void load_b_nk_tf32(uint32_t* hi, uint32_t* lo,
                                               const float* s, int n0, int k0,
                                               int lane) {
  const float* const p = s + (n0 + lane / 4) * PITCH + k0 + lane % 4;
  split_tf32(p[0], hi[0], lo[0]);
  split_tf32(p[4], hi[1], lo[1]);
}

// The B fragment, split, of an f32 tile stored [k][n] (B = tile: do, q or
// k in the updates), depth rows k0..k0+7, n columns n0..n0+7, with depth
// slots t and t + 4 taken as rows 2t and 2t + 1: the order in which
// acc_to_a_tf32 turns an accumulator's columns into depth slots.
template <int PITCH>
__device__ __forceinline__ void load_b_kn_tf32(uint32_t* hi, uint32_t* lo,
                                               const float* s, int k0, int n0,
                                               int lane) {
  const float* const p = s + (k0 + 2 * (lane % 4)) * PITCH + n0 + lane / 4;
  split_tf32(p[0], hi[0], lo[0]);
  split_tf32(p[PITCH], hi[1], lo[1]);
}

// The A fragment, split, of a 16x8 f32 sum (P or dS as the left operand of
// the next product), with no shuffle: a thread holds the sum's columns 2t
// and 2t + 1, taken as depth slots t and t + 4 (load_b_kn_tf32 reads B's
// rows in that order). Not the bf16 acc_to_a layout.
__device__ __forceinline__ void acc_to_a_tf32(uint32_t* hi, uint32_t* lo,
                                              const float* c) {
  split_tf32(c[0], hi[0], lo[0]);  // (g, slot t) = (g, col 2t)
  split_tf32(c[2], hi[1], lo[1]);  // (g+8, slot t)
  split_tf32(c[1], hi[2], lo[2]);  // (g, slot t+4) = (g, col 2t+1)
  split_tf32(c[3], hi[3], lo[3]);  // (g+8, slot t+4)
}

constexpr int kMaxGridY = 65535;

// Launches kernel over a grid of (tiles, B H) blocks on stream, in
// launches of at most kMaxGridY heads (the grid's y limit), each after the
// last; dynamic shared memory above 48 KB is asked for first.
template <typename K>
inline cudaError_t launch_heads(K kernel, int smem, int tiles, int bh,
                                int threads, Args a, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  for (int b0 = 0; err == cudaSuccess && b0 < bh; b0 += kMaxGridY) {
    a.bh0 = b0;
    const int n = bh - b0 < kMaxGridY ? bh - b0 : kMaxGridY;
    kernel<<<dim3(tiles, n), threads, smem, stream>>>(a);
    err = cudaGetLastError();
  }
  return err;
}

}  // namespace flash
