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
// What bounds it on an H100: 4 B H S^2 D operations (q k^T and p v) at the
// tensor cores' 989 TFLOP/s in bf16 or the FP32 units' 67 TFLOP/s in f32,
// and B H S^2 exponentials at the SFUs' ~3.9e12 a second; at D = 64 the
// exponentials weigh as much as the bf16 products. The bytes (q, k, v, o
// once each) are far below both. So the scores never leave the chip, and
// the exponential is one ex2 a score (log2 e folded into the scale).
//
// Design (FlashAttention-2's): a block owns a tile of query rows and walks
// the key tiles of its head in order, keeping each row's running maximum m,
// its running sum l and the output accumulator in registers; the output is
// divided by l once, at the end. Keys at or past S are masked (score -inf)
// in the last tile, and query rows past S are computed and never stored.
// * bf16: 4 warps, 16 query rows each (a 64-row tile), key tiles of 64.
//   q k^T and p v on mma.sync m16n8k16 (bf16 operands, f32 sums); q's
//   fragments stay in registers for the whole walk; K and V tiles arrive by
//   cp.async, double-buffered, one tile ahead; p stays in registers and is
//   rounded to bf16 as the A operand of p v (the accumulator layout of
//   q k^T is the A layout of p v), after the row's running maximum has
//   been taken over the tile.
// * f32: on the FP32 units (no TF32: every agreement check runs with TF32
//   off). A query row belongs to D / 32 neighbouring threads, each holding
//   32 of its q and o values in registers; a score is their partial dot
//   products summed by shuffles. K and V tiles are double-buffered in
//   shared memory and read as broadcast float4s. The row's maximum is
//   updated every 16 keys.
// q, k, v are read through their batch, head and row strides (a view of the
// packed q, k, v projection is read where it lies).

#include <cmath>

#include "flash_common.cuh"

namespace {

using bf16 = __nv_bfloat16;
using flash::Args;

constexpr int kBR = 64;  // bf16: query rows a block
constexpr int kBC = 64;  // keys a tile

template <int D>
constexpr int bf16_smem() {  // q, then k and v double-buffered
  return 5 * kBR * (D + 8) * static_cast<int>(sizeof(bf16));
}

template <int D>
__global__ void __launch_bounds__(128) vt_flash_fwd_bf16(Args a) {
  using namespace flash;
  constexpr int P = D + 8, TILE = kBR * P;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* const qs = reinterpret_cast<bf16*>(smem_raw);
  bf16* const ks = qs + TILE;      // [2][TILE]
  bf16* const vs = ks + 2 * TILE;  // [2][TILE]

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int q0 = blockIdx.x * kBR, bh = a.bh0 + blockIdx.y, seq = a.seq;
  const bf16* const qg = head_ptr<bf16>(a.q, bh, a.heads);
  const bf16* const kg = head_ptr<bf16>(a.k, bh, a.heads);
  const bf16* const vg = head_ptr<bf16>(a.v, bh, a.heads);
  load_rows<bf16, kBR, D, P, 128>(qs, qg, a.q.ss, q0, seq, tid);
  load_rows<bf16, kBC, D, P, 128>(ks, kg, a.k.ss, 0, seq, tid);
  load_rows<bf16, kBC, D, P, 128>(vs, vg, a.v.ss, 0, seq, tid);
  cp_async_commit();

  uint32_t qf[D / 16][4];
  float o[D / 8][4];
#pragma unroll
  for (int t = 0; t < D / 8; ++t) o[t][0] = o[t][1] = o[t][2] = o[t][3] = 0.f;
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};

  const int ntiles = (seq + kBC - 1) / kBC;
  for (int j = 0; j < ntiles; ++j) {
    if (j + 1 < ntiles) {
      const int nb = (j + 1) & 1;
      load_rows<bf16, kBC, D, P, 128>(ks + nb * TILE, kg, a.k.ss,
                                      (j + 1) * kBC, seq, tid);
      load_rows<bf16, kBC, D, P, 128>(vs + nb * TILE, vg, a.v.ss,
                                      (j + 1) * kBC, seq, tid);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    if (j == 0) {
#pragma unroll
      for (int kc = 0; kc < D / 16; ++kc)
        load_a<P>(qf[kc], qs, warp * 16, kc * 16, lane);
    }
    const bf16* const kt = ks + (j & 1) * TILE;
    const bf16* const vt = vs + (j & 1) * TILE;

    float s[kBC / 8][4];
#pragma unroll
    for (int n = 0; n < kBC / 8; ++n) s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
#pragma unroll
    for (int kc = 0; kc < D / 16; ++kc) {
#pragma unroll
      for (int n2 = 0; n2 < kBC / 16; ++n2) {
        uint32_t b[4];
        load_b_nk<P>(b, kt, n2 * 16, kc * 16, lane);
        mma_bf16(s[2 * n2], qf[kc], b[0], b[1]);
        mma_bf16(s[2 * n2 + 1], qf[kc], b[2], b[3]);
      }
    }

    // scale, mask the keys past S, the rows' new maxima
    const int k0 = j * kBC;
    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int n = 0; n < kBC / 8; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = k0 + n * 8 + (lane % 4) * 2 + (e & 1);
        s[n][e] = key < seq ? s[n][e] * a.scale_log2 : -INFINITY;
        mx[e / 2] = fmaxf(mx[e / 2], s[n][e]);
      }
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      // every tile holds a key below S, so mx is finite; exp2(-inf) = 0
      const float alpha = exp2f(m[r] - mx[r]);
      m[r] = mx[r];
      l[r] *= alpha;
#pragma unroll
      for (int t = 0; t < D / 8; ++t) {
        o[t][2 * r] *= alpha;
        o[t][2 * r + 1] *= alpha;
      }
    }
#pragma unroll
    for (int n = 0; n < kBC / 8; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[n][e] = exp2f(s[n][e] - m[e / 2]);
        l[e / 2] += s[n][e];
      }
    }

    // o += p v, p rounded to bf16
#pragma unroll
    for (int kk = 0; kk < kBC / 16; ++kk) {
      uint32_t pa[4];
      acc_to_a(pa, s[2 * kk], s[2 * kk + 1]);
#pragma unroll
      for (int d2 = 0; d2 < D / 16; ++d2) {
        uint32_t b[4];
        load_b_kn<P>(b, vt, kk * 16, d2 * 16, lane);
        mma_bf16(o[2 * d2], pa, b[0], b[1]);
        mma_bf16(o[2 * d2 + 1], pa, b[2], b[3]);
      }
    }
    __syncthreads();  // the buffer is refilled next iteration
  }

  bf16* const og = static_cast<bf16*>(a.out0) + (long long)bh * seq * D;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    const int row = q0 + warp * 16 + lane / 4 + 8 * r;
    if (row < seq) {
      const float inv = 1.f / l[r];
#pragma unroll
      for (int t = 0; t < D / 8; ++t) {
        const int col = t * 8 + (lane % 4) * 2;
        *reinterpret_cast<__nv_bfloat162*>(og + (long long)row * D + col) =
            __floats2bfloat162_rn(o[t][2 * r] * inv, o[t][2 * r + 1] * inv);
      }
      if (lane % 4 == 0)
        a.lse_out[(long long)bh * seq + row] = (m[r] + log2f(l[r])) * kLn2;
    }
  }
}

template <int D>
constexpr int f32_smem() {  // k and v double-buffered
  return 4 * kBC * (D + 4) * static_cast<int>(sizeof(float));
}

constexpr int kChunk = 16;  // keys between two updates of the row maximum

template <int D>
__global__ void __launch_bounds__(256) vt_flash_fwd_f32(Args a) {
  using namespace flash;
  constexpr int C = 8, TPR = D / (4 * C), ROWS = 256 / TPR, P = D + 4;
  constexpr int TILE = kBC * P;
  extern __shared__ float4 smem4[];
  float* const ks = reinterpret_cast<float*>(smem4);  // [2][TILE]
  float* const vs = ks + 2 * TILE;                     // [2][TILE]

  const int tid = threadIdx.x, part = tid % TPR;
  const int row = blockIdx.x * ROWS + tid / TPR;
  const int bh = a.bh0 + blockIdx.y, seq = a.seq;
  const float* const qg = head_ptr<float>(a.q, bh, a.heads);
  const float* const kg = head_ptr<float>(a.k, bh, a.heads);
  const float* const vg = head_ptr<float>(a.v, bh, a.heads);
  load_rows<float, kBC, D, P, 256>(ks, kg, a.k.ss, 0, seq, tid);
  load_rows<float, kBC, D, P, 256>(vs, vg, a.v.ss, 0, seq, tid);
  cp_async_commit();

  const bool valid = row < seq;
  float4 q[C], o[C];
  load_part<TPR, C>(q, valid ? qg + row * a.q.ss : qg, part, valid);
#pragma unroll
  for (int i = 0; i < C; ++i) o[i] = make_float4(0.f, 0.f, 0.f, 0.f);
  float m = -INFINITY, l = 0.f;

  const int ntiles = (seq + kBC - 1) / kBC;
  for (int j = 0; j < ntiles; ++j) {
    if (j + 1 < ntiles) {
      const int nb = (j + 1) & 1;
      load_rows<float, kBC, D, P, 256>(ks + nb * TILE, kg, a.k.ss,
                                       (j + 1) * kBC, seq, tid);
      load_rows<float, kBC, D, P, 256>(vs + nb * TILE, vg, a.v.ss,
                                       (j + 1) * kBC, seq, tid);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const float* const kt = ks + (j & 1) * TILE;
    const float* const vt = vs + (j & 1) * TILE;
    const int nvalid = min(kBC, seq - j * kBC);
    for (int c0 = 0; c0 < nvalid; c0 += kChunk) {
      float s[kChunk];
      float mx = m;
#pragma unroll
      for (int u = 0; u < kChunk; ++u) {
        const float dot = group_sum<TPR>(dot_part<TPR, C>(q, kt + (c0 + u) * P, part));
        s[u] = c0 + u < nvalid ? dot * a.scale_log2 : -INFINITY;
        mx = fmaxf(mx, s[u]);
      }
      const float alpha = exp2f(m - mx);  // the chunk's first key is valid
      m = mx;
      l *= alpha;
#pragma unroll
      for (int i = 0; i < C; ++i) {
        o[i].x *= alpha;
        o[i].y *= alpha;
        o[i].z *= alpha;
        o[i].w *= alpha;
      }
#pragma unroll
      for (int u = 0; u < kChunk; ++u) {
        const float p = exp2f(s[u] - m);  // 0 past S, where v is zero-filled
        l += p;
        axpy_part<TPR, C>(o, p, vt + (c0 + u) * P, part);
      }
    }
    __syncthreads();
  }

  if (valid) {
    float* const og = static_cast<float*>(a.out0) + (long long)bh * seq * D;
    store_part<TPR, C>(og + (long long)row * D, o, 1.f / l, part);
    if (part == 0)
      a.lse_out[(long long)bh * seq + row] = (m + log2f(l)) * kLn2;
  }
}

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
  using flash::launch_heads;
  if (bf16) {
    const int tiles = (seq + kBR - 1) / kBR;
    return d == 64 ? launch_heads(vt_flash_fwd_bf16<64>, bf16_smem<64>(), tiles,
                                  bh, 128, a, stream)
                   : launch_heads(vt_flash_fwd_bf16<128>, bf16_smem<128>(), tiles,
                                  bh, 128, a, stream);
  }
  const int rows = 256 / (d / 32);  // C = 8 chunks a thread
  const int tiles = (seq + rows - 1) / rows;
  return d == 64 ? launch_heads(vt_flash_fwd_f32<64>, f32_smem<64>(), tiles, bh,
                                256, a, stream)
                 : launch_heads(vt_flash_fwd_f32<128>, f32_smem<128>(), tiles,
                                bh, 256, a, stream);
}
