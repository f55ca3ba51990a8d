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
// do v^T, ds k), at 989 TFLOP/s in bf16 or 67 in f32, and one exponential a
// score in each at ~3.9e12 a second. The bytes are far below.
//
// Design: no atomics, so the same inputs give the same bits on every call
// (the repo's backward kernels keep to that). The dk/dv kernel gives a
// block a tile of 64 keys and walks every query tile in order, summing dk
// and dv in registers; the dq kernel gives a block a tile of query rows and
// walks every key tile in order. Query rows past S get p = 0 in the dk/dv
// kernel; keys past S get p = 0 in the dq kernel; rows past S are never
// stored. The walked tiles are double-buffered by cp.async.
// * bf16: 4 warps, 16 rows each; every product on mma.sync m16n8k16 (bf16
//   operands, f32 sums), the operands by ldmatrix (.trans where the
//   product contracts over the tile's rows); p and ds stay in registers and
//   become the A operand of the next product, as in the forward. The dk/dv
//   kernel walks 64 queries a step at D = 64, 32 at D = 128 (registers).
// * f32: the FP32 units, no TF32; a row (query or key) belongs to D / 16
//   neighbouring threads holding 16 of its values each, dot products summed
//   by shuffles, the walked rows read from shared memory as broadcast
//   float4s.

#include "flash_common.cuh"

namespace {

using bf16 = __nv_bfloat16;
using flash::Args;

constexpr int kTile = 64;  // keys a tile (dq kernel), keys a block (dk/dv)

// ---- bf16 -------------------------------------------------------------------

template <int D>
__host__ __device__ constexpr int dkv_rows() {  // queries a step (bf16 dk/dv)
  return D == 64 ? 64 : 32;
}

template <int D>
constexpr int dkv_bf16_smem() {  // k, v; q, do double-buffered; lse, di x2
  return (2 * kTile + 4 * dkv_rows<D>()) * (D + 8) *
             static_cast<int>(sizeof(bf16)) +
         4 * dkv_rows<D>() * static_cast<int>(sizeof(float));
}

template <int D>
__global__ void __launch_bounds__(128) vt_flash_dkv_bf16(Args a) {
  using namespace flash;
  constexpr int BR = dkv_rows<D>(), P = D + 8, KT = kTile * P, QT = BR * P;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* const ks = reinterpret_cast<bf16*>(smem_raw);
  bf16* const vs = ks + KT;
  bf16* const qs = vs + KT;        // [2][QT]
  bf16* const dos = qs + 2 * QT;   // [2][QT]
  float* const stats = reinterpret_cast<float*>(dos + 2 * QT);  // [2][lse, di][BR]

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int k0 = blockIdx.x * kTile, bh = a.bh0 + blockIdx.y, seq = a.seq;
  const bf16* const qg = head_ptr<bf16>(a.q, bh, a.heads);
  const bf16* const kg = head_ptr<bf16>(a.k, bh, a.heads);
  const bf16* const vg = head_ptr<bf16>(a.v, bh, a.heads);
  const bf16* const dg = head_ptr<bf16>(a.dout, bh, a.heads);
  const float* const lse_g = a.lse + (long long)bh * seq;
  const float* const di_g = a.di + (long long)bh * seq;

  auto load_queries = [&](int i, int buf) {
    load_rows<bf16, BR, D, P, 128>(qs + buf * QT, qg, a.q.ss, i * BR, seq, tid);
    load_rows<bf16, BR, D, P, 128>(dos + buf * QT, dg, a.dout.ss, i * BR, seq,
                                   tid);
    float* const st = stats + buf * 2 * BR;
    if (tid < BR) {
      load_stat(st + tid, lse_g, i * BR + tid, seq);
    } else if (tid < 2 * BR) {
      load_stat(st + tid, di_g, i * BR + tid - BR, seq);
    }
  };
  load_rows<bf16, kTile, D, P, 128>(ks, kg, a.k.ss, k0, seq, tid);
  load_rows<bf16, kTile, D, P, 128>(vs, vg, a.v.ss, k0, seq, tid);
  load_queries(0, 0);
  cp_async_commit();

  float dk[D / 8][4], dv[D / 8][4];
#pragma unroll
  for (int t = 0; t < D / 8; ++t)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk[t][e] = dv[t][e] = 0.f;

  const int ntiles = (seq + BR - 1) / BR;
  for (int i = 0; i < ntiles; ++i) {
    if (i + 1 < ntiles) {
      load_queries(i + 1, (i + 1) & 1);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const bf16* const qt = qs + (i & 1) * QT;
    const bf16* const dt = dos + (i & 1) * QT;
    const float* const lse_s = stats + (i & 1) * 2 * BR;
    const float* const di_s = lse_s + BR;

    // s^T = k q^T and dp^T = v do^T: this warp's 16 keys x BR queries
    float s[BR / 8][4], dp[BR / 8][4];
#pragma unroll
    for (int n = 0; n < BR / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = dp[n][e] = 0.f;
#pragma unroll
    for (int kc = 0; kc < D / 16; ++kc) {
      uint32_t ka[4], va[4];
      load_a<P>(ka, ks, warp * 16, kc * 16, lane);
      load_a<P>(va, vs, warp * 16, kc * 16, lane);
#pragma unroll
      for (int n2 = 0; n2 < BR / 16; ++n2) {
        uint32_t b[4];
        load_b_nk<P>(b, qt, n2 * 16, kc * 16, lane);
        mma_bf16(s[2 * n2], ka, b[0], b[1]);
        mma_bf16(s[2 * n2 + 1], ka, b[2], b[3]);
        load_b_nk<P>(b, dt, n2 * 16, kc * 16, lane);
        mma_bf16(dp[2 * n2], va, b[0], b[1]);
        mma_bf16(dp[2 * n2 + 1], va, b[2], b[3]);
      }
    }
    // p^T, and ds^T in place of dp^T
#pragma unroll
    for (int n = 0; n < BR / 8; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = n * 8 + (lane % 4) * 2 + (e & 1);
        const float p =
            i * BR + col < seq
                ? exp2f(s[n][e] * a.scale_log2 - lse_s[col] * kLog2e)
                : 0.f;
        s[n][e] = p;
        dp[n][e] = p * (dp[n][e] - di_s[col]) * a.scale;
      }
    }
    // dv += p^T do, dk += ds^T q
#pragma unroll
    for (int kk = 0; kk < BR / 16; ++kk) {
      uint32_t pa[4], da[4];
      acc_to_a(pa, s[2 * kk], s[2 * kk + 1]);
      acc_to_a(da, dp[2 * kk], dp[2 * kk + 1]);
#pragma unroll
      for (int d2 = 0; d2 < D / 16; ++d2) {
        uint32_t b[4];
        load_b_kn<P>(b, dt, kk * 16, d2 * 16, lane);
        mma_bf16(dv[2 * d2], pa, b[0], b[1]);
        mma_bf16(dv[2 * d2 + 1], pa, b[2], b[3]);
        load_b_kn<P>(b, qt, kk * 16, d2 * 16, lane);
        mma_bf16(dk[2 * d2], da, b[0], b[1]);
        mma_bf16(dk[2 * d2 + 1], da, b[2], b[3]);
      }
    }
    __syncthreads();
  }

  bf16* const dkg = static_cast<bf16*>(a.out0) + (long long)bh * seq * D;
  bf16* const dvg = static_cast<bf16*>(a.out1) + (long long)bh * seq * D;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int key = k0 + warp * 16 + lane / 4 + 8 * r;
    if (key < seq) {
#pragma unroll
      for (int t = 0; t < D / 8; ++t) {
        const long long at = (long long)key * D + t * 8 + (lane % 4) * 2;
        *reinterpret_cast<__nv_bfloat162*>(dkg + at) =
            __floats2bfloat162_rn(dk[t][2 * r], dk[t][2 * r + 1]);
        *reinterpret_cast<__nv_bfloat162*>(dvg + at) =
            __floats2bfloat162_rn(dv[t][2 * r], dv[t][2 * r + 1]);
      }
    }
  }
}

template <int D>
constexpr int dq_bf16_smem() {  // q, do; k, v double-buffered
  return 6 * kTile * (D + 8) * static_cast<int>(sizeof(bf16));
}

template <int D>
__global__ void __launch_bounds__(128) vt_flash_dq_bf16(Args a) {
  using namespace flash;
  constexpr int P = D + 8, TILE = kTile * P;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* const qs = reinterpret_cast<bf16*>(smem_raw);
  bf16* const dos = qs + TILE;
  bf16* const ks = dos + TILE;     // [2][TILE]
  bf16* const vs = ks + 2 * TILE;  // [2][TILE]

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int q0 = blockIdx.x * kTile, bh = a.bh0 + blockIdx.y, seq = a.seq;
  const bf16* const kg = head_ptr<bf16>(a.k, bh, a.heads);
  const bf16* const vg = head_ptr<bf16>(a.v, bh, a.heads);
  load_rows<bf16, kTile, D, P, 128>(qs, head_ptr<bf16>(a.q, bh, a.heads),
                                    a.q.ss, q0, seq, tid);
  load_rows<bf16, kTile, D, P, 128>(dos, head_ptr<bf16>(a.dout, bh, a.heads),
                                    a.dout.ss, q0, seq, tid);
  load_rows<bf16, kTile, D, P, 128>(ks, kg, a.k.ss, 0, seq, tid);
  load_rows<bf16, kTile, D, P, 128>(vs, vg, a.v.ss, 0, seq, tid);
  cp_async_commit();

  float lse2[2], di[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = q0 + warp * 16 + lane / 4 + 8 * r;
    const long long at = (long long)bh * seq + row;
    lse2[r] = row < seq ? a.lse[at] * kLog2e : 0.f;
    di[r] = row < seq ? a.di[at] : 0.f;
  }
  float dq[D / 8][4];
#pragma unroll
  for (int t = 0; t < D / 8; ++t) dq[t][0] = dq[t][1] = dq[t][2] = dq[t][3] = 0.f;

  const int ntiles = (seq + kTile - 1) / kTile;
  for (int j = 0; j < ntiles; ++j) {
    if (j + 1 < ntiles) {
      const int nb = (j + 1) & 1;
      load_rows<bf16, kTile, D, P, 128>(ks + nb * TILE, kg, a.k.ss,
                                        (j + 1) * kTile, seq, tid);
      load_rows<bf16, kTile, D, P, 128>(vs + nb * TILE, vg, a.v.ss,
                                        (j + 1) * kTile, seq, tid);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const bf16* const kt = ks + (j & 1) * TILE;
    const bf16* const vt = vs + (j & 1) * TILE;

    // s = q k^T and dp = do v^T: this warp's 16 rows x 64 keys
    float s[kTile / 8][4], dp[kTile / 8][4];
#pragma unroll
    for (int n = 0; n < kTile / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = dp[n][e] = 0.f;
#pragma unroll
    for (int kc = 0; kc < D / 16; ++kc) {
      uint32_t qa[4], da[4];
      load_a<P>(qa, qs, warp * 16, kc * 16, lane);
      load_a<P>(da, dos, warp * 16, kc * 16, lane);
#pragma unroll
      for (int n2 = 0; n2 < kTile / 16; ++n2) {
        uint32_t b[4];
        load_b_nk<P>(b, kt, n2 * 16, kc * 16, lane);
        mma_bf16(s[2 * n2], qa, b[0], b[1]);
        mma_bf16(s[2 * n2 + 1], qa, b[2], b[3]);
        load_b_nk<P>(b, vt, n2 * 16, kc * 16, lane);
        mma_bf16(dp[2 * n2], da, b[0], b[1]);
        mma_bf16(dp[2 * n2 + 1], da, b[2], b[3]);
      }
    }
    // ds in place of s
    const int k0 = j * kTile;
#pragma unroll
    for (int n = 0; n < kTile / 8; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = k0 + n * 8 + (lane % 4) * 2 + (e & 1);
        const float p =
            key < seq ? exp2f(s[n][e] * a.scale_log2 - lse2[e / 2]) : 0.f;
        s[n][e] = p * (dp[n][e] - di[e / 2]) * a.scale;
      }
    }
    // dq += ds k
#pragma unroll
    for (int kk = 0; kk < kTile / 16; ++kk) {
      uint32_t sa[4];
      acc_to_a(sa, s[2 * kk], s[2 * kk + 1]);
#pragma unroll
      for (int d2 = 0; d2 < D / 16; ++d2) {
        uint32_t b[4];
        load_b_kn<P>(b, kt, kk * 16, d2 * 16, lane);
        mma_bf16(dq[2 * d2], sa, b[0], b[1]);
        mma_bf16(dq[2 * d2 + 1], sa, b[2], b[3]);
      }
    }
    __syncthreads();
  }

  bf16* const dqg = static_cast<bf16*>(a.out0) + (long long)bh * seq * D;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = q0 + warp * 16 + lane / 4 + 8 * r;
    if (row < seq) {
#pragma unroll
      for (int t = 0; t < D / 8; ++t) {
        const long long at = (long long)row * D + t * 8 + (lane % 4) * 2;
        *reinterpret_cast<__nv_bfloat162*>(dqg + at) =
            __floats2bfloat162_rn(dq[t][2 * r], dq[t][2 * r + 1]);
      }
    }
  }
}

// ---- f32 --------------------------------------------------------------------

constexpr int kC = 4;  // float4 chunks of a row a thread: D / 16 threads a row

template <int D>
constexpr int f32_smem() {  // two walked [64][D + 4] tiles double-buffered
  return 4 * kTile * (D + 4) * static_cast<int>(sizeof(float)) +
         4 * kTile * static_cast<int>(sizeof(float));
}

template <int D>
__global__ void __launch_bounds__(256) vt_flash_dkv_f32(Args a) {
  using namespace flash;
  constexpr int TPR = D / (4 * kC), ROWS = 256 / TPR, P = D + 4;
  constexpr int TILE = kTile * P;
  extern __shared__ float4 smem4[];
  float* const qs = reinterpret_cast<float*>(smem4);  // [2][TILE]
  float* const dos = qs + 2 * TILE;                    // [2][TILE]
  float* const stats = dos + 2 * TILE;                 // [2][lse, di][64]

  const int tid = threadIdx.x, part = tid % TPR;
  const int key = blockIdx.x * ROWS + tid / TPR;
  const int bh = a.bh0 + blockIdx.y, seq = a.seq;
  const float* const qg = head_ptr<float>(a.q, bh, a.heads);
  const float* const dg = head_ptr<float>(a.dout, bh, a.heads);
  const float* const lse_g = a.lse + (long long)bh * seq;
  const float* const di_g = a.di + (long long)bh * seq;

  auto load_queries = [&](int i, int buf) {
    load_rows<float, kTile, D, P, 256>(qs + buf * TILE, qg, a.q.ss,
                                       i * kTile, seq, tid);
    load_rows<float, kTile, D, P, 256>(dos + buf * TILE, dg, a.dout.ss,
                                       i * kTile, seq, tid);
    float* const st = stats + buf * 2 * kTile;
    if (tid < kTile) {
      load_stat(st + tid, lse_g, i * kTile + tid, seq);
    } else if (tid < 2 * kTile) {
      load_stat(st + tid, di_g, i * kTile + tid - kTile, seq);
    }
  };
  load_queries(0, 0);
  cp_async_commit();

  const bool valid = key < seq;
  float4 k[kC], v[kC], dk[kC], dv[kC];
  load_part<TPR, kC>(k, valid ? head_ptr<float>(a.k, bh, a.heads) + key * a.k.ss
                      : static_cast<const float*>(a.k.ptr),
             part, valid);
  load_part<TPR, kC>(v, valid ? head_ptr<float>(a.v, bh, a.heads) + key * a.v.ss
                      : static_cast<const float*>(a.v.ptr),
             part, valid);
#pragma unroll
  for (int i = 0; i < kC; ++i)
    dk[i] = dv[i] = make_float4(0.f, 0.f, 0.f, 0.f);

  const int ntiles = (seq + kTile - 1) / kTile;
  for (int i = 0; i < ntiles; ++i) {
    if (i + 1 < ntiles) {
      load_queries(i + 1, (i + 1) & 1);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const float* const qt = qs + (i & 1) * TILE;
    const float* const dt = dos + (i & 1) * TILE;
    const float* const lse_s = stats + (i & 1) * 2 * kTile;
    const float* const di_s = lse_s + kTile;
    const int nvalid = min(kTile, seq - i * kTile);
#pragma unroll 2
    for (int u = 0; u < nvalid; ++u) {
      const float* const qrow = qt + u * P;
      const float* const drow = dt + u * P;
      const float s = group_sum<TPR>(dot_part<TPR, kC>(k, qrow, part));
      const float dp = group_sum<TPR>(dot_part<TPR, kC>(v, drow, part));
      const float p = exp2f(s * a.scale_log2 - lse_s[u] * kLog2e);
      axpy_part<TPR, kC>(dv, p, drow, part);
      axpy_part<TPR, kC>(dk, p * (dp - di_s[u]) * a.scale, qrow, part);
    }
    __syncthreads();
  }

  if (valid) {
    const long long at = ((long long)bh * seq + key) * D;
    store_part<TPR, kC>(static_cast<float*>(a.out0) + at, dk, 1.f, part);
    store_part<TPR, kC>(static_cast<float*>(a.out1) + at, dv, 1.f, part);
  }
}

template <int D>
__global__ void __launch_bounds__(256) vt_flash_dq_f32(Args a) {
  using namespace flash;
  constexpr int TPR = D / (4 * kC), ROWS = 256 / TPR, P = D + 4;
  constexpr int TILE = kTile * P;
  extern __shared__ float4 smem4[];
  float* const ks = reinterpret_cast<float*>(smem4);  // [2][TILE]
  float* const vs = ks + 2 * TILE;                     // [2][TILE]

  const int tid = threadIdx.x, part = tid % TPR;
  const int row = blockIdx.x * ROWS + tid / TPR;
  const int bh = a.bh0 + blockIdx.y, seq = a.seq;
  const float* const kg = head_ptr<float>(a.k, bh, a.heads);
  const float* const vg = head_ptr<float>(a.v, bh, a.heads);
  load_rows<float, kTile, D, P, 256>(ks, kg, a.k.ss, 0, seq, tid);
  load_rows<float, kTile, D, P, 256>(vs, vg, a.v.ss, 0, seq, tid);
  cp_async_commit();

  const bool valid = row < seq;
  float4 q[kC], dout[kC], dq[kC];
  load_part<TPR, kC>(q, valid ? head_ptr<float>(a.q, bh, a.heads) + row * a.q.ss
                      : static_cast<const float*>(a.q.ptr),
             part, valid);
  load_part<TPR, kC>(dout, valid ? head_ptr<float>(a.dout, bh, a.heads) +
                               row * a.dout.ss
                         : static_cast<const float*>(a.dout.ptr),
             part, valid);
#pragma unroll
  for (int i = 0; i < kC; ++i) dq[i] = make_float4(0.f, 0.f, 0.f, 0.f);
  const long long at = (long long)bh * seq + row;
  const float lse2 = valid ? a.lse[at] * kLog2e : 0.f;
  const float di = valid ? a.di[at] : 0.f;

  const int ntiles = (seq + kTile - 1) / kTile;
  for (int j = 0; j < ntiles; ++j) {
    if (j + 1 < ntiles) {
      const int nb = (j + 1) & 1;
      load_rows<float, kTile, D, P, 256>(ks + nb * TILE, kg, a.k.ss,
                                         (j + 1) * kTile, seq, tid);
      load_rows<float, kTile, D, P, 256>(vs + nb * TILE, vg, a.v.ss,
                                         (j + 1) * kTile, seq, tid);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const float* const kt = ks + (j & 1) * TILE;
    const float* const vt = vs + (j & 1) * TILE;
    const int nvalid = min(kTile, seq - j * kTile);
#pragma unroll 2
    for (int u = 0; u < nvalid; ++u) {
      const float* const krow = kt + u * P;
      const float s = group_sum<TPR>(dot_part<TPR, kC>(q, krow, part));
      const float dp = group_sum<TPR>(dot_part<TPR, kC>(dout, vt + u * P, part));
      const float p = exp2f(s * a.scale_log2 - lse2);
      axpy_part<TPR, kC>(dq, p * (dp - di) * a.scale, krow, part);
    }
    __syncthreads();
  }

  if (valid)
    store_part<TPR, kC>(static_cast<float*>(a.out0) + at * D, dq, 1.f, part);
}

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
  using flash::launch_heads;
  if (bf16) {
    const int tiles = (seq + kTile - 1) / kTile;
    return d == 64 ? launch_heads(vt_flash_dkv_bf16<64>, dkv_bf16_smem<64>(),
                                  tiles, bh, 128, a, stream)
                   : launch_heads(vt_flash_dkv_bf16<128>, dkv_bf16_smem<128>(),
                                  tiles, bh, 128, a, stream);
  }
  const int rows = 256 / (d / (4 * kC));
  const int tiles = (seq + rows - 1) / rows;
  return d == 64 ? launch_heads(vt_flash_dkv_f32<64>, f32_smem<64>(), tiles, bh,
                                256, a, stream)
                 : launch_heads(vt_flash_dkv_f32<128>, f32_smem<128>(), tiles,
                                bh, 256, a, stream);
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
  using flash::launch_heads;
  if (bf16) {
    const int tiles = (seq + kTile - 1) / kTile;
    return d == 64 ? launch_heads(vt_flash_dq_bf16<64>, dq_bf16_smem<64>(), tiles,
                                  bh, 128, a, stream)
                   : launch_heads(vt_flash_dq_bf16<128>, dq_bf16_smem<128>(),
                                  tiles, bh, 128, a, stream);
  }
  const int rows = 256 / (d / (4 * kC));
  const int tiles = (seq + rows - 1) / rows;
  return d == 64 ? launch_heads(vt_flash_dq_f32<64>, f32_smem<64>(), tiles, bh,
                                256, a, stream)
                 : launch_heads(vt_flash_dq_f32<128>, f32_smem<128>(), tiles,
                                bh, 256, a, stream);
}
