// Windowed multi-scale RoIAlign contraction.
//
//   out[k, c, p, q] = sum_y sum_x w_y[k, p, y] * w_x[k, q, x]
//                     * stacked[row0[k] + y, x0[k] + x, c]  / div
//
// Replaces the TPU kernel vision_tpu/ops/_pallas/window_pool.py:
// window_pool_pallas. The TPU kernel DMAs each RoI's whole
// [winy, winx, C] window into VMEM. An f32 window at the Faster R-CNN
// box-head shape (32 x 32 x 256) is 1 MB, far above the 227 KB of shared
// memory a Hopper block has; but a RoI's samples cover only part of its
// window, so only the bounding range of rows and columns with a non-zero
// weight is read at all (10.6 rows x 23.3 columns on average at the box
// head of the Faster R-CNN forward).
//
// Design (persistent blocks of 256 threads):
//
//   work item   one RoI x one slab of 64 channels, taken in turn by the
//               blocks. A block describes its next 16 items at once, a warp
//               an item: the window's bounds check, then the bounding range
//               of rows and columns with a non-zero weight;
//   staging     the range is cut into chunks of 8 rows x 16 columns x 64
//               channels (32 KB) that cp.async copies, 16 bytes a thread
//               and row (4 bytes where C is not a multiple of 4), into a
//               ring of 2 slots; an item's weights travel with its first
//               chunk, into one of 3 weight slots. Each ring slot completes
//               on an mbarrier that every thread arrives on when its copies
//               land (cp.async.mbarrier.arrive.noinc). The producer (every
//               thread, after each barrier) runs ahead as far as the ring
//               and the weight slots allow, across items: the next windows
//               are in flight during this contraction;
//   stage 1     thread (column, 4 channels) keeps PH float4 sums in
//               registers over the rows of its column:
//               rows[p][x][c] = sum_y w_y[p, y] * window[y, x, c];
//   stage 2     per group of 16 columns, thread (p, 4 consecutive q, 4
//               channels): out[c][p][q] += sum_x w_x[q, x] * rows[p][x][c],
//               into a [c][p*q] tile that is one contiguous span of the
//               [K, C, PH, PW] output and is written coalesced.
//
// Both stages are FP32 FMAs on float4 reads of shared memory; the weights
// sit transposed ([y][p], [x][q]) so that those of one row or column are
// float4 broadcasts.
//
// No tensor cores: TF32 would change the arithmetic. The bounds check
// (0 <= row0, row0 + winy <= R, 0 <= x0, x0 + winx <= WMAX, on the whole
// window as the plain version reads it) runs on the card; a window that
// fails it is never read and stops the launch with a trap, which the host
// sees as an error at its next synchronisation.
//
// What bounds it: each block's chain of fetches and barriers. At the box
// head (K=1000, C=256) the bounding ranges are 166 MB, served mostly from
// L2 because windows overlap on the pyramid (the bytes bound counts each
// pyramid cell once), and they stream at under 1 TB/s (H100). The shared
// memory above (111 KB a block at 7x7) admits two blocks an SM; the same
// code at one block an SM ran 1.3-1.7x slower. The sampling rules (CUDA
// edge rules, level extents) live in the weights.
//
// Element types: f32, and bf16 for the amp path, with the same geometry.
// A bf16 pyramid is staged as it lies (a chunk is 16 KB) and widened to f32
// at the multiply-add; weights and sums stay f32. Its 4 channels a thread
// are one 8-byte cp.async where C is a multiple of 4; otherwise, since a
// 2-byte element has no cp.async form, the thread loads them and stores
// them to shared memory itself, and its arrival on the slot's barrier
// (release) follows those stores. A bf16 output is rounded as the JAX
// package rounds it: the f32 sum to bf16, then divided in f32 and rounded
// again (vision_tpu/ops/poolers.py:62,273).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <stdio.h>

#include <algorithm>

namespace {

constexpr int kCS = 64;                        // channels a work item
constexpr int kCols = 16;                      // columns a group
constexpr int kVecs = kCS / 4;                 // float4 a column of a slab
constexpr int kThreads = kCols * kVecs;        // 256: thread (column, float4)
constexpr int kRows = 8;                       // rows a chunk
constexpr int kStages = 2;                     // chunks in the ring
constexpr int kChunk = kRows * kCols * kCS;    // elements a chunk
constexpr int kWSlots = 3;                     // items' weights in shared
constexpr int kDesc = 16;                      // items described at a time
constexpr int kMaxShared = 232448;             // bytes a block may ask for
constexpr unsigned kAll = 0xffffffffu;

struct Desc {
  int k, c0, nch;     // RoI, first channel, channels in the slab
  int ylo, ny, row;   // non-zero rows [ylo, ylo + ny), pyramid row of ylo
  int xlo, nx, col;   // non-zero columns, pyramid column of xlo
};

__device__ __forceinline__ int groups(const Desc& d) {
  return d.ny > 0 && d.nx > 0 ? (d.nx + kCols - 1) / kCols : 0;
}
__device__ __forceinline__ int chunks_per_group(const Desc& d) {
  return (d.ny + kRows - 1) / kRows;
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async8(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src)
               : "memory");
}

// 4 consecutive channels: one copy of 16 (f32) or 8 (bf16) bytes.
__device__ __forceinline__ void cp_async_4ch(float* dst, const float* src) {
  cp_async16(dst, src);
}
__device__ __forceinline__ void cp_async_4ch(__nv_bfloat16* dst,
                                             const __nv_bfloat16* src) {
  cp_async8(dst, src);
}

// 4 consecutive channels of the ring, widened to f32.
__device__ __forceinline__ float4 load_4ch(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float4 load_4ch(const __nv_bfloat16* p) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  const float2 lo = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.x));
  const float2 hi = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.y));
  return make_float4(lo.x, lo.y, hi.x, hi.y);
}

__device__ __forceinline__ float finish(float sum, float div, float*) {
  return sum / div;
}
__device__ __forceinline__ __nv_bfloat16 finish(float sum, float div,
                                                __nv_bfloat16*) {
  return __float2bfloat16_rn(__bfloat162float(__float2bfloat16_rn(sum)) / div);
}

// The barrier's phase completes once every thread's copies issued so far
// have landed; the arrival is one of the count given at init.
__device__ __forceinline__ void arrive_on_copies(uint64_t* bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::"r"(
                   smem_u32(bar))
               : "memory");
}

// For a thread that also stored to the slot itself: the async arrival
// (with .noinc absent) nets zero and holds the phase open until the
// thread's copies land; the plain arrival that follows counts, and its
// release orders the thread's stores before the phase completes.
__device__ __forceinline__ void arrive_on_copies_and_stores(uint64_t* bar) {
  uint64_t state;
  asm volatile("cp.async.mbarrier.arrive.shared::cta.b64 [%0];\n" ::"r"(
                   smem_u32(bar))
               : "memory");
  asm volatile("mbarrier.arrive.shared::cta.b64 %0, [%1];\n"
               : "=l"(state)
               : "r"(smem_u32(bar))
               : "memory");
  (void)state;
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_u32(bar)),
               "r"(count)
               : "memory");
}

// A wait that outlasts ~10 s of clock (an arrival that never comes) traps
// rather than holding the card.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const long long start = clock64();
  uint32_t done;
  do {
    if (clock64() - start > 20000000000LL) __trap();
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(smem_u32(bar)), "r"(parity)
        : "memory");
  } while (!done);
}

__device__ __noinline__ void out_of_bounds(int k, int row0, int x0, int winy,
                                           int winx, int rrows, int wmax) {
  printf("window_pool: the window of RoI %d at (%d, %d) leaves the pyramid "
         "(row0 + %d must be <= %d and x0 + %d <= %d)\n",
         k, row0, x0, winy, rrows, winx, wmax);
  __trap();
}

// kVec: each thread's 4 channels are one cp.async (C % 4 == 0 and the
// pyramid aligned to 4 elements); otherwise element by element.
template <typename T, int kMaxPH, bool kVec>
__global__ void __launch_bounds__(kThreads)
    window_pool_kernel(const T* __restrict__ stacked,
                       const int* __restrict__ row0,
                       const int* __restrict__ x0,
                       const float* __restrict__ wy,
                       const float* __restrict__ wx, int rrows, int wmax,
                       int c, int k_total, int ph, int pw, int winy, int winx,
                       float div, T* __restrict__ out) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  // weights in a slot, transposed so that one row's (column's) weights are
  // float4 broadcasts: w_y as [winy][kMaxPH], w_x as [winx][pwp]
  const int npq = ph * pw, pwp = (pw + 3) & ~3, nwy = ph * winy;
  const int nw = winy * kMaxPH + winx * pwp;
  T* ring = reinterpret_cast<T*>(smem_raw);         // [kStages][kChunk]
  float* s_rows = reinterpret_cast<float*>(ring + kStages * kChunk);
                                                    // [ph][kCols][kCS]
  float* s_out = s_rows + ph * kCols * kCS;         // [kCS][npq]
  float* s_w = s_out + kCS * npq;                   // [kWSlots][nw]
  Desc* s_desc = reinterpret_cast<Desc*>(s_w + kWSlots * nw);  // [kDesc]
  uint64_t* full = reinterpret_cast<uint64_t*>(
      (reinterpret_cast<uintptr_t>(s_desc + kDesc) + 7) & ~uintptr_t(7));

  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const int col = t / kVecs, f = t % kVecs;  // stage 1 and the copies
  const int nslabs = (c + kCS - 1) / kCS;
  const int total = k_total * nslabs;
  auto item_of = [&](int local) {
    return (int)blockIdx.x + local * (int)gridDim.x;
  };

  if (t == 0)
    for (int s = 0; s < kStages; ++s) mbar_init(&full[s], kThreads);

  // The first [lo, lo + n) range of indices i < len at which some of the
  // np rows of w (row stride len) is non-zero, by one warp.
  auto extent = [&](const float* w, int np, int len, int* lo_out) {
    int lo = len, hi = 0;
    for (int base = 0; base < len; base += 32) {
      const int i = base + lane;
      bool nz = false;
      if (i < len)
        for (int p = 0; p < np; ++p) nz |= w[(size_t)p * len + i] != 0.0f;
      const unsigned m = __ballot_sync(kAll, nz);
      if (m) {
        lo = min(lo, base + __ffs(m) - 1);
        hi = base + 32 - __clz(m);
      }
    }
    *lo_out = lo;
    return max(hi - lo, 0);
  };

  // Descriptors of local items [first, first + kDesc), a warp an item: the
  // window's bounds check, then its non-zero row and column range.
  auto describe = [&](int first) {
    for (int j = warp; j < kDesc && item_of(first + j) < total;
         j += kThreads / 32) {
      const int item = item_of(first + j);
      const int k = item / nslabs, slab = item - k * nslabs;
      const int r0 = row0[k], c0 = x0[k];
      if (r0 < 0 || (long long)r0 + winy > rrows || c0 < 0 ||
          (long long)c0 + winx > wmax) {
        if (lane == 0) out_of_bounds(k, r0, c0, winy, winx, rrows, wmax);
        return;  // not reached: the launch has stopped
      }
      int ylo, xlo;
      const int ny = extent(wy + (size_t)k * nwy, ph, winy, &ylo);
      const int nx = extent(wx + (size_t)k * pw * winx, pw, winx, &xlo);
      if (lane == 0) {
        Desc& d = s_desc[(first + j) % kDesc];
        d.k = k, d.c0 = slab * kCS, d.nch = min(kCS, c - slab * kCS);
        d.ylo = ylo, d.ny = ny, d.row = r0 + ylo;
        d.xlo = xlo, d.nx = nx, d.col = c0 + xlo;
      }
    }
  };

  // Copy chunk `q` of local item `local` into ring slot `s` (with chunk 0,
  // the item's weights into its weight slot); every thread arrives once on
  // the slot's barrier.
  auto issue = [&](int local, int q, int s) {
    const Desc& d = s_desc[local % kDesc];
    if (q == 0) {
      float* w = s_w + (local % kWSlots) * nw;
      for (int i = t; i < nwy + pw * winx; i += kThreads) {
        if (i < nwy) {
          const int p = i / winy, y = i - p * winy;
          cp_async4(w + y * kMaxPH + p, wy + (size_t)d.k * nwy + i);
        } else {
          const int j = i - nwy, q = j / winx, x = j - q * winx;
          cp_async4(w + winy * kMaxPH + x * pwp + q,
                    wx + (size_t)d.k * pw * winx + j);
        }
      }
    }
    const int cpg = chunks_per_group(d);
    const int g = q / cpg, y0 = (q - g * cpg) * kRows;
    const int x = g * kCols + col;
    T* dst = ring + s * kChunk + col * kCS + 4 * f;
    if (x < d.nx) {
      const T* src =
          stacked + ((size_t)(d.row + y0) * wmax + d.col + x) * c + d.c0 + 4 * f;
      const size_t row_stride = (size_t)wmax * c;
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        if (y0 + r >= d.ny) break;
        if (kVec) {
          if (4 * f < d.nch)
            cp_async_4ch(dst + r * kCols * kCS, src + r * row_stride);
        } else {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            if (4 * f + e >= d.nch) continue;
            if (sizeof(T) == 4)
              cp_async4(dst + r * kCols * kCS + e, src + r * row_stride + e);
            else
              dst[r * kCols * kCS + e] = src[r * row_stride + e];
          }
        }
      }
    }
    if (sizeof(T) == 4 || kVec)
      arrive_on_copies(&full[s]);
    else
      arrive_on_copies_and_stores(&full[s]);
  };

  // Producer state, the same in every thread: chunk `pq` of local item `pl`
  // is the next to issue; `issued` and `consumed` count chunks. It runs
  // ahead as far as the ring, the weight slots and the described items
  // allow.
  int pl = 0, pq = 0, issued = 0, consumed = 0, described = 0;
  auto issue_available = [&](int current) {
    while (issued - consumed < kStages) {
      if (pl >= described || pl >= current + kWSlots ||
          item_of(pl) >= total)
        break;
      const Desc& d = s_desc[pl % kDesc];
      if (pq >= groups(d) * chunks_per_group(d)) {
        ++pl, pq = 0;
        continue;
      }
      issue(pl, pq, issued % kStages);
      ++issued, ++pq;
    }
  };

  for (int tl = 0; item_of(tl) < total; ++tl) {
    if (tl == described) {  // every item before tl is finished
      __syncthreads();
      describe(tl);
      described = tl + kDesc;
      __syncthreads();
    }
    issue_available(tl);
    const Desc d = s_desc[tl % kDesc];
    const float* wyd = s_w + (tl % kWSlots) * nw;
    const float* wxd = wyd + winy * kMaxPH;
    const int ngroups = groups(d), cpg = chunks_per_group(d);

    for (int g = 0; g < ngroups; ++g) {
      float4 acc[kMaxPH];
#pragma unroll
      for (int p = 0; p < kMaxPH; ++p) acc[p] = make_float4(0.f, 0.f, 0.f, 0.f);
      for (int ci = 0; ci < cpg; ++ci) {
        const int s = consumed % kStages;
        mbar_wait(&full[s], (consumed / kStages) & 1);
        const T* chunk = ring + s * kChunk + col * kCS + 4 * f;
#pragma unroll
        for (int r = 0; r < kRows; ++r) {
          const int y = ci * kRows + r;
          if (y >= d.ny) break;
          const float4 v = load_4ch(chunk + r * kCols * kCS);
          const float4* wr =
              reinterpret_cast<const float4*>(wyd + (d.ylo + y) * kMaxPH);
#pragma unroll
          for (int p4 = 0; p4 < kMaxPH / 4; ++p4) {
            const float4 w4 = wr[p4];
            const float w[4] = {w4.x, w4.y, w4.z, w4.w};
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              float4& a = acc[4 * p4 + e];
              if (4 * p4 + e < ph) {
                a.x += w[e] * v.x;
                a.y += w[e] * v.y;
                a.z += w[e] * v.z;
                a.w += w[e] * v.w;
              }
            }
          }
        }
        ++consumed;
        __syncthreads();  // the slot is read by every thread: free it
        issue_available(tl);
      }
      float4* rows4 = reinterpret_cast<float4*>(s_rows);
#pragma unroll
      for (int p = 0; p < kMaxPH; ++p)
        if (p < ph) rows4[(p * kCols + col) * kVecs + f] = acc[p];
      __syncthreads();

      // thread (p, 4 consecutive q, 4 channels): one float4 of rows and
      // one float4 broadcast of weights a column
      const int nxg = min(kCols, d.nx - g * kCols), nqb = pwp / 4;
      const float4* wx4 = reinterpret_cast<const float4*>(
          wxd + (d.xlo + g * kCols) * pwp);
      for (int pair = t / kVecs; pair < ph * nqb; pair += kCols) {
        const int p = pair / nqb, qb = pair - p * nqb;
        const float4* rp = rows4 + p * kCols * kVecs + f;
        float4 a[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) a[e] = make_float4(0.f, 0.f, 0.f, 0.f);
        for (int x = 0; x < nxg; ++x) {
          const float4 r = rp[x * kVecs];
          const float4 w4 = wx4[x * nqb + qb];
          const float w[4] = {w4.x, w4.y, w4.z, w4.w};
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            a[e].x += w[e] * r.x;
            a[e].y += w[e] * r.y;
            a[e].z += w[e] * r.z;
            a[e].w += w[e] * r.w;
          }
        }
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int q = 4 * qb + e;
          if (q >= pw) break;
          float* o = s_out + 4 * f * npq + p * pw + q;
          if (g == 0) {
            o[0] = a[e].x, o[npq] = a[e].y;
            o[2 * npq] = a[e].z, o[3 * npq] = a[e].w;
          } else {
            o[0] += a[e].x, o[npq] += a[e].y;
            o[2 * npq] += a[e].z, o[3 * npq] += a[e].w;
          }
        }
      }
      __syncthreads();
    }

    T* dst = out + ((size_t)d.k * c + d.c0) * npq;
    for (int i = t; i < d.nch * npq; i += kThreads)
      dst[i] = finish(ngroups ? s_out[i] : 0.0f, div, dst);
    __syncthreads();  // s_out and this item's weight slot are free
  }
}

size_t shared_bytes(size_t elem, int max_ph, int ph, int pw, int winy,
                    int winx) {
  const size_t floats = (size_t)ph * kCols * kCS + (size_t)kCS * ph * pw +
                        kWSlots * ((size_t)winy * max_ph +
                                   (size_t)winx * ((pw + 3) & ~3));
  return (size_t)kStages * kChunk * elem + floats * sizeof(float) +
         kDesc * sizeof(Desc) + 8 + kStages * sizeof(uint64_t);
}

template <typename T, int kMaxPH, bool kVec>
int launch(const void* stacked_v, const int* row0, const int* x0,
           const float* wy, const float* wx, void* out_v, int rrows, int wmax,
           int c, int k, int ph, int pw, int winy, int winx, float div,
           cudaStream_t stream) {
  auto kernel = window_pool_kernel<T, kMaxPH, kVec>;
  const T* stacked = static_cast<const T*>(stacked_v);
  T* out = static_cast<T*>(out_v);
  const size_t smem = shared_bytes(sizeof(T), kMaxPH, ph, pw, winy, winx);
  if (smem > (size_t)kMaxShared) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  int dev = 0, sms = 0, per_sm = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return (int)err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return (int)err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                      kThreads, smem);
  if (err != cudaSuccess) return (int)err;
  const long long items = (long long)k * ((c + kCS - 1) / kCS);
  const long long grid = std::min(items, (long long)sms * std::max(per_sm, 1));
  kernel<<<(int)grid, kThreads, smem, stream>>>(stacked, row0, x0, wy, wx,
                                                 rrows, wmax, c, k, ph, pw,
                                                 winy, winx, div, out);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch(const void* stacked, const int* row0, const int* x0,
             const float* wy, const float* wx, void* out, int rrows, int wmax,
             int c, int k, int ph, int pw, int winy, int winx, float div,
             cudaStream_t s) {
  const bool vec =
      c % 4 == 0 && reinterpret_cast<uintptr_t>(stacked) % (4 * sizeof(T)) == 0;
  if (ph <= 8)
    return vec ? launch<T, 8, true>(stacked, row0, x0, wy, wx, out, rrows,
                                    wmax, c, k, ph, pw, winy, winx, div, s)
               : launch<T, 8, false>(stacked, row0, x0, wy, wx, out, rrows,
                                     wmax, c, k, ph, pw, winy, winx, div, s);
  return vec ? launch<T, 16, true>(stacked, row0, x0, wy, wx, out, rrows, wmax,
                                   c, k, ph, pw, winy, winx, div, s)
             : launch<T, 16, false>(stacked, row0, x0, wy, wx, out, rrows,
                                    wmax, c, k, ph, pw, winy, winx, div, s);
}

}  // namespace

// stacked [rrows, wmax, c] and out [k, c, ph, pw], both f32 (bf16 = 0) or
// both bf16 (bf16 = 1); row0/x0 [k] int32 (each window is checked on the
// card), wy [k, ph, winy] f32, wx [k, pw, winx] f32. ph, pw <= 16.
extern "C" int vt_window_pool(const void* stacked, const int* row0,
                              const int* x0, const float* wy, const float* wx,
                              void* out, int rrows, int wmax, int c, int k,
                              int ph, int pw, int winy, int winx, float div,
                              int bf16, void* stream) {
  if (k == 0 || c == 0) return 0;
  if (ph > 16 || pw > 16 || ph < 1 || pw < 1)
    return (int)cudaErrorInvalidValue;
  if ((long long)k * ((c + kCS - 1) / kCS) > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bf16)
    return dispatch<__nv_bfloat16>(stacked, row0, x0, wy, wx, out, rrows,
                                   wmax, c, k, ph, pw, winy, winx, div, s);
  return dispatch<float>(stacked, row0, x0, wy, wx, out, rrows, wmax, c, k,
                         ph, pw, winy, winx, div, s);
}
