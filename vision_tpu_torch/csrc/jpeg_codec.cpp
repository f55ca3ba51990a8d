// Baseline JPEG codec of the port, in plain C++17 with no library: the
// counterpart of the JPEG half of vision_tpu/csrc/image_codecs.cpp, which
// links libjpeg. The machine with the card has no libjpeg, libpng or PIL,
// so the port carries its own.
//
// C ABI (bound with ctypes by vision_tpu_torch/io/_codecs.py):
//   vt_jpeg_coefficients  entropy decode only: the quantised DCT
//                         coefficients, natural order, as libjpeg's
//                         jpeg_read_coefficients gives them (the same
//                         outputs as vtpu_jpeg_coefficients);
//   vt_decode_jpeg        the whole decode on the host, in the float
//                         arithmetic of the device path
//                         (vision_tpu_torch/io/jpeg_device.py);
//   vt_encode_jpeg        a baseline encoder with libjpeg's defaults
//                         (Annex K tables scaled by IJG's quality formula,
//                         2x2/1x1/1x1 sampling, the standard Huffman
//                         tables, a JFIF APP0 segment);
//   vt_free               frees what the others allocated.
// vt_jpeg_coefficients_to and vt_decode_jpeg_to write into the caller's
// buffers instead (a batch's slot), and allocate nothing once their thread
// has decoded an image of that size.
//
// Streams: baseline sequential Huffman (SOF0, and SOF1 with 8-bit
// samples), 1 or 3 components, sampling factors 1 or 2, restart intervals,
// interleaved or single-component scans. Progressive, arithmetic-coded,
// lossless or hierarchical, 12-bit and 2- or 4-component streams return a
// distinct positive code; a corrupt or truncated stream returns -1. No
// read goes past `len`.
//
// Build: g++ -O2 -shared -fPIC -std=c++17 -ffp-contract=off jpeg_codec.cpp
// (-ffp-contract=off: every float product and sum rounds on its own, as
// in the device path's f32 arithmetic).

#include <cmath>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <new>
#include <vector>

namespace {

enum Status {
  kOk = 0,
  kCorrupt = -1,
  kNoMemory = -2,
  kProgressive = 1,
  kArithmetic = 2,
  kLossless = 3,
  kPrecision = 4,
  kComponents = 5,
  kSampling = 6,
  kCapacity = 7,  // the caller's buffer is missing or too small
};

// Per-thread scratch, grown as needed and kept: once a thread has decoded
// an image of a size, the next one of that size allocates (and faults in)
// no memory. Fresh pages for every image made the decode threads of a
// virtual machine's host wait on each other.
struct Scratch {
  std::vector<int16_t> coef;
  std::vector<float> planes;
  std::vector<float> rows;
};
thread_local Scratch scratch;

// zigzag position -> natural (row-major) index; 16 guard entries keep a
// corrupt run inside the block, as libjpeg's jpeg_natural_order does
const int kNatural[64 + 16] = {
    0,  1,  8,  16, 9,  2,  3,  10, 17, 24, 32, 25, 18, 11, 4,  5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6,  7,  14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63,
    63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63};

// ------------------------------------------------------------ decoding

constexpr int kFastBits = 9;

struct Huffman {
  bool defined = false;
  uint16_t fast[1 << kFastBits];  // (length << 8) | symbol, 0: slow path
  int maxcode[18];
  int mincode[17];
  int valptr[17];
  uint8_t vals[256];
};

bool build_huffman(Huffman* h, const uint8_t* bits, const uint8_t* vals,
                   int nvals) {
  memset(h->fast, 0, sizeof(h->fast));
  memcpy(h->vals, vals, nvals);
  int code = 0, k = 0;
  for (int l = 1; l <= 16; ++l) {
    h->valptr[l] = k;
    h->mincode[l] = code;
    code += bits[l - 1];
    k += bits[l - 1];
    if (code > (1 << l)) return false;  // more codes than the length holds
    h->maxcode[l] = bits[l - 1] ? code - 1 : -1;
    code <<= 1;
  }
  h->maxcode[17] = 0x7fffffff;
  // fast table: every code of at most kFastBits bits, padded with all
  // continuations
  code = 0;
  k = 0;
  for (int l = 1; l <= kFastBits; ++l) {
    for (int i = 0; i < bits[l - 1]; ++i, ++k, ++code) {
      const int shift = kFastBits - l;
      for (int j = 0; j < (1 << shift); ++j)
        h->fast[(code << shift) | j] = (uint16_t)((l << 8) | vals[k]);
    }
    code <<= 1;
  }
  h->defined = true;
  return true;
}

struct BitReader {
  const uint8_t* p;
  const uint8_t* end;
  uint64_t buf = 0;  // valid bits are the top `bits` bits
  int bits = 0;
  int zeros_fed = 0;  // bytes of zeros fed after the data (a marker or the end)
  bool stopped = false;

  void fill() {
    while (bits <= 56) {
      uint32_t c = 0;
      if (!stopped && p < end) {
        c = *p;
        if (c == 0xFF) {
          if (p + 1 < end && p[1] == 0x00) {
            p += 2;  // stuffed 0xFF data byte
          } else {
            stopped = true;  // a marker (or a stream cut at 0xFF)
            c = 0;
            ++zeros_fed;
          }
        } else {
          ++p;
        }
      } else {
        stopped = true;
        ++zeros_fed;
      }
      buf |= (uint64_t)c << (56 - bits);
      bits += 8;
    }
  }
  // true once a bit that is not in the stream has been consumed
  bool overrun() const { return zeros_fed * 8 > bits; }
  uint32_t get(int n) {  // 1 <= n <= 16
    if (bits < n) fill();
    const uint32_t v = (uint32_t)(buf >> (64 - n));
    buf <<= n;
    bits -= n;
    return v;
  }
  void reset() {
    buf = 0;
    bits = 0;
    zeros_fed = 0;
    stopped = false;
  }
};

inline int decode_symbol(BitReader& br, const Huffman& h) {
  if (br.bits < 16) br.fill();
  const uint32_t look = (uint32_t)(br.buf >> 48);
  const uint16_t f = h.fast[look >> (16 - kFastBits)];
  if (f) {
    const int len = f >> 8;
    br.buf <<= len;
    br.bits -= len;
    return f & 0xFF;
  }
  for (int l = kFastBits + 1; l <= 16; ++l) {
    const int code = (int)(look >> (16 - l));
    if (code <= h.maxcode[l]) {
      br.buf <<= l;
      br.bits -= l;
      return h.vals[h.valptr[l] + code - h.mincode[l]];
    }
  }
  return -1;
}

inline int extend(uint32_t v, int s) {
  return v < (1u << (s - 1)) ? (int)v - (1 << s) + 1 : (int)v;
}

struct Component {
  int id = 0;
  int h = 1, v = 1;
  int tq = 0;
  int bw = 0, bh = 0;          // blocks of the component (libjpeg's
                               // width_in_blocks, height_in_blocks)
  int bw_alloc = 0, bh_alloc = 0;  // padded to whole MCUs
  int16_t* coef = nullptr;     // [bh_alloc][bw_alloc][64], natural order,
                               // in scratch.coef
  int dc_pred = 0;
  int td = 0, ta = 0;
};

struct Decoder {
  const uint8_t* data;
  size_t len;
  size_t pos = 0;
  uint16_t qt[4][64];
  bool qt_defined[4] = {false, false, false, false};
  Huffman dc[4], ac[4];
  int restart_interval = 0;
  int width = 0, height = 0, ncomp = 0;
  int hmax = 1, vmax = 1;
  Component comp[3];
  bool frame = false;
  int scans = 0;

  int u16(size_t at) const { return (data[at] << 8) | data[at + 1]; }

  // the next marker at or after pos; 0 at the end of the data
  int next_marker() {
    while (pos < len) {
      if (data[pos] != 0xFF) {
        ++pos;
        continue;
      }
      while (pos < len && data[pos] == 0xFF) ++pos;
      if (pos >= len) return 0;
      const int m = data[pos++];
      if (m != 0x00) return m;
    }
    return 0;
  }

  int read_dqt(size_t seg, size_t seg_end) {
    while (seg < seg_end) {
      const int pq = data[seg] >> 4, tq = data[seg] & 15;
      ++seg;
      if (tq > 3 || pq > 1) return kCorrupt;
      const size_t n = pq ? 128 : 64;
      if (seg + n > seg_end) return kCorrupt;
      for (int k = 0; k < 64; ++k)
        qt[tq][kNatural[k]] =
            pq ? (uint16_t)u16(seg + 2 * k) : (uint16_t)data[seg + k];
      qt_defined[tq] = true;
      seg += n;
    }
    return kOk;
  }

  int read_dht(size_t seg, size_t seg_end) {
    while (seg < seg_end) {
      if (seg + 17 > seg_end) return kCorrupt;
      const int tc = data[seg] >> 4, th = data[seg] & 15;
      if (tc > 1 || th > 3) return kCorrupt;
      const uint8_t* bits = data + seg + 1;
      int n = 0;
      for (int i = 0; i < 16; ++i) n += bits[i];
      if (n > 256 || seg + 17 + n > seg_end) return kCorrupt;
      Huffman* h = tc == 0 ? &dc[th] : &ac[th];
      if (!build_huffman(h, bits, data + seg + 17, n)) return kCorrupt;
      seg += 17 + n;
    }
    return kOk;
  }

  int read_sof(size_t seg, size_t seg_end) {
    if (frame) return kCorrupt;
    if (seg + 6 > seg_end) return kCorrupt;
    if (data[seg] != 8) return kPrecision;
    height = u16(seg + 1);
    width = u16(seg + 3);
    ncomp = data[seg + 5];
    if (ncomp != 1 && ncomp != 3) return kComponents;
    if (height == 0 || width == 0) return kCorrupt;  // DNL is not supported
    if (seg + 6 + 3 * (size_t)ncomp > seg_end) return kCorrupt;
    hmax = vmax = 1;
    for (int i = 0; i < ncomp; ++i) {
      Component& c = comp[i];
      c.id = data[seg + 6 + 3 * i];
      c.h = data[seg + 7 + 3 * i] >> 4;
      c.v = data[seg + 7 + 3 * i] & 15;
      c.tq = data[seg + 8 + 3 * i];
      if (c.h < 1 || c.h > 2 || c.v < 1 || c.v > 2) return kSampling;
      if (c.tq > 3) return kCorrupt;
      hmax = c.h > hmax ? c.h : hmax;
      vmax = c.v > vmax ? c.v : vmax;
    }
    const int mcux = (width + 8 * hmax - 1) / (8 * hmax);
    const int mcuy = (height + 8 * vmax - 1) / (8 * vmax);
    size_t total = 0;
    for (int i = 0; i < ncomp; ++i) {
      Component& c = comp[i];
      c.bw = (int)(((long)width * c.h + 8L * hmax - 1) / (8L * hmax));
      c.bh = (int)(((long)height * c.v + 8L * vmax - 1) / (8L * vmax));
      c.bw_alloc = mcux * c.h;
      c.bh_alloc = mcuy * c.v;
      total += (size_t)c.bw_alloc * c.bh_alloc * 64;
    }
    try {
      scratch.coef.assign(total, 0);
    } catch (const std::bad_alloc&) {
      return kNoMemory;
    }
    total = 0;
    for (int i = 0; i < ncomp; ++i) {
      comp[i].coef = scratch.coef.data() + total;
      total += (size_t)comp[i].bw_alloc * comp[i].bh_alloc * 64;
    }
    frame = true;
    return kOk;
  }

  inline bool decode_block(BitReader& br, Component& c, int16_t* block) {
    const int t = decode_symbol(br, dc[c.td]);
    if (t < 0 || t > 16) return false;
    const int diff = t ? extend(br.get(t), t) : 0;
    c.dc_pred += diff;
    block[0] = (int16_t)c.dc_pred;
    const Huffman& h = ac[c.ta];
    for (int k = 1; k < 64;) {
      const int rs = decode_symbol(br, h);
      if (rs < 0) return false;
      const int r = rs >> 4, s = rs & 15;
      if (s) {
        k += r;
        if (k > 63) return false;
        block[kNatural[k]] = (int16_t)extend(br.get(s), s);
        ++k;
      } else if (r == 15) {
        k += 16;
      } else {
        break;  // end of block
      }
    }
    return true;
  }

  // after the last MCU of an interval: the RSTn marker must follow
  bool restart(BitReader& br) {
    pos = (size_t)(br.p - data);
    const int m = next_marker();
    if (m < 0xD0 || m > 0xD7) return false;
    br.p = data + pos;
    br.reset();
    for (int i = 0; i < ncomp; ++i) comp[i].dc_pred = 0;
    return true;
  }

  int read_sos(size_t seg, size_t seg_end) {
    if (!frame) return kCorrupt;
    if (seg >= seg_end) return kCorrupt;
    const int ns = data[seg];
    if (ns < 1 || ns > ncomp || seg + 1 + 2 * (size_t)ns + 3 > seg_end)
      return kCorrupt;
    Component* sc[3];
    int blocks_per_mcu = 0;
    for (int i = 0; i < ns; ++i) {
      const int id = data[seg + 1 + 2 * i];
      const int tables = data[seg + 2 + 2 * i];
      Component* c = nullptr;
      for (int j = 0; j < ncomp; ++j)
        if (comp[j].id == id) c = &comp[j];
      if (!c) return kCorrupt;
      c->td = tables >> 4;
      c->ta = tables & 15;
      if (c->td > 3 || c->ta > 3 || !dc[c->td].defined || !ac[c->ta].defined)
        return kCorrupt;
      if (!qt_defined[c->tq]) return kCorrupt;
      c->dc_pred = 0;
      sc[i] = c;
      blocks_per_mcu += ns == 1 ? 1 : c->h * c->v;
    }
    if (blocks_per_mcu > 10) return kCorrupt;
    const size_t after = seg + 1 + 2 * ns;
    const int ss = data[after], se = data[after + 1], ahal = data[after + 2];
    if (ss != 0 || se != 63 || ahal != 0) return kCorrupt;

    BitReader br;
    br.p = data + seg_end;
    br.end = data + len;
    int mcus_x, mcus_y;
    if (ns == 1) {
      mcus_x = sc[0]->bw;
      mcus_y = sc[0]->bh;
    } else {
      mcus_x = (width + 8 * hmax - 1) / (8 * hmax);
      mcus_y = (height + 8 * vmax - 1) / (8 * vmax);
    }
    const long total = (long)mcus_x * mcus_y;
    long todo = restart_interval;
    for (long n = 0; n < total; ++n) {
      if (restart_interval) {
        if (todo == 0) {
          if (br.overrun() || !restart(br)) return kCorrupt;
          todo = restart_interval;
        }
        --todo;
      }
      const int mx = (int)(n % mcus_x), my = (int)(n / mcus_x);
      if (ns == 1) {
        Component& c = *sc[0];
        int16_t* block = c.coef + ((size_t)my * c.bw_alloc + mx) * 64;
        if (!decode_block(br, c, block)) return kCorrupt;
      } else {
        for (int i = 0; i < ns; ++i) {
          Component& c = *sc[i];
          for (int y = 0; y < c.v; ++y)
            for (int x = 0; x < c.h; ++x) {
              const size_t by = (size_t)my * c.v + y, bx = (size_t)mx * c.h + x;
              if (!decode_block(br, c, c.coef + (by * c.bw_alloc + bx) * 64))
                return kCorrupt;
            }
        }
      }
      if (br.overrun()) return kCorrupt;
    }
    pos = (size_t)(br.p - data);
    ++scans;
    return kOk;
  }

  int run() {
    if (len < 4 || data[0] != 0xFF || data[1] != 0xD8) return kCorrupt;
    pos = 2;
    for (;;) {
      const int m = next_marker();
      if (m == 0 || m == 0xD9) break;  // end of data, or EOI
      if (m == 0x01 || (m >= 0xD0 && m <= 0xD7)) continue;  // no length
      if (m == 0xD8) return kCorrupt;
      if (pos + 2 > len) return kCorrupt;
      const size_t seg_len = (size_t)u16(pos);
      if (seg_len < 2 || pos + seg_len > len) return kCorrupt;
      const size_t seg = pos + 2, seg_end = pos + seg_len;
      int rc = kOk;
      switch (m) {
        case 0xC0:
        case 0xC1:
          rc = read_sof(seg, seg_end);
          break;
        case 0xC2:
        case 0xC6:
          return kProgressive;
        case 0xC9:
        case 0xCA:
        case 0xCB:
        case 0xCC:  // DAC: arithmetic conditioning
        case 0xCD:
        case 0xCE:
        case 0xCF:
          return kArithmetic;
        case 0xC3:
        case 0xC5:
        case 0xC7:
          return kLossless;
        case 0xC4:
          rc = read_dht(seg, seg_end);
          break;
        case 0xDB:
          rc = read_dqt(seg, seg_end);
          break;
        case 0xDD:
          if (seg_len != 4) return kCorrupt;
          restart_interval = u16(seg);
          break;
        case 0xDA:
          pos = seg_end;
          rc = read_sos(seg, seg_end);
          if (rc != kOk) return rc;
          continue;  // pos is past the scan's data
        default:
          break;  // APPn, COM and the rest: skipped
      }
      if (rc != kOk) return rc;
      pos = seg_end;
    }
    if (!frame || scans == 0) return kCorrupt;
    return kOk;
  }
};

// B_m[u][j] = c(u)/2 cos((2j+1) u pi / (2m)), c(0) = 1/sqrt(2): the basis of
// vision_tpu/io/jpeg_tpu.py:_idct_basis, computed in double and rounded to
// float as numpy rounds it there
void idct_basis(int m, float* b) {
  const double pi = 3.14159265358979323846;
  for (int u = 0; u < m; ++u)
    for (int j = 0; j < m; ++j) {
      double v = 0.5 * std::cos((2 * j + 1) * u * pi / (2.0 * m));
      if (u == 0) v *= 1.0 / std::sqrt(2.0);
      b[u * m + j] = (float)v;
    }
}

// one component's float plane, (bh*M) x (bw*M), level-shifted by 128 and
// not clamped: dequantise the top-left M x M, then B^T F B. M is a template
// argument so that the loops have fixed trip counts.
template <int M>
void component_plane(const Component& c, const uint16_t* q, const float* b,
                     float* plane) {
  const size_t stride = (size_t)c.bw * M;
  float qf[64];
  for (int k = 0; k < 64; ++k) qf[k] = (float)q[k];
  for (int by = 0; by < c.bh; ++by)
    for (int bx = 0; bx < c.bw; ++bx) {
      const int16_t* blk = c.coef + ((size_t)by * c.bw_alloc + bx) * 64;
      float t[M][M];  // t[u][j] = sum_v F[u][v] B[v][j]
      int rows = 0;     // rows of F past the last non-zero one add nothing
      for (int u = 0; u < M; ++u) {
        for (int j = 0; j < M; ++j) t[u][j] = 0.f;
        for (int v = 0; v < M; ++v) {
          const int16_t cf = blk[u * 8 + v];
          if (!cf) continue;
          rows = u + 1;
          const float f = (float)cf * qf[u * 8 + v];
          for (int j = 0; j < M; ++j) t[u][j] += f * b[v * M + j];
        }
      }
      float* out = plane + (size_t)by * M * stride + (size_t)bx * M;
      for (int i = 0; i < M; ++i) {
        float acc[M];
        for (int j = 0; j < M; ++j) acc[j] = 0.f;
        for (int u = 0; u < rows; ++u) {
          const float bu = b[u * M + i];
          for (int j = 0; j < M; ++j) acc[j] += bu * t[u][j];
        }
        for (int j = 0; j < M; ++j) out[i * stride + j] = acc[j] + 128.f;
      }
    }
}

void plane_for(int m, const Component& c, const uint16_t* q, const float* b,
               float* plane) {
  switch (m) {
    case 1: component_plane<1>(c, q, b, plane); break;
    case 2: component_plane<2>(c, q, b, plane); break;
    case 3: component_plane<3>(c, q, b, plane); break;
    case 4: component_plane<4>(c, q, b, plane); break;
    case 5: component_plane<5>(c, q, b, plane); break;
    case 6: component_plane<6>(c, q, b, plane); break;
    case 7: component_plane<7>(c, q, b, plane); break;
    default: component_plane<8>(c, q, b, plane); break;
  }
}

// row i of a plane upsampled by f (1 or 2) along both axes, half-pixel
// centres, weights 0.75 / 0.25, an edge sample taking its own value (the
// bilinear filter of jax.image.resize, renormalised at the border); the
// vertical pass first, as jax.image.resize contracts the axes in order
void upsampled_row(const float* plane, int ph, int pw, int fv, int fh, int i,
                   int width, float* tmp, float* out) {
  const float* src;
  if (fv == 1) {
    src = plane + (size_t)i * pw;
  } else {
    const int k = i >> 1;
    const float* r = plane + (size_t)k * pw;
    const int other = (i & 1) ? k + 1 : k - 1;
    if (other < 0 || other >= ph) {
      src = r;
    } else {
      const float* o = plane + (size_t)other * pw;
      if (i & 1)
        for (int x = 0; x < pw; ++x) tmp[x] = 0.75f * r[x] + 0.25f * o[x];
      else
        for (int x = 0; x < pw; ++x) tmp[x] = 0.25f * o[x] + 0.75f * r[x];
      src = tmp;
    }
  }
  if (fh == 1) {
    memcpy(out, src, sizeof(float) * width);
    return;
  }
  for (int j = 0; j < width; ++j) {
    const int k = j >> 1;
    const int other = (j & 1) ? k + 1 : k - 1;
    if (other < 0 || other >= pw)
      out[j] = src[k];
    else if (j & 1)
      out[j] = 0.75f * src[k] + 0.25f * src[other];
    else
      out[j] = 0.25f * src[other] + 0.75f * src[k];
  }
}

// clip to [0, 255] and round half to even, as jnp.clip(jnp.round(.)):
// clipping first to [-1, 256] gives the same result, and below 2^22 adding
// and taking away 1.5 * 2^23 rounds to the nearest even integer (without a
// libm call)
inline uint8_t to_u8(float v) {
  v = v < -1.f ? -1.f : (v > 256.f ? 256.f : v);
  v = (v + 12582912.f) - 12582912.f;  // no -ffast-math: not folded
  return (uint8_t)(v < 0.f ? 0.f : (v > 255.f ? 255.f : v));
}

// ------------------------------------------------------------ encoding

const uint8_t kStdLuminanceQ[64] = {
    16, 11, 10, 16, 24,  40,  51,  61,  12, 12, 14, 19, 26,  58,  60,  55,
    14, 13, 16, 24, 40,  57,  69,  56,  14, 17, 22, 29, 51,  87,  80,  62,
    18, 22, 37, 56, 68,  109, 103, 77,  24, 35, 55, 64, 81,  104, 113, 92,
    49, 64, 78, 87, 103, 121, 120, 101, 72, 92, 95, 98, 112, 100, 103, 99};
const uint8_t kStdChrominanceQ[64] = {
    17, 18, 24, 47, 99, 99, 99, 99, 18, 21, 26, 66, 99, 99, 99, 99,
    24, 26, 56, 99, 99, 99, 99, 99, 47, 66, 99, 99, 99, 99, 99, 99,
    99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99,
    99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99};

const uint8_t kDcLumBits[16] = {0, 1, 5, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0, 0, 0};
const uint8_t kDcChromBits[16] = {0, 3, 1, 1, 1, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0};
const uint8_t kDcVals[12] = {0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11};
const uint8_t kAcLumBits[16] = {0, 2, 1, 3, 3, 2, 4, 3, 5, 5, 4, 4, 0, 0, 1, 0x7d};
const uint8_t kAcLumVals[162] = {
    0x01, 0x02, 0x03, 0x00, 0x04, 0x11, 0x05, 0x12, 0x21, 0x31, 0x41, 0x06,
    0x13, 0x51, 0x61, 0x07, 0x22, 0x71, 0x14, 0x32, 0x81, 0x91, 0xa1, 0x08,
    0x23, 0x42, 0xb1, 0xc1, 0x15, 0x52, 0xd1, 0xf0, 0x24, 0x33, 0x62, 0x72,
    0x82, 0x09, 0x0a, 0x16, 0x17, 0x18, 0x19, 0x1a, 0x25, 0x26, 0x27, 0x28,
    0x29, 0x2a, 0x34, 0x35, 0x36, 0x37, 0x38, 0x39, 0x3a, 0x43, 0x44, 0x45,
    0x46, 0x47, 0x48, 0x49, 0x4a, 0x53, 0x54, 0x55, 0x56, 0x57, 0x58, 0x59,
    0x5a, 0x63, 0x64, 0x65, 0x66, 0x67, 0x68, 0x69, 0x6a, 0x73, 0x74, 0x75,
    0x76, 0x77, 0x78, 0x79, 0x7a, 0x83, 0x84, 0x85, 0x86, 0x87, 0x88, 0x89,
    0x8a, 0x92, 0x93, 0x94, 0x95, 0x96, 0x97, 0x98, 0x99, 0x9a, 0xa2, 0xa3,
    0xa4, 0xa5, 0xa6, 0xa7, 0xa8, 0xa9, 0xaa, 0xb2, 0xb3, 0xb4, 0xb5, 0xb6,
    0xb7, 0xb8, 0xb9, 0xba, 0xc2, 0xc3, 0xc4, 0xc5, 0xc6, 0xc7, 0xc8, 0xc9,
    0xca, 0xd2, 0xd3, 0xd4, 0xd5, 0xd6, 0xd7, 0xd8, 0xd9, 0xda, 0xe1, 0xe2,
    0xe3, 0xe4, 0xe5, 0xe6, 0xe7, 0xe8, 0xe9, 0xea, 0xf1, 0xf2, 0xf3, 0xf4,
    0xf5, 0xf6, 0xf7, 0xf8, 0xf9, 0xfa};
const uint8_t kAcChromBits[16] = {0, 2, 1, 2, 4, 4, 3, 4, 7, 5, 4, 4, 0, 1, 2, 0x77};
const uint8_t kAcChromVals[162] = {
    0x00, 0x01, 0x02, 0x03, 0x11, 0x04, 0x05, 0x21, 0x31, 0x06, 0x12, 0x41,
    0x51, 0x07, 0x61, 0x71, 0x13, 0x22, 0x32, 0x81, 0x08, 0x14, 0x42, 0x91,
    0xa1, 0xb1, 0xc1, 0x09, 0x23, 0x33, 0x52, 0xf0, 0x15, 0x62, 0x72, 0xd1,
    0x0a, 0x16, 0x24, 0x34, 0xe1, 0x25, 0xf1, 0x17, 0x18, 0x19, 0x1a, 0x26,
    0x27, 0x28, 0x29, 0x2a, 0x35, 0x36, 0x37, 0x38, 0x39, 0x3a, 0x43, 0x44,
    0x45, 0x46, 0x47, 0x48, 0x49, 0x4a, 0x53, 0x54, 0x55, 0x56, 0x57, 0x58,
    0x59, 0x5a, 0x63, 0x64, 0x65, 0x66, 0x67, 0x68, 0x69, 0x6a, 0x73, 0x74,
    0x75, 0x76, 0x77, 0x78, 0x79, 0x7a, 0x82, 0x83, 0x84, 0x85, 0x86, 0x87,
    0x88, 0x89, 0x8a, 0x92, 0x93, 0x94, 0x95, 0x96, 0x97, 0x98, 0x99, 0x9a,
    0xa2, 0xa3, 0xa4, 0xa5, 0xa6, 0xa7, 0xa8, 0xa9, 0xaa, 0xb2, 0xb3, 0xb4,
    0xb5, 0xb6, 0xb7, 0xb8, 0xb9, 0xba, 0xc2, 0xc3, 0xc4, 0xc5, 0xc6, 0xc7,
    0xc8, 0xc9, 0xca, 0xd2, 0xd3, 0xd4, 0xd5, 0xd6, 0xd7, 0xd8, 0xd9, 0xda,
    0xe2, 0xe3, 0xe4, 0xe5, 0xe6, 0xe7, 0xe8, 0xe9, 0xea, 0xf2, 0xf3, 0xf4,
    0xf5, 0xf6, 0xf7, 0xf8, 0xf9, 0xfa};

// IJG's jpeg_set_quality: the Annex K table scaled by jpeg_quality_scaling,
// rounded, clamped to 1..255 (force_baseline)
void scaled_table(const uint8_t* basic, int quality, uint16_t* out) {
  if (quality <= 0) quality = 1;
  if (quality > 100) quality = 100;
  const long scale = quality < 50 ? 5000 / quality : 200 - quality * 2;
  for (int k = 0; k < 64; ++k) {
    long t = (basic[k] * scale + 50L) / 100L;
    if (t <= 0) t = 1;
    if (t > 255) t = 255;
    out[k] = (uint16_t)t;
  }
}

struct HuffCodes {
  uint16_t code[256];
  uint8_t size[256];
};

void make_codes(const uint8_t* bits, const uint8_t* vals, HuffCodes* h) {
  memset(h->size, 0, sizeof(h->size));
  int code = 0, k = 0;
  for (int l = 1; l <= 16; ++l) {
    for (int i = 0; i < bits[l - 1]; ++i, ++k) {
      h->code[vals[k]] = (uint16_t)code++;
      h->size[vals[k]] = (uint8_t)l;
    }
    code <<= 1;
  }
}

struct ByteSink {
  std::vector<uint8_t> out;
  uint64_t acc = 0;
  int nbits = 0;

  void byte(int b) { out.push_back((uint8_t)b); }
  void word(int w) {
    byte(w >> 8);
    byte(w & 0xFF);
  }
  void put(uint32_t bits, int n) {  // n <= 16
    acc = (acc << n) | (bits & ((1u << n) - 1));
    nbits += n;
    while (nbits >= 8) {
      const int b = (int)((acc >> (nbits - 8)) & 0xFF);
      out.push_back((uint8_t)b);
      if (b == 0xFF) out.push_back(0);
      nbits -= 8;
    }
  }
  void flush() {  // pad the last byte with 1-bits
    if (nbits > 0) put((1u << (8 - nbits)) - 1, 8 - nbits);
  }
};

inline int category(int v) {
  v = v < 0 ? -v : v;
  int n = 0;
  while (v) {
    ++n;
    v >>= 1;
  }
  return n;
}

void encode_block(ByteSink& s, const int* q /*natural*/, int* dc_pred,
                  const HuffCodes& dc, const HuffCodes& ac) {
  const int diff = q[0] - *dc_pred;
  *dc_pred = q[0];
  int n = category(diff);
  s.put(dc.code[n], dc.size[n]);
  if (n) s.put((uint32_t)(diff < 0 ? diff - 1 : diff), n);
  int run = 0;
  for (int k = 1; k < 64; ++k) {
    const int v = q[kNatural[k]];
    if (v == 0) {
      ++run;
      continue;
    }
    while (run > 15) {
      s.put(ac.code[0xF0], ac.size[0xF0]);
      run -= 16;
    }
    n = category(v);
    const int rs = (run << 4) | n;
    s.put(ac.code[rs], ac.size[rs]);
    s.put((uint32_t)(v < 0 ? v - 1 : v), n);
    run = 0;
  }
  if (run) s.put(ac.code[0x00], ac.size[0x00]);
}

// forward DCT of one level-shifted block (F = B f B^T) and IJG rounding of
// F / Q to the nearest integer, half away from zero
void fdct_quantise(const float* px, int stride, const float* b,
                   const uint16_t* qtab, int* out) {
  float t[8][8];
  for (int y = 0; y < 8; ++y)
    for (int v = 0; v < 8; ++v) {
      float acc = 0.f;
      for (int x = 0; x < 8; ++x) acc += (px[y * stride + x] - 128.f) * b[v * 8 + x];
      t[y][v] = acc;
    }
  for (int u = 0; u < 8; ++u)
    for (int v = 0; v < 8; ++v) {
      float acc = 0.f;
      for (int y = 0; y < 8; ++y) acc += b[u * 8 + y] * t[y][v];
      long r = std::lround(acc / (float)qtab[u * 8 + v]);
      const long lim = (u == 0 && v == 0) ? 2047 : 1023;
      out[u * 8 + v] = (int)(r > lim ? lim : (r < -lim ? -lim : r));
    }
}

void write_dqt(ByteSink& s, int id, const uint16_t* q) {
  s.word(0xFFDB);
  s.word(67);
  s.byte(id);
  for (int k = 0; k < 64; ++k) s.byte(q[kNatural[k]]);
}

void write_dht(ByteSink& s, int cls, int id, const uint8_t* bits,
               const uint8_t* vals, int nvals) {
  s.word(0xFFC4);
  s.word(2 + 17 + nvals);
  s.byte((cls << 4) | id);
  for (int i = 0; i < 16; ++i) s.byte(bits[i]);
  for (int i = 0; i < nvals; ++i) s.byte(vals[i]);
}

}  // namespace

extern "C" {

struct VtImage {
  uint8_t* data;
  int height;
  int width;
  int channels;
};

void vt_free(void* p) { free(p); }

}  // extern "C"

namespace {

int coef_m(int coef_limit) {
  return (coef_limit > 0 && coef_limit < 8) ? coef_limit : 8;
}

// the geometry of a decoded stream, as vt_jpeg_coefficients reports it
void coef_geometry(const Decoder& d, int* ncomp, int* height, int* width,
                   int* blocks_h, int* blocks_w, int* samp_h, int* samp_v,
                   uint16_t* qtab) {
  *ncomp = d.ncomp;
  *height = d.height;
  *width = d.width;
  for (int ci = 0; ci < d.ncomp; ++ci) {
    const Component& c = d.comp[ci];
    blocks_h[ci] = c.bh;
    blocks_w[ci] = c.bw;
    samp_h[ci] = c.h;
    samp_v[ci] = c.v;
    memcpy(qtab + ci * 64, d.qt[c.tq], 64 * sizeof(uint16_t));
  }
}

// the top-left m x m of each block of component c, [bh][bw][m*m]
void copy_coefs(const Component& c, int m, int16_t* dst) {
  for (int by = 0; by < c.bh; ++by)
    for (int bx = 0; bx < c.bw; ++bx) {
      const int16_t* src = c.coef + ((size_t)by * c.bw_alloc + bx) * 64;
      int16_t* out = dst + ((size_t)by * c.bw + bx) * m * m;
      for (int u = 0; u < m; ++u) memcpy(out + u * m, src + u * 8, m * sizeof(int16_t));
    }
}

// the decoded image, (ceil(H*m/8), ceil(W*m/8), channels), into px
int decode_pixels(const Decoder& d, int m, uint8_t* px) {
  const int h = (int)(((long)d.height * m + 7) / 8);
  const int w = (int)(((long)d.width * m + 7) / 8);
  float b[64];
  idct_basis(m, b);
  size_t sizes[3] = {0, 0, 0}, total = 0;
  for (int ci = 0; ci < d.ncomp; ++ci) {
    sizes[ci] = (size_t)d.comp[ci].bh * m * d.comp[ci].bw * m;
    total += sizes[ci];
  }
  const int cpw = d.ncomp == 3
      ? (d.comp[1].bw > d.comp[2].bw ? d.comp[1].bw : d.comp[2].bw) * m : 0;
  try {
    scratch.planes.resize(total);
    scratch.rows.resize((size_t)cpw + 2 * (size_t)w);
  } catch (const std::bad_alloc&) {
    return kNoMemory;
  }
  float* planes[3] = {scratch.planes.data(), nullptr, nullptr};
  for (int ci = 1; ci < d.ncomp; ++ci) planes[ci] = planes[ci - 1] + sizes[ci - 1];
  for (int ci = 0; ci < d.ncomp; ++ci)
    plane_for(m, d.comp[ci], d.qt[d.comp[ci].tq], b, planes[ci]);
  const int ypw = d.comp[0].bw * m;
  if (d.ncomp == 1) {
    for (int i = 0; i < h; ++i)
      for (int j = 0; j < w; ++j) px[(size_t)i * w + j] = to_u8(planes[0][(size_t)i * ypw + j]);
    return kOk;
  }
  float* tmp = scratch.rows.data();
  float* cb = tmp + cpw;
  float* cr = cb + w;
  for (int i = 0; i < h; ++i) {
    const float* y = planes[0] + (size_t)i * ypw;
    float* rows[2] = {cb, cr};
    for (int k = 0; k < 2; ++k) {
      const Component& c = d.comp[k + 1];
      upsampled_row(planes[k + 1], c.bh * m, c.bw * m, d.vmax / c.v,
                    d.hmax / c.h, i, w, tmp, rows[k]);
    }
    uint8_t* o = px + (size_t)i * w * 3;
    for (int j = 0; j < w; ++j) {
      const float yy = y[j], u = cb[j] - 128.f, v = cr[j] - 128.f;
      o[3 * j] = to_u8(yy + 1.402f * v);
      o[3 * j + 1] = to_u8(yy - 0.344136f * u - 0.714136f * v);
      o[3 * j + 2] = to_u8(yy + 1.772f * u);
    }
  }
  return kOk;
}

int decode_stream(Decoder* d, const uint8_t* buf, size_t len, bool pixels) {
  d->data = buf;
  d->len = len;
  const int rc = d->run();
  if (rc != kOk) return rc;
  if (pixels && d->ncomp == 3 &&
      (d->comp[0].h != d->hmax || d->comp[0].v != d->vmax))
    return kSampling;  // chroma sampled finer than luma
  return kOk;
}

}  // namespace

extern "C" {

// coef_limit 1..7 keeps the top-left MxM coefficients of each block (layout
// [blocks_h, blocks_w, M*M]); 0 or 8 keeps all 64. The caller frees each
// coefs[ci] with vt_free.
int vt_jpeg_coefficients(const uint8_t* buf, size_t len, int coef_limit,
                         int* ncomp, int* height, int* width, int* blocks_h,
                         int* blocks_w, int* samp_h, int* samp_v,
                         uint16_t* qtab, int16_t** coefs) {
  Decoder d;
  const int rc = decode_stream(&d, buf, len, false);
  if (rc != kOk) return rc;
  const int m = coef_m(coef_limit);
  int16_t* out[3] = {nullptr, nullptr, nullptr};
  for (int ci = 0; ci < d.ncomp; ++ci) {
    const Component& c = d.comp[ci];
    out[ci] = static_cast<int16_t*>(
        malloc((size_t)c.bh * c.bw * m * m * sizeof(int16_t)));
    if (!out[ci]) {
      for (int i = 0; i < ci; ++i) free(out[i]);
      return kNoMemory;
    }
    copy_coefs(c, m, out[ci]);
  }
  coef_geometry(d, ncomp, height, width, blocks_h, blocks_w, samp_h, samp_v, qtab);
  for (int ci = 0; ci < d.ncomp; ++ci) coefs[ci] = out[ci];
  return kOk;
}

// The same, into the caller's buffers: out[ci] holds caps[ci] int16 values.
// Where a buffer is missing or short, returns kCapacity with the geometry
// filled in.
int vt_jpeg_coefficients_to(const uint8_t* buf, size_t len, int coef_limit,
                            int* ncomp, int* height, int* width, int* blocks_h,
                            int* blocks_w, int* samp_h, int* samp_v,
                            uint16_t* qtab, int16_t* const* out,
                            const size_t* caps) {
  Decoder d;
  const int rc = decode_stream(&d, buf, len, false);
  if (rc != kOk) return rc;
  const int m = coef_m(coef_limit);
  coef_geometry(d, ncomp, height, width, blocks_h, blocks_w, samp_h, samp_v, qtab);
  for (int ci = 0; ci < d.ncomp; ++ci)
    if (!out[ci] || caps[ci] < (size_t)d.comp[ci].bh * d.comp[ci].bw * m * m)
      return kCapacity;
  for (int ci = 0; ci < d.ncomp; ++ci) copy_coefs(d.comp[ci], m, out[ci]);
  return kOk;
}

// Decode to interleaved uint8, (ceil(H*M/8), ceil(W*M/8), C), C = 1 for a
// one-component stream and 3 (RGB) otherwise; M = coef_limit (1..7) or 8.
// The pixels are malloc'd; free them with vt_free.
int vt_decode_jpeg(const uint8_t* buf, size_t len, int coef_limit,
                   VtImage* out) {
  Decoder d;
  int rc = decode_stream(&d, buf, len, true);
  if (rc != kOk) return rc;
  const int m = coef_m(coef_limit);
  const int h = (int)(((long)d.height * m + 7) / 8);
  const int w = (int)(((long)d.width * m + 7) / 8);
  const int ch = d.ncomp == 1 ? 1 : 3;
  uint8_t* px = static_cast<uint8_t*>(malloc((size_t)h * w * ch));
  if (!px) return kNoMemory;
  rc = decode_pixels(d, m, px);
  if (rc != kOk) {
    free(px);
    return rc;
  }
  out->data = px;
  out->height = h;
  out->width = w;
  out->channels = ch;
  return kOk;
}

// The same, into the caller's `cap` bytes at `px`; where they are missing
// or too few, returns kCapacity with height, width and channels filled in.
int vt_decode_jpeg_to(const uint8_t* buf, size_t len, int coef_limit,
                      uint8_t* px, size_t cap, int* height, int* width,
                      int* channels) {
  Decoder d;
  const int rc = decode_stream(&d, buf, len, true);
  if (rc != kOk) return rc;
  const int m = coef_m(coef_limit);
  *height = (int)(((long)d.height * m + 7) / 8);
  *width = (int)(((long)d.width * m + 7) / 8);
  *channels = d.ncomp == 1 ? 1 : 3;
  if (!px || cap < (size_t)*height * *width * *channels) return kCapacity;
  return decode_pixels(d, m, px);
}

// rgb: (h, w, channels) uint8, channels 1 or 3. The stream is malloc'd;
// free it with vt_free.
int vt_encode_jpeg(const uint8_t* rgb, int h, int w, int channels, int quality,
                   uint8_t** out_buf, size_t* out_len) {
  if (channels != 1 && channels != 3) return kComponents;
  if (h <= 0 || w <= 0 || h > 65535 || w > 65535) return kCorrupt;
  const int f = channels == 3 ? 2 : 1;  // luma sampling factor
  const int mw = 8 * f * ((w + 8 * f - 1) / (8 * f));
  const int mh = 8 * f * ((h + 8 * f - 1) / (8 * f));
  // full-resolution planes padded to whole MCUs by repeating the last row
  // and column, as libjpeg's edge expansion does
  std::vector<float> planes[3];
  for (int c = 0; c < channels; ++c) planes[c].resize((size_t)mh * mw);
  for (int i = 0; i < mh; ++i) {
    const uint8_t* row = rgb + (size_t)(i < h ? i : h - 1) * w * channels;
    for (int j = 0; j < mw; ++j) {
      const uint8_t* p = row + (size_t)(j < w ? j : w - 1) * channels;
      const size_t at = (size_t)i * mw + j;
      if (channels == 1) {
        planes[0][at] = p[0];
        continue;
      }
      const float r = p[0], g = p[1], bl = p[2];
      planes[0][at] = 0.299f * r + 0.587f * g + 0.114f * bl;
      planes[1][at] = -0.168736f * r - 0.331264f * g + 0.5f * bl + 128.f;
      planes[2][at] = 0.5f * r - 0.418688f * g - 0.081312f * bl + 128.f;
    }
  }
  // 2x2 box average of the chroma planes
  const int cw = mw / f, chh = mh / f;
  for (int c = 1; c < channels; ++c) {
    std::vector<float> down((size_t)chh * cw);
    for (int i = 0; i < chh; ++i)
      for (int j = 0; j < cw; ++j) {
        const float* p = planes[c].data() + (size_t)2 * i * mw + 2 * j;
        down[(size_t)i * cw + j] = 0.25f * (p[0] + p[1] + p[mw] + p[mw + 1]);
      }
    planes[c].swap(down);
  }

  uint16_t qt[2][64];
  scaled_table(kStdLuminanceQ, quality, qt[0]);
  scaled_table(kStdChrominanceQ, quality, qt[1]);
  HuffCodes dc[2], ac[2];
  make_codes(kDcLumBits, kDcVals, &dc[0]);
  make_codes(kDcChromBits, kDcVals, &dc[1]);
  make_codes(kAcLumBits, kAcLumVals, &ac[0]);
  make_codes(kAcChromBits, kAcChromVals, &ac[1]);
  float b[64];
  idct_basis(8, b);

  ByteSink s;
  s.out.reserve((size_t)h * w / 2 + 1024);
  s.word(0xFFD8);
  // JFIF APP0: version 1.01, no units, 1:1 density, no thumbnail
  s.word(0xFFE0);
  s.word(16);
  const uint8_t jfif[14] = {'J', 'F', 'I', 'F', 0, 1, 1, 0, 0, 1, 0, 1, 0, 0};
  for (uint8_t c : jfif) s.byte(c);
  write_dqt(s, 0, qt[0]);
  if (channels == 3) write_dqt(s, 1, qt[1]);
  s.word(0xFFC0);
  s.word(8 + 3 * channels);
  s.byte(8);
  s.word(h);
  s.word(w);
  s.byte(channels);
  for (int c = 0; c < channels; ++c) {
    s.byte(c + 1);
    s.byte(c == 0 ? (f << 4) | f : 0x11);
    s.byte(c == 0 ? 0 : 1);
  }
  write_dht(s, 0, 0, kDcLumBits, kDcVals, 12);
  write_dht(s, 1, 0, kAcLumBits, kAcLumVals, 162);
  if (channels == 3) {
    write_dht(s, 0, 1, kDcChromBits, kDcVals, 12);
    write_dht(s, 1, 1, kAcChromBits, kAcChromVals, 162);
  }
  s.word(0xFFDA);
  s.word(6 + 2 * channels);
  s.byte(channels);
  for (int c = 0; c < channels; ++c) {
    s.byte(c + 1);
    s.byte(c == 0 ? 0x00 : 0x11);
  }
  s.byte(0);
  s.byte(63);
  s.byte(0);

  int pred[3] = {0, 0, 0};
  int q[64];
  const int mcus_x = mw / (8 * f), mcus_y = mh / (8 * f);
  for (int my = 0; my < mcus_y; ++my)
    for (int mx = 0; mx < mcus_x; ++mx) {
      for (int y = 0; y < f; ++y)
        for (int x = 0; x < f; ++x) {
          const float* px = planes[0].data() + (size_t)(my * f + y) * 8 * mw +
                            (size_t)(mx * f + x) * 8;
          fdct_quantise(px, mw, b, qt[0], q);
          encode_block(s, q, &pred[0], dc[0], ac[0]);
        }
      for (int c = 1; c < channels; ++c) {
        const float* px = planes[c].data() + (size_t)my * 8 * cw + (size_t)mx * 8;
        fdct_quantise(px, cw, b, qt[1], q);
        encode_block(s, q, &pred[c], dc[1], ac[1]);
      }
    }
  s.flush();
  s.word(0xFFD9);

  uint8_t* mem = static_cast<uint8_t*>(malloc(s.out.size()));
  if (!mem) return kNoMemory;
  memcpy(mem, s.out.data(), s.out.size());
  *out_buf = mem;
  *out_len = s.out.size();
  return kOk;
}

}  // extern "C"
