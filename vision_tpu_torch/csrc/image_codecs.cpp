// PNG and GIF codecs of the port, in plain C++17 with no library: the
// counterpart of the PNG and GIF half of vision_tpu/csrc/image_codecs.cpp,
// which links libpng for PNG. The machine with the card has no libpng,
// zlib headers or PIL, so the port carries its own; Python's zlib module
// inflates and deflates the IDAT data and checks the CRCs
// (vision_tpu_torch/io/_image_codecs.py), and this file does the rest.
//
// C ABI (bound with ctypes by vision_tpu_torch/io/_image_codecs.py):
//   vt_png_decode   the inflated IDAT data of one PNG -> interleaved
//                   pixels, as vision_tpu's vtpu_decode_png gives them
//                   through libpng's transforms: palettes and grey of 1, 2
//                   or 4 bits expanded to 8 bits, tRNS turned into an
//                   alpha channel, 16-bit samples stripped to their high
//                   byte (png_set_strip_16); or, with `wide`, uint16
//                   samples in host order (vtpu_decode_png16). Filter
//                   types 0-4 are undone, and Adam7 streams de-interlaced
//                   (vision_tpu's reader reads them without libpng's
//                   interlace handling, and so gives other pixels);
//   vt_png_indices  the samples of a palette PNG as they are, one byte a
//                   pixel: palette indices left unexpanded (a VOC class
//                   mask's classes, 255 its borders), or an 8-bit grey
//                   image's levels; what Pillow's "P" and "L" modes give.
//                   Private: the port's VOC masks read through it;
//   vt_png_filter   the rows of an 8-bit image, each prefixed by the
//                   filter that minimises the sum of its absolute bytes
//                   (libpng's default choice for 8-bit images that are not
//                   palette-coded), ready for deflate;
//   vt_decode_gif   every frame of a GIF87a / GIF89a stream composed on
//                   the logical screen (LZW, interlace, local and global
//                   colour tables, transparency, disposal methods 2 and
//                   3): the clean-room decoder of vision_tpu's
//                   vtpu_decode_gif, step for step;
//   vt_free         frees what vt_decode_gif allocated.
// Return codes: 0, -1 a corrupt or truncated stream, -2 out of memory,
// 7 the caller's buffer is too small. No read goes past a given length.
//
// Build: g++ -O2 -shared -fPIC -std=c++17 -ffp-contract=off image_codecs.cpp

#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <new>
#include <vector>

namespace {

enum Status { kOk = 0, kCorrupt = -1, kNoMemory = -2, kCapacity = 7 };

// ------------------------------------------------------------------- PNG

int png_channels(int color_type) {
  switch (color_type) {
    case 0: return 1;  // grey
    case 2: return 3;  // RGB
    case 3: return 1;  // palette index
    case 4: return 2;  // grey + alpha
    case 6: return 4;  // RGBA
    default: return 0;
  }
}

bool png_depth_ok(int color_type, int depth) {
  switch (color_type) {
    case 0: return depth == 1 || depth == 2 || depth == 4 || depth == 8 || depth == 16;
    case 3: return depth == 1 || depth == 2 || depth == 4 || depth == 8;
    case 2: case 4: case 6: return depth == 8 || depth == 16;
    default: return false;
  }
}

inline uint8_t paeth(int a, int b, int c) {
  const int p = a + b - c;
  const int pa = p > a ? p - a : a - p;
  const int pb = p > b ? p - b : b - p;
  const int pc = p > c ? p - c : c - p;
  if (pa <= pb && pa <= pc) return (uint8_t)a;
  return (uint8_t)(pb <= pc ? b : c);
}

// undo one row's filter in place; prev is the row above (zeros for the
// first row of a pass), bpp the bytes of one pixel (at least 1)
bool unfilter_row(int filter, uint8_t* row, const uint8_t* prev, size_t n,
                  int bpp) {
  switch (filter) {
    case 0:
      return true;
    case 1:
      for (size_t i = bpp; i < n; ++i) row[i] = (uint8_t)(row[i] + row[i - bpp]);
      return true;
    case 2:
      for (size_t i = 0; i < n; ++i) row[i] = (uint8_t)(row[i] + prev[i]);
      return true;
    case 3:
      for (size_t i = 0; i < n; ++i) {
        const int left = i >= (size_t)bpp ? row[i - bpp] : 0;
        row[i] = (uint8_t)(row[i] + ((left + prev[i]) >> 1));
      }
      return true;
    case 4:
      for (size_t i = 0; i < n; ++i) {
        const int left = i >= (size_t)bpp ? row[i - bpp] : 0;
        const int upleft = i >= (size_t)bpp ? prev[i - bpp] : 0;
        row[i] = (uint8_t)(row[i] + paeth(left, prev[i], upleft));
      }
      return true;
    default:
      return false;
  }
}

// sample x of a row of `depth`-bit samples, most significant bits first
inline int sample(const uint8_t* row, size_t x, int depth) {
  switch (depth) {
    case 8: return row[x];
    case 16: return (row[2 * x] << 8) | row[2 * x + 1];
    default: {
      const size_t bit = x * depth;
      const int shift = 8 - depth - (int)(bit & 7);
      return (row[bit >> 3] >> shift) & ((1 << depth) - 1);
    }
  }
}

// Adam7: the first row and column of each pass, and their steps
const int kAdamY0[7] = {0, 0, 4, 0, 2, 0, 1};
const int kAdamX0[7] = {0, 4, 0, 2, 0, 1, 0};
const int kAdamDy[7] = {8, 8, 8, 4, 4, 2, 2};
const int kAdamDx[7] = {8, 8, 4, 4, 2, 2, 1};

// The raw samples of the image, [h][w][cin] (palette indices as they are),
// from the inflated data: every pass unfiltered and put in its place.
int png_samples(const uint8_t* raw, size_t raw_len, int w, int h, int depth,
                int cin, bool interlaced, std::vector<uint16_t>& out) {
  try {
    out.assign((size_t)w * h * cin, 0);
  } catch (const std::bad_alloc&) {
    return kNoMemory;
  }
  const int bpp = (cin * depth + 7) / 8;
  size_t at = 0;
  std::vector<uint8_t> rows;
  for (int p = 0; p < (interlaced ? 7 : 1); ++p) {
    const int y0 = interlaced ? kAdamY0[p] : 0, dy = interlaced ? kAdamDy[p] : 1;
    const int x0 = interlaced ? kAdamX0[p] : 0, dx = interlaced ? kAdamDx[p] : 1;
    const int pw = w > x0 ? (w - x0 + dx - 1) / dx : 0;
    const int ph = h > y0 ? (h - y0 + dy - 1) / dy : 0;
    if (pw == 0 || ph == 0) continue;  // an empty pass has no rows at all
    const size_t n = ((size_t)pw * cin * depth + 7) / 8;
    try {
      rows.assign(2 * n, 0);
    } catch (const std::bad_alloc&) {
      return kNoMemory;
    }
    uint8_t* prev = rows.data();
    uint8_t* cur = prev + n;
    for (int r = 0; r < ph; ++r) {
      if (at + 1 + n > raw_len) return kCorrupt;
      const int filter = raw[at];
      memcpy(cur, raw + at + 1, n);
      at += 1 + n;
      if (!unfilter_row(filter, cur, prev, n, bpp)) return kCorrupt;
      uint16_t* dst = out.data() + ((size_t)(y0 + r * dy) * w) * cin;
      for (int x = 0; x < pw; ++x) {
        uint16_t* px = dst + (size_t)(x0 + x * dx) * cin;
        for (int c = 0; c < cin; ++c)
          px[c] = (uint16_t)sample(cur, (size_t)x * cin + c, depth);
      }
      uint8_t* t = prev;
      prev = cur;
      cur = t;
    }
  }
  return kOk;
}

// ------------------------------------------------------------------- GIF

struct Reader {
  const uint8_t* p;
  size_t len;
  size_t pos = 0;
  bool ok = true;
  uint8_t u8() {
    if (pos >= len) {
      ok = false;
      return 0;
    }
    return p[pos++];
  }
  uint16_t u16() {  // little-endian
    const uint16_t lo = u8(), hi = u8();
    return (uint16_t)(lo | (hi << 8));
  }
  bool skip(size_t n) {
    if (pos + n > len) {
      ok = false;
      return false;
    }
    pos += n;
    return true;
  }
  // the rest of a run of data sub-blocks, up to its terminator or the end
  // of the data; false where a sub-block is cut short
  bool drain(int block_left) {
    for (;;) {
      if (block_left > 0 && !skip(block_left)) return false;
      block_left = u8();
      if (!ok || block_left == 0) return true;
    }
  }
};

// LZW over GIF data sub-blocks -> index stream (at most n_out indices)
bool lzw_decode(Reader& r, int min_code_size, uint8_t* out, size_t n_out) {
  if (min_code_size < 2 || min_code_size > 11) return false;
  const int clear_code = 1 << min_code_size;
  const int end_code = clear_code + 1;
  constexpr int kMax = 4096;
  std::vector<uint16_t> prefix(kMax);
  std::vector<uint8_t> suffix(kMax), stack(kMax);
  int code_size = min_code_size + 1;
  int next_code = end_code + 1;
  int prev = -1;
  uint32_t bits = 0;
  int n_bits = 0;
  int block_left = 0;
  size_t written = 0;

  auto first_char = [&](int code) {
    while (code >= clear_code) code = prefix[code];
    return (uint8_t)code;
  };

  for (;;) {
    while (n_bits < code_size) {
      if (block_left == 0) {
        block_left = r.u8();
        if (!r.ok) return false;
        if (block_left == 0) return written == n_out;  // terminator
      }
      bits |= (uint32_t)r.u8() << n_bits;
      if (!r.ok) return false;
      n_bits += 8;
      --block_left;
    }
    const int code = (int)(bits & ((1u << code_size) - 1));
    bits >>= code_size;
    n_bits -= code_size;

    if (code == clear_code) {
      code_size = min_code_size + 1;
      next_code = end_code + 1;
      prev = -1;
      continue;
    }
    if (code == end_code) return r.drain(block_left) && written == n_out;
    if (prev < 0) {
      if (code >= clear_code) return false;
      if (written < n_out) out[written++] = (uint8_t)code;
      prev = code;
      continue;
    }
    int sp = 0;
    int cur = code;
    if (code >= next_code) {  // KwKwK: the previous string and its first byte
      if (code != next_code) return false;
      stack[sp++] = first_char(prev);
      cur = prev;
    }
    while (cur >= clear_code) {
      if (sp >= kMax) return false;
      stack[sp++] = suffix[cur];
      cur = prefix[cur];
    }
    stack[sp++] = (uint8_t)cur;
    if (next_code < kMax) {
      prefix[next_code] = (uint16_t)prev;
      suffix[next_code] = stack[sp - 1];  // the first byte of this string
      ++next_code;
      if (next_code == (1 << code_size) && code_size < 12) ++code_size;
    }
    while (sp > 0 && written < n_out) out[written++] = stack[--sp];
    if (written == n_out) return r.drain(block_left);
    prev = code;
  }
}

}  // namespace

extern "C" {

void vt_free(void* p) { free(p); }

// raw: the inflated IDAT data; plte: plte_n RGB entries (palette images);
// trns: the tRNS chunk's trns_len bytes, or none. out: cap bytes of h * w *
// channels samples, uint8, or uint16 with `wide` (16-bit images only);
// channels is written where the call succeeds or the buffer is short.
int vt_png_decode(const uint8_t* raw, size_t raw_len, int w, int h, int depth,
                  int color_type, int interlace, const uint8_t* plte,
                  int plte_n, const uint8_t* trns, int trns_len, int wide,
                  void* out, size_t cap, int* channels) {
  const int cin = png_channels(color_type);
  if (!cin || !png_depth_ok(color_type, depth) || w <= 0 || h <= 0 ||
      interlace < 0 || interlace > 1)
    return kCorrupt;
  if (wide && depth != 16) return kCorrupt;
  if (color_type == 3 && (plte_n < 1 || plte_n > 256)) return kCorrupt;
  // a tRNS chunk that libpng would discard (alpha images, a wrong length)
  bool has_trns = false;
  if (trns && trns_len > 0) {
    if (color_type == 0) has_trns = trns_len == 2;
    if (color_type == 2) has_trns = trns_len == 6;
    if (color_type == 3) has_trns = trns_len <= plte_n;
  }
  const int cout = (color_type == 3 ? 3 : cin) + (has_trns ? 1 : 0);
  *channels = cout;
  const size_t n = (size_t)w * h;
  if (!out || cap < n * cout * (wide ? 2 : 1)) return kCapacity;

  thread_local std::vector<uint16_t> samples;
  const int rc = png_samples(raw, raw_len, w, h, depth, cin, interlace == 1, samples);
  if (rc != kOk) return rc;
  const int mask = depth == 16 ? 0xFFFF : (1 << depth) - 1;
  int key[3] = {0, 0, 0};  // the tRNS colour, masked as libpng masks it
  if (has_trns && color_type != 3)
    for (int c = 0; c < cin; ++c) key[c] = ((trns[2 * c] << 8) | trns[2 * c + 1]) & mask;

  if (wide) {  // 16-bit grey or RGB (+ tRNS alpha), grey + alpha, RGBA
    uint16_t* o = static_cast<uint16_t*>(out);
    for (size_t i = 0; i < n; ++i) {
      const uint16_t* s = samples.data() + i * cin;
      bool match = has_trns;
      for (int c = 0; c < cin; ++c) {
        *o++ = s[c];
        match = match && s[c] == key[c];
      }
      if (has_trns) *o++ = match ? 0 : 0xFFFF;
    }
    return kOk;
  }
  uint8_t* o = static_cast<uint8_t*>(out);
  if (color_type == 3) {
    for (size_t i = 0; i < n; ++i) {
      const int idx = samples[i];
      // libpng pads the palette to 256 black entries
      for (int c = 0; c < 3; ++c) *o++ = idx < plte_n ? plte[3 * idx + c] : 0;
      if (has_trns) *o++ = idx < trns_len ? trns[idx] : 255;
    }
    return kOk;
  }
  // grey of 1, 2, 4 bits scaled to 8 (png_set_expand_gray_1_2_4_to_8);
  // 16 bits keep their high byte
  const int scale = depth < 8 ? 255 / mask : 1;
  for (size_t i = 0; i < n; ++i) {
    const uint16_t* s = samples.data() + i * cin;
    bool match = has_trns;
    for (int c = 0; c < cin; ++c) {
      *o++ = (uint8_t)(depth == 16 ? s[c] >> 8 : s[c] * scale);
      match = match && s[c] == key[c];
    }
    if (has_trns) *o++ = match ? 0 : 255;
  }
  return kOk;
}

// raw: the inflated IDAT data of a palette (colour type 3, any depth) or
// 8-bit grey (colour type 0) image; out: cap bytes of h * w samples
int vt_png_indices(const uint8_t* raw, size_t raw_len, int w, int h, int depth,
                   int color_type, int interlace, uint8_t* out, size_t cap) {
  if (w <= 0 || h <= 0 || interlace < 0 || interlace > 1) return kCorrupt;
  if (!(color_type == 3 && png_depth_ok(3, depth)) &&
      !(color_type == 0 && depth == 8))
    return kCorrupt;
  const size_t n = (size_t)w * h;
  if (!out || cap < n) return kCapacity;
  thread_local std::vector<uint16_t> samples;
  const int rc = png_samples(raw, raw_len, w, h, depth, 1, interlace == 1, samples);
  if (rc != kOk) return rc;
  for (size_t i = 0; i < n; ++i) out[i] = (uint8_t)samples[i];
  return kOk;
}

// img: h rows of w * channels bytes; out: h * (1 + w * channels) bytes,
// each row led by its filter type
int vt_png_filter(const uint8_t* img, int h, int w, int channels, uint8_t* out,
                  size_t cap) {
  if (h <= 0 || w <= 0 || channels < 1 || channels > 4) return kCorrupt;
  const size_t n = (size_t)w * channels;
  if (!out || cap < (size_t)h * (n + 1)) return kCapacity;
  std::vector<uint8_t> zeros(n, 0), trial(n);
  for (int y = 0; y < h; ++y) {
    const uint8_t* row = img + (size_t)y * n;
    const uint8_t* prev = y ? row - n : zeros.data();
    uint8_t* dst = out + (size_t)y * (n + 1);
    long best = -1;
    for (int f = 0; f < 5; ++f) {
      long sum = 0;
      for (size_t i = 0; i < n; ++i) {
        const int left = i >= (size_t)channels ? row[i - channels] : 0;
        const int upleft = i >= (size_t)channels ? prev[i - channels] : 0;
        int pred = 0;
        switch (f) {
          case 1: pred = left; break;
          case 2: pred = prev[i]; break;
          case 3: pred = (left + prev[i]) >> 1; break;
          case 4: pred = paeth(left, prev[i], upleft); break;
          default: break;
        }
        trial[i] = (uint8_t)(row[i] - pred);
        sum += trial[i] < 128 ? trial[i] : 256 - trial[i];
      }
      if (best < 0 || sum < best) {
        best = sum;
        dst[0] = (uint8_t)f;
        memcpy(dst + 1, trial.data(), n);
      }
    }
  }
  return kOk;
}

// Every frame composed on the logical screen: *out_frames = malloc'd
// (n * h * w * 3) RGB; free it with vt_free.
int vt_decode_gif(const uint8_t* buf, size_t len, uint8_t** out_frames,
                  int* out_n, int* out_h, int* out_w) {
  Reader r{buf, len};
  if (len < 13 || memcmp(buf, "GIF8", 4) != 0) return kCorrupt;
  r.pos = 6;
  const int sw = r.u16(), sh = r.u16();
  const uint8_t packed = r.u8();
  const uint8_t bg_index = r.u8();
  r.u8();  // aspect
  if (!r.ok || sw <= 0 || sh <= 0) return kCorrupt;

  uint8_t gct[256][3];
  const bool has_gct = (packed & 0x80) != 0;
  const int gct_size = 2 << (packed & 0x07);
  if (has_gct)
    for (int i = 0; i < gct_size; ++i)
      for (int c = 0; c < 3; ++c) gct[i][c] = r.u8();
  if (!r.ok) return kCorrupt;
  // the background: the global table's entry, else black
  const uint8_t* bg = (has_gct && bg_index < gct_size) ? gct[bg_index] : nullptr;

  const size_t canvas_px = (size_t)sw * sh;
  std::vector<uint8_t> canvas, saved, fidx;
  try {
    canvas.resize(canvas_px * 3);
    saved.resize(canvas_px * 3);
  } catch (const std::bad_alloc&) {
    return kNoMemory;
  }
  for (size_t i = 0; i < canvas_px; ++i)
    for (int c = 0; c < 3; ++c) canvas[i * 3 + c] = bg ? bg[c] : 0;

  uint8_t* frames = nullptr;
  size_t frames_cap = 0;
  int n_frames = 0;
  int transparent = -1;
  int disposal = 0;
  int rc = kCorrupt;

  while (r.ok) {
    const uint8_t block = r.u8();
    if (!r.ok) break;
    if (block == 0x3B) {  // trailer
      rc = n_frames > 0 ? kOk : kCorrupt;
      break;
    }
    if (block == 0x21) {  // extension
      const uint8_t label = r.u8();
      if (label == 0xF9) {  // graphic control
        const uint8_t size = r.u8();
        if (size >= 4) {
          const uint8_t flags = r.u8();
          r.u16();  // delay
          const uint8_t tindex = r.u8();
          disposal = (flags >> 2) & 0x07;
          transparent = (flags & 1) ? tindex : -1;
          if (size > 4) r.skip(size - 4);
        } else {
          r.skip(size);
        }
      }
      // the remaining sub-blocks (the whole body of other labels)
      while (r.ok) {
        const uint8_t n = r.u8();
        if (n == 0) break;
        r.skip(n);
      }
      continue;
    }
    if (block != 0x2C) break;  // an unknown block ends the stream

    const int left = r.u16(), top = r.u16();
    const int fw = r.u16(), fh = r.u16();
    const uint8_t fpacked = r.u8();
    if (!r.ok || fw <= 0 || fh <= 0 || left + fw > sw || top + fh > sh) break;
    uint8_t lct[256][3];
    const bool has_lct = (fpacked & 0x80) != 0;
    const bool interlaced = (fpacked & 0x40) != 0;
    const int lct_size = 2 << (fpacked & 0x07);
    if (has_lct)
      for (int i = 0; i < lct_size; ++i)
        for (int c = 0; c < 3; ++c) lct[i][c] = r.u8();
    const uint8_t(*table)[3] = has_lct ? lct : gct;
    const int table_size = has_lct ? lct_size : gct_size;
    if (!has_lct && !has_gct) break;  // no palette at all

    const int min_code = r.u8();
    if (!r.ok) break;
    try {
      fidx.assign((size_t)fw * fh, 0);
    } catch (const std::bad_alloc&) {
      rc = kNoMemory;
      break;
    }
    if (!lzw_decode(r, min_code, fidx.data(), fidx.size())) break;

    if (disposal == 3) saved = canvas;

    // draw, de-interlacing: rows 0, 4, 2, 1 mod 8, 8, 4, 2
    static const int i0[4] = {0, 4, 2, 1};
    static const int istep[4] = {8, 8, 4, 2};
    int src_row = 0;
    for (int pass = interlaced ? 0 : 3; pass < 4; ++pass) {
      const int start = interlaced ? i0[pass] : 0;
      const int step = interlaced ? istep[pass] : 1;
      for (int y = start; y < fh; y += step, ++src_row) {
        const uint8_t* srow = fidx.data() + (size_t)src_row * fw;
        uint8_t* drow = canvas.data() + ((size_t)(top + y) * sw + left) * 3;
        for (int x = 0; x < fw; ++x) {
          const int idx = srow[x];
          if (idx == transparent || idx >= table_size) continue;
          for (int c = 0; c < 3; ++c) drow[x * 3 + c] = table[idx][c];
        }
      }
      if (!interlaced) break;
    }

    const size_t fbytes = canvas_px * 3;
    if ((size_t)(n_frames + 1) * fbytes > frames_cap) {
      size_t ncap = frames_cap ? frames_cap * 2 : fbytes * 4;
      while (ncap < (size_t)(n_frames + 1) * fbytes) ncap *= 2;
      uint8_t* grown = static_cast<uint8_t*>(realloc(frames, ncap));
      if (!grown) {
        rc = kNoMemory;
        break;
      }
      frames = grown;
      frames_cap = ncap;
    }
    memcpy(frames + (size_t)n_frames * fbytes, canvas.data(), fbytes);
    ++n_frames;

    // disposal before the next frame: 2 restores the frame's rectangle to
    // the background, 3 the canvas as it was before this frame
    if (disposal == 2) {
      for (int y = 0; y < fh; ++y) {
        uint8_t* drow = canvas.data() + ((size_t)(top + y) * sw + left) * 3;
        for (int x = 0; x < fw; ++x)
          for (int c = 0; c < 3; ++c) drow[x * 3 + c] = bg ? bg[c] : 0;
      }
    } else if (disposal == 3) {
      canvas = saved;
    }
    disposal = 0;
    transparent = -1;
    rc = kOk;  // at least one frame; the trailer may still follow
  }

  if (rc != kOk || n_frames == 0) {
    free(frames);
    return rc == kNoMemory ? kNoMemory : kCorrupt;
  }
  *out_frames = frames;
  *out_n = n_frames;
  *out_h = sh;
  *out_w = sw;
  return kOk;
}

}  // extern "C"
