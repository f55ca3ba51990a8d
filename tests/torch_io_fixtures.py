"""The image fixtures of the port's IO tests and of ``chip_smoke.py``'s
``image_io`` phase, and the hand-built PNG streams the tests use.

    python tests/torch_io_fixtures.py    # rewrites tests/torch_io_data/

Made with Pillow and checked with ``vision_tpu``'s decoders (libjpeg,
libpng, its GIF decoder), which the machine with the card does not have:
so the files are committed, and ``manifest.json`` keeps, for each, its
shape and the SHA-256 digests of what those decoders give:

* PNG and GIF: the pixels of ``vision_tpu``'s decode (libpng, its GIF
  decoder), which the port must give bit for bit; the Adam7 fixture's of
  Pillow's decode, which equals the source array (``vision_tpu``'s reader
  de-interlaces it wrongly, ``ROADMAP.md``);
* JPEG: libjpeg's quantised coefficients (``jpeg_read_coefficients``
  through ``vision_tpu``), which the port must give bit for bit; and the
  pixels of the port's own host decode, whose float IDCT lies up to a few
  levels from libjpeg's integer one (the largest and mean differences
  from libjpeg's, or from Pillow's for CMYK, are recorded beside them);
* WebP: the pixels of ``vision_tpu``'s ``decode_webp`` (libwebp's
  ``WebPDecodeRGBA``; Pillow for the animation), which the port must give
  bit for bit.

Every stream is ImageNet-sized (500x375) but the PNGs, the GIF, the
sampling-factor JPEGs and most WebPs. Pillow's WebP writer has no knob for
segments, the filter, token partitions or the alpha filter, and Pillow
writes no JPEG with sampling factors of 3 or 4: two helpers, compiled here
against the machine's libwebp and libjpeg (``WEBP_HELPER``,
``JPEG_HELPER``), write those; the ALPH chunks with each filter and the
extended and animated files are assembled from their chunks.
"""

from __future__ import annotations

import hashlib
import io
import json
import struct
import tempfile
import zlib
from pathlib import Path

import numpy as np

DATA = Path(__file__).resolve().parent / "torch_io_data"
SIZE = (375, 500)  # H, W: an ImageNet photograph's

PROGRESSIVE = {  # name -> Pillow's save arguments
    "prog_420.jpg": dict(quality=75, subsampling=2),
    "prog_444.jpg": dict(quality=75, subsampling=0),
    "prog_grey.jpg": dict(quality=75, grey=True),
    "prog_restart.jpg": dict(quality=75, subsampling=2, restart_marker_rows=1),
    "prog_optimize.jpg": dict(quality=85, subsampling=1, optimize=True),
}
PNGS = ("rgb.png", "rgba.png", "grey_alpha.png", "palette_trns.png",
        "bit1.png", "grey16.png", "rgb16.png", "adam7.png")


def photo(h: int, w: int, seed: int, channels: int = 3) -> np.ndarray:
    """A photograph-like HWC uint8 image: smooth structure and a little
    noise."""
    rng = np.random.RandomState(seed)
    yy, xx = np.meshgrid(np.arange(h), np.arange(w), indexing="ij")
    base = (128 + 70 * np.sin(xx / (15.0 + seed % 5)) * np.cos(yy / (21.0 + seed % 3))
            + 30 * np.sin((xx + yy) / 41.0))
    shift = np.linspace(-25, 25, channels)
    img = base[..., None] + shift + rng.randn(h, w, channels) * 5
    return np.clip(img, 0, 255).astype(np.uint8)


def sha256(arr) -> str:
    return hashlib.sha256(np.ascontiguousarray(arr).tobytes()).hexdigest()


def coef_digest(coefs) -> str:
    """One digest of a stream's coefficient arrays, in component order."""
    h = hashlib.sha256()
    for c in coefs:
        h.update(np.ascontiguousarray(c, dtype=np.int16).tobytes())
    return h.hexdigest()


# ------------------------------------------------------ hand-built PNGs

def _chunk(ctype: bytes, payload: bytes) -> bytes:
    return (struct.pack(">I", len(payload)) + ctype + payload
            + struct.pack(">I", zlib.crc32(ctype + payload)))


def _paeth(a, b, c):
    p = a + b - c
    pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
    return np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))


def _filter(row: np.ndarray, prev: np.ndarray, f: int, bpp: int) -> np.ndarray:
    row = row.astype(np.int32)
    prev = prev.astype(np.int32)
    left = np.concatenate([np.zeros(bpp, np.int32), row[:-bpp]])
    upleft = np.concatenate([np.zeros(bpp, np.int32), prev[:-bpp]])
    pred = [0, left, prev, (left + prev) >> 1, _paeth(left, prev, upleft)][f]
    return ((row - pred) & 0xFF).astype(np.uint8)


def _pack(samples: np.ndarray, depth: int) -> np.ndarray:
    """A row of samples as the PNG's bytes: big-endian 16-bit, or bits
    packed most significant first."""
    if depth == 16:
        return samples.astype(">u2").view(np.uint8)
    if depth == 8:
        return samples.astype(np.uint8)
    per = 8 // depth
    s = np.concatenate([samples, np.zeros(-len(samples) % per, samples.dtype)])
    s = s.reshape(-1, per).astype(np.int32)
    shifts = 8 - depth * (np.arange(per) + 1)
    return (s << shifts).sum(1).astype(np.uint8)


ADAM7 = ((0, 0, 8, 8), (0, 4, 8, 8), (4, 0, 8, 4), (0, 2, 4, 4), (2, 0, 4, 2),
         (0, 1, 2, 2), (1, 0, 2, 1))  # (y0, x0, dy, dx)


def png_stream(samples: np.ndarray, color_type: int, depth: int = 8,
               filters=(0,), interlace: bool = False, plte: bytes = None,
               trns: bytes = None, level: int = 6) -> bytes:
    """A PNG of ``samples`` (``(H, W, C)`` raw sample values: palette
    indices, grey, RGB ...), every row filtered by the next type of
    ``filters`` in turn, Adam7-interlaced with ``interlace``."""
    h, w, c = samples.shape
    bpp = max(1, c * depth // 8)
    out, k = [], 0
    passes = ADAM7 if interlace else ((0, 0, 1, 1),)
    for y0, x0, dy, dx in passes:
        sub = samples[y0::dy, x0::dx]
        if sub.size == 0:
            continue
        prev = np.zeros(len(_pack(sub[0].reshape(-1), depth)), np.uint8)
        for row in sub:
            raw = _pack(row.reshape(-1), depth)
            f = filters[k % len(filters)]
            k += 1
            out.append(bytes([f]) + _filter(raw, prev, f, bpp).tobytes())
            prev = raw
    ihdr = struct.pack(">IIBBBBB", w, h, depth, color_type, 0, 0, int(interlace))
    body = _chunk(b"IHDR", ihdr)
    if plte is not None:
        body += _chunk(b"PLTE", plte)
    if trns is not None:
        body += _chunk(b"tRNS", trns)
    return (b"\x89PNG\r\n\x1a\n" + body
            + _chunk(b"IDAT", zlib.compress(b"".join(out), level))
            + _chunk(b"IEND", b""))


def exif_app1(orientation: int) -> bytes:
    """An APP1 Exif segment (big-endian TIFF) holding one orientation tag."""
    tiff = (b"MM\x00\x2a" + struct.pack(">I", 8) + struct.pack(">H", 1)
            + struct.pack(">HHIHH", 0x0112, 3, 1, orientation, 0)
            + struct.pack(">I", 0))
    payload = b"Exif\x00\x00" + tiff
    return b"\xff\xe1" + struct.pack(">H", len(payload) + 2) + payload


# ------------------------------------------------ the encoder helpers

WEBP_HELPER = r"""
#include <stdio.h>
#include <stdlib.h>
#include <string.h>
#include <webp/encode.h>
/* webp_helper in.rgba w h out.webp key=value ...: one WebPEncode with the
   WebPConfig fields named on the command line */
int main(int argc, char** argv) {
  int w = atoi(argv[2]), h = atoi(argv[3]);
  FILE* f = fopen(argv[1], "rb");
  unsigned char* rgba = malloc((size_t)w * h * 4);
  if (fread(rgba, 1, (size_t)w * h * 4, f) != (size_t)w * h * 4) return 2;
  fclose(f);
  WebPConfig config;
  if (!WebPConfigInit(&config)) return 3;
  for (int i = 5; i < argc; ++i) {
    char key[64]; double v;
    if (sscanf(argv[i], "%63[^=]=%lf", key, &v) != 2) return 4;
#define SET(name) if (!strcmp(key, #name)) config.name = v; else
    SET(lossless) SET(quality) SET(method) SET(segments) SET(sns_strength)
    SET(filter_strength) SET(filter_sharpness) SET(filter_type) SET(autofilter)
    SET(alpha_compression) SET(alpha_filtering) SET(alpha_quality)
    SET(partitions) SET(exact) SET(preprocessing) return 5;
  }
  if (!WebPValidateConfig(&config)) return 6;
  WebPPicture pic;
  WebPPictureInit(&pic);
  pic.width = w; pic.height = h; pic.use_argb = 1;
  if (!WebPPictureImportRGBA(&pic, rgba, w * 4)) return 7;
  WebPMemoryWriter wr;
  WebPMemoryWriterInit(&wr);
  pic.writer = WebPMemoryWrite; pic.custom_ptr = &wr;
  if (!WebPEncode(&config, &pic)) return 8;
  f = fopen(argv[4], "wb");
  fwrite(wr.mem, 1, wr.size, f);
  fclose(f);
  return 0;
}
"""

JPEG_HELPER = r"""
#include <stdio.h>
#include <stdlib.h>
#include <jpeglib.h>
/* jpeg_helper planes.raw w h ncomp quality single_scans out.jpg h0 v0 h1 v1 ..:
   a baseline JPEG from raw (already downsampled) planes, each stored
   MCU-padded, [rows = mcus_y * v * 8][cols = mcus_x * h * 8]; with
   single_scans every component in a scan of its own */
int main(int argc, char** argv) {
  int w = atoi(argv[2]), h = atoi(argv[3]), nc = atoi(argv[4]);
  int quality = atoi(argv[5]), single = atoi(argv[6]);
  int hs[4], vs[4], hmax = 1, vmax = 1;
  for (int c = 0; c < nc; ++c) {
    hs[c] = atoi(argv[8 + 2 * c]); vs[c] = atoi(argv[9 + 2 * c]);
    if (hs[c] > hmax) hmax = hs[c];
    if (vs[c] > vmax) vmax = vs[c];
  }
  int mcux = (w + 8 * hmax - 1) / (8 * hmax), mcuy = (h + 8 * vmax - 1) / (8 * vmax);
  size_t sizes[4], total = 0;
  for (int c = 0; c < nc; ++c) {
    sizes[c] = (size_t)mcuy * vs[c] * 8 * mcux * hs[c] * 8;
    total += sizes[c];
  }
  unsigned char* raw = malloc(total);
  FILE* f = fopen(argv[1], "rb");
  if (fread(raw, 1, total, f) != total) return 2;
  fclose(f);
  struct jpeg_compress_struct ci;
  struct jpeg_error_mgr err;
  ci.err = jpeg_std_error(&err);
  jpeg_create_compress(&ci);
  FILE* out = fopen(argv[7], "wb");
  jpeg_stdio_dest(&ci, out);
  ci.image_width = w; ci.image_height = h; ci.input_components = nc;
  ci.in_color_space = nc == 1 ? JCS_GRAYSCALE : JCS_YCbCr;
  jpeg_set_defaults(&ci);
  jpeg_set_colorspace(&ci, nc == 1 ? JCS_GRAYSCALE : JCS_YCbCr);
  jpeg_set_quality(&ci, quality, TRUE);
  for (int c = 0; c < nc; ++c) {
    ci.comp_info[c].h_samp_factor = hs[c];
    ci.comp_info[c].v_samp_factor = vs[c];
  }
  ci.raw_data_in = TRUE;
  jpeg_scan_info scans[4];
  if (single && nc > 1) {
    for (int c = 0; c < nc; ++c) {
      scans[c].comps_in_scan = 1; scans[c].component_index[0] = c;
      scans[c].Ss = 0; scans[c].Se = 63; scans[c].Ah = 0; scans[c].Al = 0;
    }
    ci.scan_info = scans; ci.num_scans = nc;
  }
  jpeg_start_compress(&ci, TRUE);
  JSAMPROW rows[4][32];
  JSAMPARRAY planes[4];
  unsigned char* base[4];
  size_t off = 0;
  for (int c = 0; c < nc; ++c) { base[c] = raw + off; off += sizes[c]; planes[c] = rows[c]; }
  for (int my = 0; my < mcuy; ++my) {
    for (int c = 0; c < nc; ++c)
      for (int r = 0; r < vs[c] * 8; ++r)
        rows[c][r] = base[c] + ((size_t)my * vs[c] * 8 + r) * mcux * hs[c] * 8;
    jpeg_write_raw_data(&ci, planes, vmax * 8);
  }
  jpeg_finish_compress(&ci);
  fclose(out);
  return 0;
}
"""


def build_helper(source: str, name: str, lib: str, workdir: Path) -> Path:
    """Compile a helper against the machine's codec library."""
    import subprocess

    src = workdir / f"{name}.c"
    src.write_text(source)
    exe = workdir / name
    subprocess.run(["gcc", "-O1", "-std=c99", "-o", str(exe), str(src), lib],
                   check=True)
    return exe


def webp_encode(helper: Path, rgba: np.ndarray, workdir: Path, **config) -> bytes:
    """One WebP of an ``(H, W, 4)`` uint8 image with the given WebPConfig
    fields."""
    import subprocess

    h, w, _ = rgba.shape
    src, dst = workdir / "in.rgba", workdir / "out.webp"
    src.write_bytes(np.ascontiguousarray(rgba, np.uint8).tobytes())
    args = [f"{k}={v}" for k, v in config.items()]
    subprocess.run([str(helper), str(src), str(w), str(h), str(dst), *args], check=True)
    return dst.read_bytes()


def _pad_plane(plane: np.ndarray, rows: int, cols: int) -> np.ndarray:
    """Edge-replicate a plane out to ``rows`` x ``cols``."""
    return np.pad(plane, ((0, rows - plane.shape[0]), (0, cols - plane.shape[1])), mode="edge")


def sampled_jpeg(helper: Path, img: np.ndarray, factors, workdir: Path,
                 quality: int = 85, single_scans: bool = False) -> bytes:
    """A baseline JPEG of an ``(H, W, 3)`` RGB (or ``(H, W)`` grey) image
    with sampling ``factors`` ``[(h, v), ...]`` a component, chroma
    box-averaged down to ``ceil(W * h / hmax)`` x ``ceil(H * v / vmax)``,
    written from those raw planes by libjpeg."""
    import subprocess

    hgt, wid = img.shape[:2]
    if img.ndim == 2:
        planes = [img.astype(np.float64)]
    else:
        rgb = img.astype(np.float64)
        y = 0.299 * rgb[..., 0] + 0.587 * rgb[..., 1] + 0.114 * rgb[..., 2]
        cb = -0.168736 * rgb[..., 0] - 0.331264 * rgb[..., 1] + 0.5 * rgb[..., 2] + 128
        cr = 0.5 * rgb[..., 0] - 0.418688 * rgb[..., 1] - 0.081312 * rgb[..., 2] + 128
        planes = [y, cb, cr]
    hmax = max(f[0] for f in factors)
    vmax = max(f[1] for f in factors)
    mcux, mcuy = -(-wid // (8 * hmax)), -(-hgt // (8 * vmax))
    raw = []
    for plane, (fh, fv) in zip(planes, factors):
        # the component at its own size: box means over (vmax/v) x (hmax/h)
        # pixels (the ratio need not be an integer: nearest source window)
        ch, cw = -(-hgt * fv // vmax), -(-wid * fh // hmax)
        ys = (np.arange(ch) * vmax / fv).astype(int)
        xs = (np.arange(cw) * hmax / fh).astype(int)
        ry, rx = max(1, vmax // fv), max(1, hmax // fh)
        full = _pad_plane(plane, hgt + ry, wid + rx)
        acc = sum(full[ys + dy][:, xs + dx] for dy in range(ry) for dx in range(rx))
        comp = np.clip(np.round(acc / (ry * rx)), 0, 255).astype(np.uint8)
        raw.append(_pad_plane(comp, mcuy * fv * 8, mcux * fh * 8))
    src, dst = workdir / "planes.raw", workdir / "out.jpg"
    src.write_bytes(b"".join(p.tobytes() for p in raw))
    args = [str(v) for f in factors for v in f]
    subprocess.run([str(helper), str(src), str(wid), str(hgt), str(len(factors)),
                    str(quality), str(int(single_scans)), str(dst), *args], check=True)
    return dst.read_bytes()


# ------------------------------------------------- WebP containers

def riff_chunks(data: bytes) -> list:
    """``(tag, payload)`` of each chunk of a RIFF WebP file."""
    assert data[:4] == b"RIFF" and data[8:12] == b"WEBP"
    out, pos = [], 12
    while pos + 8 <= len(data):
        tag, size = data[pos:pos + 4], struct.unpack("<I", data[pos + 4:pos + 8])[0]
        out.append((tag, data[pos + 8:pos + 8 + size]))
        pos += 8 + size + (size & 1)
    return out


def chunk(tag: bytes, payload: bytes) -> bytes:
    """A RIFF chunk, padded to an even size."""
    return tag + struct.pack("<I", len(payload)) + payload + b"\x00" * (len(payload) & 1)


def riff(*chunks: bytes) -> bytes:
    body = b"WEBP" + b"".join(chunks)
    return b"RIFF" + struct.pack("<I", len(body)) + body


def vp8x(width: int, height: int, flags: int) -> bytes:
    """A VP8X chunk: ICC 0x20, alpha 0x10, EXIF 0x08, XMP 0x04, animation
    0x02."""
    return chunk(b"VP8X", struct.pack("<I", flags) + (width - 1).to_bytes(3, "little")
                 + (height - 1).to_bytes(3, "little"))


def alpha_deltas(alpha: np.ndarray, method: int) -> np.ndarray:
    """The ALPH filter (1 horizontal, 2 vertical, 3 gradient; 0 none) of an
    ``(H, W)`` alpha plane, whose inverse libwebp's unfilter applies."""
    a = alpha.astype(np.int32)
    d = a.copy()
    if method == 0:
        return alpha.copy()
    d[0, 1:] = a[0, 1:] - a[0, :-1]
    for y in range(1, a.shape[0]):
        if method == 1:
            d[y, 0] = a[y, 0] - a[y - 1, 0]
            d[y, 1:] = a[y, 1:] - a[y, :-1]
        elif method == 2:
            d[y] = a[y] - a[y - 1]
        else:
            d[y, 0] = a[y, 0] - a[y - 1, 0]
            pred = np.clip(a[y, :-1] + a[y - 1, 1:] - a[y - 1, :-1], 0, 255)
            d[y, 1:] = a[y, 1:] - pred
    return (d & 0xFF).astype(np.uint8)


def alph_chunk(alpha: np.ndarray, method: int, compressed: bool, lossless_of) -> bytes:
    """An ALPH chunk of ``alpha`` filtered by ``method``: raw, or as the
    green channel of a headerless VP8L stream (``lossless_of`` encodes an
    RGBA image losslessly and returns the WebP file)."""
    deltas = alpha_deltas(alpha, method)
    head = bytes([int(compressed) | (method << 2)])
    if not compressed:
        return chunk(b"ALPH", head + deltas.tobytes())
    img = np.zeros(alpha.shape + (4,), np.uint8)
    img[..., 1] = deltas
    img[..., 3] = 255
    vp8l = dict(riff_chunks(lossless_of(img)))[b"VP8L"]
    return chunk(b"ALPH", head + vp8l[5:])  # the 5-byte header: signature, size


# ------------------------------------------------------------- writing

def _pil_save(img, fmt, **kw) -> bytes:
    buf = io.BytesIO()
    img.save(buf, fmt, **kw)
    return buf.getvalue()


def make() -> dict:
    """Write every fixture and the manifest; returns the manifest."""
    import PIL.Image

    import vision_tpu.io._codecs as jcodecs
    from vision_tpu.io import image as jimage
    from vision_tpu_torch.io import _codecs, encode_jpeg

    if not jcodecs.has_native():
        raise RuntimeError("vision_tpu's native codec shim did not load")
    DATA.mkdir(exist_ok=True)
    h, w = SIZE
    files = {}
    manifest = {}

    def jpeg_entry(name, data, coefs=True, pillow_ref=False):
        port = _codecs.decode_jpeg_native(data)
        ref = (np.asarray(PIL.Image.open(io.BytesIO(data)).convert("RGB"))
               if pillow_ref else jimage.decode_jpeg(data))
        diff = np.abs(port.astype(int) - ref.astype(int))
        entry = {"kind": "jpeg", "shape": list(port.shape),
                 "pixels_sha256": sha256(port), "pixels_source": "port host decode",
                 "reference": "Pillow convert('RGB')" if pillow_ref else "libjpeg",
                 "reference_max_abs_diff": int(diff.max()),
                 "reference_mean_abs_diff": float(diff.mean())}
        if coefs:
            for m in (0, 5):
                lib = jcodecs.jpeg_coefficients_native(data, m)
                entry[f"coefs_sha256_m{m or 8}"] = coef_digest(lib[0])
            entry["samp"] = [list(s) for s in lib[2]]
        files[name] = data
        manifest[name] = entry

    for k, (name, kw) in enumerate(PROGRESSIVE.items()):
        kw = dict(kw)
        img = photo(h, w, seed=10 + k)
        if kw.pop("grey", False):
            img = img[..., 0]
        data = _pil_save(PIL.Image.fromarray(img), "JPEG", progressive=True, **kw)
        assert data[data.index(b"\xff\xc2"):][:2] == b"\xff\xc2"
        jpeg_entry(name, data)
    cmyk = photo(h, w, seed=20, channels=4)
    jpeg_entry("cmyk.jpg", _pil_save(PIL.Image.frombytes("CMYK", (w, h), cmyk.tobytes()),
                                     "JPEG", quality=80),
               coefs=False, pillow_ref=True)
    base = encode_jpeg(__import__("torch").from_numpy(photo(h, w, seed=21)).permute(2, 0, 1), 85)
    jpeg_entry("exif_rot6.jpg", base[:2] + exif_app1(6) + base[2:])

    rng = np.random.RandomState(7)
    small = photo(37, 53, seed=30)
    alpha = rng.randint(0, 256, (37, 53, 1), np.uint8)
    pngs = {
        "rgb.png": _pil_save(PIL.Image.fromarray(small), "PNG"),
        "rgba.png": _pil_save(PIL.Image.fromarray(np.concatenate([small, alpha], 2)), "PNG"),
        "grey_alpha.png": _pil_save(PIL.Image.fromarray(
            np.concatenate([small[..., :1], alpha], 2), "LA"), "PNG"),
        "palette_trns.png": _pil_save(PIL.Image.fromarray(small).quantize(16), "PNG",
                                      transparency=bytes([0, 64, 128, 255, 7])),
        "bit1.png": _pil_save(PIL.Image.fromarray(small[..., 0] > 128), "PNG"),
        "grey16.png": _pil_save(PIL.Image.fromarray(
            (small[..., 0].astype(np.uint16) * 257 + rng.randint(0, 200, (37, 53))).astype(np.uint16)),
            "PNG"),
        "rgb16.png": png_stream(small.astype(np.uint16) * 256 + rng.randint(0, 256, small.shape),
                                2, 16, filters=(0, 1, 2, 3, 4)),
        "adam7.png": png_stream(small, 2, 8, filters=(0,), interlace=True),
    }
    for name, data in pngs.items():
        if name == "adam7.png":
            pixels = np.asarray(PIL.Image.open(io.BytesIO(data)))
            assert (pixels == small).all()
            source = "Pillow (equals the source array)"
        else:
            pixels = jcodecs.decode_png_native(data)
            source = "libpng (vision_tpu decode_png)"
        entry = {"kind": "png", "shape": list(pixels.shape),
                 "pixels_sha256": sha256(pixels), "pixels_source": source}
        if name.endswith("16.png"):
            wide = jcodecs.decode_png16_native(data)
            entry["pixels16_sha256"] = sha256(wide)
            entry["shape16"] = list(wide.shape)
        files[name] = data
        manifest[name] = entry

    frames = []
    for k in range(4):
        f = photo(40, 56, seed=40 + k)
        f[5:20, 5 + 8 * k:25 + 8 * k] = (255, 0, 0)
        frames.append(PIL.Image.fromarray(f).quantize(32))
    gif = _pil_save(frames[0], "GIF", save_all=True, append_images=frames[1:],
                    disposal=[0, 2, 3, 1], transparency=3, duration=40, loop=0)
    pixels = jcodecs.decode_gif_native(gif)
    files["anim.gif"] = gif
    manifest["anim.gif"] = {"kind": "gif", "shape": list(pixels.shape),
                            "pixels_sha256": sha256(pixels),
                            "pixels_source": "vision_tpu decode_gif"}

    with tempfile.TemporaryDirectory() as tmp:
        _webp_and_sampling(Path(tmp), files, manifest, jpeg_entry)

    for name, data in files.items():
        (DATA / name).write_bytes(data)
        manifest[name]["bytes"] = len(data)
    (DATA / "manifest.json").write_text(json.dumps(manifest, indent=1, sort_keys=True) + "\n")
    return manifest


SAMPLING = {  # name -> (factors a component, one scan a component)
    "samp_3x1.jpg": ([(3, 1), (1, 1), (1, 1)], False),
    "samp_1x3.jpg": ([(1, 3), (1, 1), (1, 1)], False),
    "samp_4x1.jpg": ([(4, 1), (1, 1), (1, 1)], False),
    "samp_1x4.jpg": ([(1, 4), (1, 1), (1, 1)], False),
    "samp_3x2.jpg": ([(3, 2), (1, 1), (1, 1)], False),
    "samp_2x3.jpg": ([(2, 3), (1, 1), (1, 1)], False),
    "samp_4x2.jpg": ([(4, 2), (1, 1), (1, 1)], False),
    "samp_2x4.jpg": ([(2, 4), (1, 1), (1, 1)], False),
    # 12 blocks an MCU: more than an interleaved scan may hold
    "samp_4x2_2x1.jpg": ([(4, 2), (2, 1), (2, 1)], True),
    "samp_grey_4x4.jpg": ([(4, 4)], False),
}
SAMPLING_SIZE = (131, 197)  # H, W: no factor divides it

WEBP_TIMED = ("webp_lossy_500x375.webp", "webp_lossless_500x375.webp",
              "webp_alpha_500x375.webp")


def smooth_photo(h: int, w: int, seed: int, levels: int = 64) -> np.ndarray:
    """``photo`` without its noise, quantised to ``levels`` steps of 256:
    a lossless stream of it stays small."""
    yy, xx = np.meshgrid(np.arange(h), np.arange(w), indexing="ij")
    base = (128 + 70 * np.sin(xx / (15.0 + seed % 5)) * np.cos(yy / (21.0 + seed % 3))
            + 30 * np.sin((xx + yy) / 41.0))
    img = np.clip(base[..., None] + np.linspace(-25, 25, 3), 0, 255)
    step = 256 // levels
    return (img // step * step).astype(np.uint8)


def soft_alpha(h: int, w: int) -> np.ndarray:
    """An alpha plane of a soft disc and a ramp."""
    yy, xx = np.meshgrid(np.arange(h), np.arange(w), indexing="ij")
    r = np.hypot(yy - h / 2, xx - w / 2) / (0.45 * min(h, w))
    return np.clip(255 * (1.2 - r) + 40 * np.sin(xx / 7.0), 0, 255).astype(np.uint8)


def _webp_and_sampling(tmp: Path, files: dict, manifest: dict, jpeg_entry) -> None:
    """The WebP fixtures and the JPEGs of sampling factors 3 and 4."""
    from vision_tpu.io import image as jimage

    webp = build_helper(WEBP_HELPER, "webp_helper", "-lwebp", tmp)
    jpeg = build_helper(JPEG_HELPER, "jpeg_helper", "-ljpeg", tmp)

    def enc(img, **config):
        if img.shape[2] == 3:
            img = np.concatenate([img, np.full(img.shape[:2] + (1,), 255, np.uint8)], 2)
        return webp_encode(webp, img, tmp, **config)

    def lossless(img):
        return enc(img, lossless=1, quality=75, method=4, exact=1)

    def image_chunk(data):
        return [c for c in riff_chunks(data) if c[0] in (b"VP8 ", b"VP8L")][0]

    streams = {}
    for q in (5, 100):
        streams[f"webp_lossy_q{q}.webp"] = enc(photo(93, 121, seed=50 + q), quality=q)
    streams["webp_lossy_q75_odd.webp"] = enc(photo(45, 67, seed=51), quality=75)
    streams["webp_simple_4parts.webp"] = enc(
        photo(120, 160, seed=52), quality=60, filter_type=0, filter_strength=60,
        partitions=2, segments=1, method=2)  # methods above 2 write one partition
    streams["webp_1segment.webp"] = enc(photo(72, 88, seed=53), quality=50, segments=1,
                                        filter_type=1, filter_strength=40)
    streams["webp_4segments.webp"] = enc(photo(72, 88, seed=54), quality=50, segments=4,
                                         sns_strength=100, filter_type=1,
                                         filter_strength=70, filter_sharpness=3)
    streams["webp_lossless_photo.webp"] = lossless(photo(48, 64, seed=55))
    few = np.array([[20, 40, 200], [250, 250, 10], [0, 0, 0], [90, 160, 90]], np.uint8)
    yy, xx = np.meshgrid(np.arange(61), np.arange(97), indexing="ij")
    streams["webp_lossless_palette.webp"] = lossless(few[((xx // 9) + (yy // 7)) % 4])
    cache_img = photo(64, 80, seed=56) // 16 * 16
    streams["webp_lossless_cache.webp"] = enc(cache_img, lossless=1, quality=100,
                                              method=6, exact=1)
    # lossy + alpha: every ALPH filter, raw and VP8L-compressed
    rgb = photo(40, 48, seed=57)
    alpha = soft_alpha(40, 48)
    vp8 = chunk(*image_chunk(enc(rgb, quality=70)))
    for method, fname in enumerate(("none", "horizontal", "vertical", "gradient")):
        for compressed in (False, True):
            name = f"webp_alpha_{'vp8l' if compressed else 'raw'}_{fname}.webp"
            streams[name] = riff(vp8x(48, 40, 0x10),
                                 alph_chunk(alpha, method, compressed, lossless), vp8)
    # extended: an odd-sized ICC profile and EXIF around the image chunk
    icc = bytes(range(131))
    exif = b"Exif\x00\x00" + exif_app1(6)[10:]
    still = enc(photo(36, 52, seed=58), quality=80)
    streams["webp_vp8x_icc_exif.webp"] = riff(
        vp8x(52, 36, 0x20 | 0x08), chunk(b"ICCP", icc), chunk(*image_chunk(still)),
        chunk(b"EXIF", exif))
    # two frames: a lossy + alpha frame at an offset on a larger canvas,
    # then a lossless one
    f1 = enc(photo(30, 40, seed=59), quality=75)
    a1 = soft_alpha(30, 40)
    f2 = lossless(photo(48, 64, seed=60))

    def anmf(x, y, w, h, *chunks):
        head = ((x // 2).to_bytes(3, "little") + (y // 2).to_bytes(3, "little")
                + (w - 1).to_bytes(3, "little") + (h - 1).to_bytes(3, "little")
                + (100).to_bytes(3, "little") + bytes([0]))
        return chunk(b"ANMF", head + b"".join(chunks))

    streams["webp_anim.webp"] = riff(
        vp8x(64, 48, 0x02 | 0x10), chunk(b"ANIM", bytes(4) + struct.pack("<H", 0)),
        anmf(8, 6, 40, 30, alph_chunk(a1, 1, True, lossless), chunk(*image_chunk(f1))),
        anmf(0, 0, 64, 48, chunk(*image_chunk(f2))))
    # ImageNet-sized, for the host's times
    h, w = SIZE
    streams["webp_lossy_500x375.webp"] = enc(photo(h, w, seed=61), quality=75)
    streams["webp_lossless_500x375.webp"] = lossless(smooth_photo(h, w, seed=62))
    streams["webp_alpha_500x375.webp"] = riff(
        vp8x(w, h, 0x10), alph_chunk(soft_alpha(h, w), 1, True, lossless),
        chunk(*image_chunk(enc(photo(h, w, seed=63), quality=75))))
    for name, data in streams.items():
        pixels = jimage.decode_webp(data)
        source = ("Pillow (vision_tpu decode_webp's fallback)" if name == "webp_anim.webp"
                  else "libwebp WebPDecodeRGBA (vision_tpu decode_webp)")
        files[name] = data
        manifest[name] = {"kind": "webp", "shape": list(pixels.shape),
                          "pixels_sha256": sha256(pixels), "pixels_source": source}

    hs, ws = SAMPLING_SIZE
    for k, (name, (factors, single)) in enumerate(SAMPLING.items()):
        img = photo(hs, ws, seed=70 + k)
        if len(factors) == 1:
            img = img[..., 0]
        jpeg_entry(name, sampled_jpeg(jpeg, img, factors, tmp, single_scans=single))
        got = tuple(map(tuple, manifest[name]["samp"]))
        assert got == tuple(factors), (name, got)


def load_manifest() -> dict:
    return json.loads((DATA / "manifest.json").read_text())


if __name__ == "__main__":
    import sys

    sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
    m = make()
    total = sum(e["bytes"] for e in m.values())
    print(json.dumps({k: {"bytes": v["bytes"], "shape": v["shape"]} for k, v in m.items()},
                     indent=1))
    print("total bytes", total)
