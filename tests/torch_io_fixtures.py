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
  from libjpeg's, or from Pillow's for CMYK, are recorded beside them).

Every stream is ImageNet-sized (500x375) but the PNGs and the GIF.
"""

from __future__ import annotations

import hashlib
import io
import json
import struct
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

    for name, data in files.items():
        (DATA / name).write_bytes(data)
        manifest[name]["bytes"] = len(data)
    (DATA / "manifest.json").write_text(json.dumps(manifest, indent=1, sort_keys=True) + "\n")
    return manifest


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
