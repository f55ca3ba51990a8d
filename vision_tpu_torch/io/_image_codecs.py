"""PNG and GIF through the port's own codec (``csrc/image_codecs.cpp``, no
library; the counterpart of ``vision_tpu/io/_codecs.py``'s PNG and GIF
half, which links libpng), and WebP through ``csrc/webp_codec.cpp`` (its
WebP half links libwebp).

A PNG's chunks are walked here, their CRCs checked with ``zlib.crc32`` (a
critical chunk that fails raises, an ancillary one is skipped, as libpng
does), its IDAT data inflated with Python's ``zlib``; the C++ side undoes
the filters and the Adam7 interlace and expands the samples as
``vision_tpu``'s libpng reader asks libpng to. Encoding filters the rows in
C++ and deflates them here. GIF and WebP are decoded whole in C++. The
libraries are built by ``_codecs.build_source`` beside the JPEG codec;
ctypes releases the interpreter lock during each call.
"""

from __future__ import annotations

import ctypes
import struct
import threading
import zlib
from typing import Dict, List, Optional

import numpy as np

from vision_tpu_torch.io import _codecs

__all__ = [
    "decode_gif_native",
    "decode_png_native",
    "decode_webp_native",
    "encode_png_native",
    "png_header",
]

PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"
_ERRORS = {-1: "a corrupt or truncated stream", -2: "out of memory",
           7: "a buffer too small for the image"}

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_webp_lib: Optional[ctypes.CDLL] = None


def _load() -> ctypes.CDLL:
    global _lib
    with _lock:
        if _lib is None:
            _codecs.build_source(_codecs._IMAGE_SOURCE)
            lib = ctypes.CDLL(str(_codecs.lib_path(_codecs._IMAGE_SOURCE)))
            p, i, sz = ctypes.c_void_p, ctypes.c_int, ctypes.c_size_t
            ip = ctypes.POINTER(ctypes.c_int)
            lib.vt_png_decode.argtypes = [ctypes.c_char_p, sz, i, i, i, i, i,
                                          ctypes.c_char_p, i, ctypes.c_char_p,
                                          i, i, p, sz, ip]
            lib.vt_png_indices.argtypes = [ctypes.c_char_p, sz, i, i, i, i,
                                           i, p, sz]
            lib.vt_png_filter.argtypes = [ctypes.c_char_p, i, i, i, p, sz]
            lib.vt_decode_gif.argtypes = [
                ctypes.c_char_p, sz,
                ctypes.POINTER(ctypes.POINTER(ctypes.c_uint8)), ip, ip, ip]
            for fn in ("vt_png_decode", "vt_png_indices", "vt_png_filter",
                       "vt_decode_gif"):
                getattr(lib, fn).restype = ctypes.c_int
            lib.vt_free.argtypes = [p]
            lib.vt_free.restype = None
            _lib = lib
        return _lib


def _chunks(data: bytes):
    """``(type, payload)`` of every chunk up to IEND, CRCs checked."""
    if data[:8] != PNG_SIGNATURE:
        raise RuntimeError("decode_png: not a PNG stream (no signature)")
    pos, n = 8, len(data)
    while pos + 12 <= n:
        length, ctype = struct.unpack(">I4s", data[pos:pos + 8])
        end = pos + 12 + length
        if end > n:
            raise RuntimeError(f"decode_png: chunk {ctype!r} cut short")
        payload = data[pos + 8:pos + 8 + length]
        crc = struct.unpack(">I", data[end - 4:end])[0]
        pos = end
        if zlib.crc32(ctype + payload) != crc:
            if ctype[0] & 0x20:  # ancillary: libpng warns and skips it
                continue
            raise RuntimeError(f"decode_png: CRC error in chunk {ctype!r}")
        yield ctype, payload
        if ctype == b"IEND":
            return


def png_header(data) -> Dict:
    """The chunks a decode needs: ``width``, ``height``, ``depth``,
    ``color_type``, ``interlace``, ``plte``, ``trns`` (bytes or None) and
    ``idat`` (the concatenated, still deflated data)."""
    data = bytes(data)
    info: Dict = {"plte": None, "trns": None}
    idat: List[bytes] = []
    for ctype, payload in _chunks(data):
        if ctype == b"IHDR":
            if len(payload) != 13:
                raise RuntimeError("decode_png: a bad IHDR chunk")
            w, h, depth, ctype_, comp, filt, inter = struct.unpack(
                ">IIBBBBB", payload)
            if comp != 0 or filt != 0 or inter > 1 or not w or not h:
                raise RuntimeError("decode_png: an IHDR this decoder does not "
                                   "read (compression, filter or interlace "
                                   "method)")
            info.update(width=w, height=h, depth=depth, color_type=ctype_,
                        interlace=inter)
        elif ctype == b"PLTE":
            info["plte"] = payload
        elif ctype == b"tRNS":
            info["trns"] = payload
        elif ctype == b"IDAT":
            idat.append(payload)
    if "width" not in info or not idat:
        raise RuntimeError("decode_png: no IHDR or no IDAT chunk")
    info["idat"] = b"".join(idat)
    return info


def _inflate(info) -> bytes:
    w, h = info["width"], info["height"]
    try:
        inflater = zlib.decompressobj()
        # no more than the rows of the largest layout (8 bytes a pixel, a
        # filter byte a row of each Adam7 pass) can hold
        return inflater.decompress(info["idat"], h * (8 * w + 2) + 64)
    except zlib.error as e:
        raise RuntimeError(f"decode_png: the IDAT data do not inflate ({e})") from e


def decode_png_indices_native(data) -> np.ndarray:
    """``(H, W)`` uint8 of a palette PNG's indices, the palette left
    unexpanded (index 255 stays 255), or of an 8-bit grey PNG's levels:
    what ``np.asarray(PIL.Image.open(...))`` gives for Pillow's ``"P"``
    and ``"L"`` modes, and what a VOC class mask is read as. Private: the
    public ``decode_png`` expands palettes to RGB, as ``vision_tpu``'s
    does. Raises ``RuntimeError`` for any other PNG."""
    info = png_header(data)
    w, h = info["width"], info["height"]
    if not (info["color_type"] == 3 or (info["color_type"] == 0
                                        and info["depth"] == 8)):
        raise RuntimeError("decode_png_indices: a palette or 8-bit grey PNG "
                           f"only (colour type {info['color_type']}, "
                           f"{info['depth']} bits)")
    raw = _inflate(info)
    out = np.empty((h, w), np.uint8)
    rc = _load().vt_png_indices(raw, len(raw), w, h, info["depth"],
                                info["color_type"], info["interlace"],
                                out.ctypes.data, out.nbytes)
    if rc != 0:
        raise RuntimeError(f"decode_png_indices: {_ERRORS.get(rc, rc)}")
    return out


def decode_png_native(data, wide: bool = False) -> np.ndarray:
    """``(H, W, C)`` of a PNG stream: uint8 with palettes and low-bit grey
    expanded, ``tRNS`` as alpha and 16-bit samples cut to their high byte
    (``vision_tpu``'s ``decode_png_native``); with ``wide`` uint16 of a
    16-bit stream (its ``decode_png16_native``). Raises ``RuntimeError``
    naming what is wrong with the stream."""
    info = png_header(data)
    w, h, depth = info["width"], info["height"], info["depth"]
    if wide and depth != 16:
        raise RuntimeError(f"decode_png16: a {depth}-bit PNG (16-bit only)")
    plte = info["plte"] or b""
    trns = info["trns"] or b""
    raw = _inflate(info)
    lib = _load()
    channels = ctypes.c_int()
    args = (raw, len(raw), w, h, depth, info["color_type"], info["interlace"],
            plte, len(plte) // 3, trns, len(trns), int(wide))
    rc = lib.vt_png_decode(*args, None, 0, ctypes.byref(channels))
    if rc == 7:
        out = np.empty((h, w, channels.value), np.uint16 if wide else np.uint8)
        rc = lib.vt_png_decode(*args, out.ctypes.data, out.nbytes,
                               ctypes.byref(channels))
    if rc != 0:
        raise RuntimeError(f"decode_png: {_ERRORS.get(rc, rc)}")
    return out


def encode_png_native(img: np.ndarray, compression_level: int = 6) -> bytes:
    """An 8-bit, non-interlaced PNG of an ``(H, W)`` or ``(H, W, C)``
    uint8 array, C 1-4 (grey, grey + alpha, RGB, RGBA), each row filtered
    by libpng's default choice, deflated at ``compression_level``."""
    img = np.ascontiguousarray(img, dtype=np.uint8)
    if img.ndim == 2:
        img = img[:, :, None]
    if img.ndim != 3 or img.shape[2] not in (1, 2, 3, 4) or 0 in img.shape:
        raise ValueError(f"encode_png: 1-4 channels, got shape {img.shape}")
    if not 0 <= compression_level <= 9:
        raise ValueError(f"compression_level in 0..9, got {compression_level}")
    h, w, c = img.shape
    rows = np.empty(h * (w * c + 1), np.uint8)
    rc = _load().vt_png_filter(img.tobytes(), h, w, c, rows.ctypes.data,
                               rows.nbytes)
    if rc != 0:
        raise RuntimeError(f"encode_png: {_ERRORS.get(rc, rc)}")

    def chunk(ctype: bytes, payload: bytes) -> bytes:
        return (struct.pack(">I", len(payload)) + ctype + payload
                + struct.pack(">I", zlib.crc32(ctype + payload)))

    color_type = {1: 0, 2: 4, 3: 2, 4: 6}[c]
    ihdr = struct.pack(">IIBBBBB", w, h, 8, color_type, 0, 0, 0)
    return (PNG_SIGNATURE + chunk(b"IHDR", ihdr)
            + chunk(b"IDAT", zlib.compress(rows.tobytes(), compression_level))
            + chunk(b"IEND", b""))


def decode_gif_native(data) -> np.ndarray:
    """Every frame of a GIF, ``(N, H, W, 3)`` uint8 RGB on the logical
    screen (``vision_tpu``'s ``decode_gif_native``). Raises
    ``RuntimeError`` for a stream that gives no frame."""
    data = bytes(data)
    lib = _load()
    buf = ctypes.POINTER(ctypes.c_uint8)()
    n, h, w = ctypes.c_int(), ctypes.c_int(), ctypes.c_int()
    rc = lib.vt_decode_gif(data, len(data), ctypes.byref(buf), ctypes.byref(n),
                           ctypes.byref(h), ctypes.byref(w))
    if rc != 0:
        raise RuntimeError(f"decode_gif: {_ERRORS.get(rc, rc)}")
    total = n.value * h.value * w.value * 3
    arr = np.ctypeslib.as_array(buf, shape=(total,)).copy()
    lib.vt_free(buf)
    return arr.reshape(n.value, h.value, w.value, 3)


def _load_webp() -> ctypes.CDLL:
    global _webp_lib
    with _lock:
        if _webp_lib is None:
            _codecs.build_source(_codecs._WEBP_SOURCE)
            lib = ctypes.CDLL(str(_codecs.lib_path(_codecs._WEBP_SOURCE)))
            ip = ctypes.POINTER(ctypes.c_int)
            lib.vt_decode_webp.argtypes = [
                ctypes.c_char_p, ctypes.c_size_t,
                ctypes.POINTER(ctypes.POINTER(ctypes.c_uint8)), ip, ip, ip,
                ctypes.c_char_p, ctypes.c_int]
            lib.vt_decode_webp.restype = ctypes.c_int
            lib.vt_webp_free.argtypes = [ctypes.c_void_p]
            lib.vt_webp_free.restype = None
            _webp_lib = lib
        return _webp_lib


def decode_webp_native(data) -> np.ndarray:
    """``(H, W, C)`` uint8 of a WebP stream, as ``vision_tpu``'s
    ``decode_webp`` gives it before its mode: RGBA (C = 4, not
    premultiplied) from libwebp's ``WebPDecodeRGBA`` for a still image,
    lossy, lossless or lossy with alpha; an animation's first frame on its
    canvas from Pillow's fallback (C = 3 where the VP8X header has no alpha
    flag). Raises ``RuntimeError`` naming WebP and what is wrong with the
    stream."""
    data = bytes(data)
    lib = _load_webp()
    buf = ctypes.POINTER(ctypes.c_uint8)()
    h, w, c = ctypes.c_int(), ctypes.c_int(), ctypes.c_int()
    err = ctypes.create_string_buffer(256)
    rc = lib.vt_decode_webp(data, len(data), ctypes.byref(buf), ctypes.byref(h),
                            ctypes.byref(w), ctypes.byref(c), err, len(err))
    if rc != 0:
        why = err.value.decode() if rc == -1 else _ERRORS.get(rc, rc)
        raise RuntimeError(f"decode_webp: {why}")
    total = h.value * w.value * c.value
    arr = np.ctypeslib.as_array(buf, shape=(total,)).copy()
    lib.vt_webp_free(buf)
    return arr.reshape(h.value, w.value, c.value)
