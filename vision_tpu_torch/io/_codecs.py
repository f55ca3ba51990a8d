"""ctypes bindings of the port's JPEG codec (``csrc/jpeg_codec.cpp``; the
counterpart of ``vision_tpu/io/_codecs.py``'s JPEG half). The PNG, GIF and
WebP half is ``io/_image_codecs.py``, built by :func:`build_source` too.

The codecs are plain C++17 with no library, so the host compiler that
``nvcc`` needs already (``g++``) builds them anywhere: on first use each
is compiled into ``build/kernels/`` at the root of the checkout, its name
keyed by a hash of the source and the flags, through a temporary file and
``os.replace``, so that processes building at once never load half a file.
A failed build raises with the compiler's output; there is no fallback.

ctypes releases the interpreter lock during each call, so host threads
decode in parallel.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
import time
from pathlib import Path
from typing import List, Optional, Tuple

import numpy as np

from vision_tpu_torch._kernels import build_dir

__all__ = [
    "build",
    "build_source",
    "decode_jpeg_native",
    "encode_jpeg_native",
    "has_native",
    "jpeg_coefficients_native",
    "jpeg_frame",
    "stream_error",
]

_SOURCE = Path(__file__).resolve().parent.parent / "csrc" / "jpeg_codec.cpp"
_IMAGE_SOURCE = _SOURCE.with_name("image_codecs.cpp")
_WEBP_SOURCE = _SOURCE.with_name("webp_codec.cpp")
_FLAGS = ["-O2", "-shared", "-fPIC", "-std=c++17", "-ffp-contract=off"]

# the codec's return codes, as jpeg_codec.cpp's Status
_STREAM_ERRORS = {
    -1: "a corrupt or truncated JPEG stream",
    -2: "out of memory",
    2: "an arithmetic-coded JPEG, which the port's decoder does not read",
    3: "a lossless or hierarchical JPEG, which the port's decoder does not read",
    4: "a JPEG of other than 8-bit samples (12-bit), which the port's decoder "
       "does not read",
    5: "a JPEG of other than 1 or 3 components (CMYK: its coefficients are "
       "not read, only its pixels on the host), or of 2",
    6: "a JPEG with sampling factors outside 1..4, or (to pixels) a "
       "luma-to-chroma ratio that is not an integer or chroma sampled finer "
       "than luma, which libjpeg does not read either",
    7: "a JPEG of another size than the buffer given for it",
}

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None


class _VtImage(ctypes.Structure):
    _fields_ = [
        ("data", ctypes.POINTER(ctypes.c_uint8)),
        ("height", ctypes.c_int),
        ("width", ctypes.c_int),
        ("channels", ctypes.c_int),
    ]


def lib_path(source: Path) -> Path:
    """Where :func:`build_source` puts the library of ``source``."""
    digest = hashlib.sha256(
        source.read_bytes() + " ".join(_FLAGS).encode()).hexdigest()[:16]
    return build_dir() / f"lib{source.stem}-{digest}.so"


def _lib_path() -> Path:
    return lib_path(_SOURCE)


def build_source(source: Path) -> float:
    """Compile one codec source if it is not built yet. Returns the seconds
    spent (0.0 when it was built already)."""
    out = lib_path(source)
    if out.exists():
        return 0.0
    t0 = time.perf_counter()
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.{threading.get_ident()}.tmp")
    proc = subprocess.run(
        ["g++", *_FLAGS, "-o", str(tmp), str(source)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"g++ failed for {source.name}:\n{proc.stdout}")
    os.replace(tmp, out)  # atomic: a concurrent loader never sees half a file
    return time.perf_counter() - t0


def build() -> float:
    """Compile the codecs (JPEG, PNG / GIF and WebP) if they are not built
    yet. Returns the seconds spent (0.0 when they were built already)."""
    return sum(build_source(src) for src in (_SOURCE, _IMAGE_SOURCE, _WEBP_SOURCE))


def _load() -> ctypes.CDLL:
    global _lib
    with _lock:
        if _lib is None:
            build_source(_SOURCE)
            lib = ctypes.CDLL(str(_lib_path()))
            p, i, sz = ctypes.c_void_p, ctypes.c_int, ctypes.c_size_t
            ip = ctypes.POINTER(ctypes.c_int)
            lib.vt_jpeg_coefficients.argtypes = [
                ctypes.c_char_p, sz, i, ip, ip, ip, ip, ip, ip, ip,
                ctypes.POINTER(ctypes.c_uint16),
                ctypes.POINTER(ctypes.POINTER(ctypes.c_int16))]
            lib.vt_jpeg_coefficients_to.argtypes = (
                lib.vt_jpeg_coefficients.argtypes[:-1]
                + [ctypes.POINTER(p), ctypes.POINTER(sz)])
            lib.vt_decode_jpeg.argtypes = [ctypes.c_char_p, sz, i,
                                           ctypes.POINTER(_VtImage)]
            lib.vt_decode_jpeg_to.argtypes = [ctypes.c_char_p, sz, i, p, sz,
                                              ip, ip, ip]
            lib.vt_encode_jpeg.argtypes = [
                ctypes.c_char_p, i, i, i, i,
                ctypes.POINTER(ctypes.POINTER(ctypes.c_uint8)),
                ctypes.POINTER(sz)]
            lib.vt_free.argtypes = [p]
            lib.vt_free.restype = None
            for fn in ("vt_jpeg_coefficients", "vt_jpeg_coefficients_to",
                       "vt_decode_jpeg", "vt_decode_jpeg_to", "vt_encode_jpeg"):
                getattr(lib, fn).restype = ctypes.c_int
            _lib = lib
        return _lib


def has_native() -> bool:
    """True once the codec is built and loaded (building it if need be);
    a failed build raises."""
    return _load() is not None


def stream_error(code: int) -> str:
    """What a non-zero return code of the codec means."""
    return _STREAM_ERRORS.get(code, f"JPEG codec error {code}")


def _bytes(data) -> bytes:
    return data if isinstance(data, bytes) else bytes(data)


def _into(arr: np.ndarray, dtype) -> int:
    if arr.dtype != dtype or not arr.flags.c_contiguous or not arr.flags.writeable:
        raise ValueError(f"out: a writeable C-contiguous {np.dtype(dtype)} array")
    return arr.ctypes.data


# frame types the codec refuses (lossless, hierarchical, arithmetic-coded):
# a stream whose first frame header is one of these
_OTHER_SOF = frozenset((0xC3, 0xC5, 0xC6, 0xC7, *range(0xC9, 0xD0)))


def jpeg_frame(data) -> Optional[Tuple[Tuple[int, int], List[Tuple[int, int]]]]:
    """``((H, W), [(h_samp, v_samp), ...])`` from a stream's frame header
    (SOF0, SOF1 or SOF2: sequential and progressive streams group and
    bucket alike), read without decoding: the markers are walked as the
    codec walks them. None where no such header that the codec reads comes
    before the first scan (not a JPEG, a truncated header, another frame
    type, 12-bit samples, other than 1, 3 or 4 components, sampling outside
    1..4); the decode then says why. A header that parses does not make the
    stream decodable: a 4-component one (CMYK) decodes on the host only."""
    data = _bytes(data)
    n = len(data)
    if n < 4 or data[0] != 0xFF or data[1] != 0xD8:
        return None
    pos = 2
    while True:
        pos = data.find(b"\xff", pos)
        if pos < 0:
            return None
        while pos < n and data[pos] == 0xFF:
            pos += 1
        if pos >= n:
            return None
        m = data[pos]
        pos += 1
        if m == 0x00 or m == 0x01 or 0xD0 <= m <= 0xD7:
            continue  # stuffed byte or a marker without a length
        if m in (0xD8, 0xD9, 0xDA) or m in _OTHER_SOF or pos + 2 > n:
            return None
        seg_len = (data[pos] << 8) | data[pos + 1]
        if seg_len < 2 or pos + seg_len > n:
            return None
        if m in (0xC0, 0xC1, 0xC2):
            seg = pos + 2
            if seg_len < 8 or data[seg] != 8:
                return None
            h = (data[seg + 1] << 8) | data[seg + 2]
            w = (data[seg + 3] << 8) | data[seg + 4]
            ncomp = data[seg + 5]
            if ncomp not in (1, 3, 4) or not h or not w or seg_len < 8 + 3 * ncomp:
                return None
            samp = [(data[seg + 7 + 3 * i] >> 4, data[seg + 7 + 3 * i] & 15)
                    for i in range(ncomp)]
            if not all(1 <= a <= 4 and 1 <= b <= 4 for a, b in samp):
                return None
            return (h, w), samp
        pos += seg_len


def jpeg_coefficients_code(data, coef_limit: int = 0, out=None):
    """``(code, result)``: the codec's return code and, where it is 0, the
    tuple of :func:`jpeg_coefficients_native`."""
    lib = _load()
    data = _bytes(data)
    m = coef_limit if 0 < coef_limit < 8 else 8
    ncomp, height, width = ctypes.c_int(), ctypes.c_int(), ctypes.c_int()
    blocks_h, blocks_w = (ctypes.c_int * 3)(), (ctypes.c_int * 3)()
    samp_h, samp_v = (ctypes.c_int * 3)(), (ctypes.c_int * 3)()
    qtab = (ctypes.c_uint16 * (3 * 64))()
    head = (data, len(data), coef_limit, ctypes.byref(ncomp), ctypes.byref(height),
            ctypes.byref(width), blocks_h, blocks_w, samp_h, samp_v, qtab)
    if out is None:
        ptrs = (ctypes.POINTER(ctypes.c_int16) * 3)()
        rc = lib.vt_jpeg_coefficients(*head, ptrs)
    else:
        # room for 4: a CMYK frame's batch holds four arrays, which the
        # codec refuses before it writes any
        dst = (ctypes.c_void_p * 4)(*[_into(a, np.int16) for a in out])
        caps = (ctypes.c_size_t * 4)(*[a.size for a in out])
        rc = lib.vt_jpeg_coefficients_to(*head, dst, caps)
    if rc != 0:
        return rc, None
    coefs: List[np.ndarray] = []
    qtabs: List[np.ndarray] = []
    samp: List[Tuple[int, int]] = []
    for ci in range(ncomp.value):
        shape = (blocks_h[ci], blocks_w[ci], m * m)
        if out is None:
            arr = np.ctypeslib.as_array(ptrs[ci], shape=(int(np.prod(shape)),))
            coefs.append(arr.copy().reshape(shape))
            lib.vt_free(ptrs[ci])
        elif out[ci].shape != shape:
            return 7, None
        qtabs.append(np.array(qtab[ci * 64:(ci + 1) * 64], np.uint16))
        samp.append((samp_h[ci], samp_v[ci]))
    if out is not None:
        if len(out) != ncomp.value:
            return 7, None
        coefs = list(out)
    return 0, (coefs, qtabs, samp, (height.value, width.value))


def jpeg_coefficients_native(data, coef_limit: int = 0, out=None):
    """Entropy-decode a sequential or progressive JPEG to its quantised DCT
    coefficients (a progressive stream's scans accumulate into the same
    buffer, as libjpeg's ``jpeg_read_coefficients`` leaves them):
    ``(coefs, qtabs, samp, (H, W))`` as ``vision_tpu``'s
    ``jpeg_coefficients_native`` returns them. ``coefs[ci]`` is int16
    ``(blocks_h, blocks_w, M*M)`` in natural order (M = ``coef_limit`` in
    1..7, else 8: the top-left MxM of each block), ``qtabs[ci]`` the uint16
    ``(64,)`` table, ``samp[ci]`` ``(h_samp, v_samp)``. With ``out`` (one
    int16 array a component, of those shapes) the coefficients are written
    there. None for a stream the decoder does not read (arithmetic-coded,
    12-bit, CMYK), a corrupt one, or one of another geometry than ``out``;
    :func:`jpeg_coefficients_code` says which."""
    return jpeg_coefficients_code(data, coef_limit, out)[1]


def decode_jpeg_native(data, coef_limit: int = 0,
                       out: Optional[np.ndarray] = None) -> np.ndarray:
    """The whole decode on the host: ``(H', W', C)`` uint8, C = 1 for a
    grey stream and 3 (RGB) otherwise (a CMYK or YCCK stream converted as
    Pillow's ``convert("RGB")`` converts libjpeg's output), H' = ceil(H*M/8) (M as in
    :func:`jpeg_coefficients_native`); written into ``out`` where it is
    given, which must have that shape. Raises ``RuntimeError`` naming the
    stream's type where the decoder does not read it."""
    lib = _load()
    data = _bytes(data)
    if out is not None:
        h, w, c = ctypes.c_int(), ctypes.c_int(), ctypes.c_int()
        rc = lib.vt_decode_jpeg_to(data, len(data), coef_limit,
                                   _into(out, np.uint8), out.nbytes,
                                   ctypes.byref(h), ctypes.byref(w),
                                   ctypes.byref(c))
        if rc == 0 and out.shape != (h.value, w.value, c.value):
            rc = 7
        if rc != 0:
            raise RuntimeError(f"decode_jpeg: {stream_error(rc)}")
        return out
    img = _VtImage()
    rc = lib.vt_decode_jpeg(data, len(data), coef_limit, ctypes.byref(img))
    if rc != 0:
        raise RuntimeError(f"decode_jpeg: {stream_error(rc)}")
    n = img.height * img.width * img.channels
    arr = np.ctypeslib.as_array(img.data, shape=(n,)).copy()
    lib.vt_free(img.data)
    return arr.reshape(img.height, img.width, img.channels)


def encode_jpeg_native(img: np.ndarray, quality: int = 75) -> bytes:
    """Baseline JPEG of an ``(H, W)`` or ``(H, W, C)`` uint8 array, C 1 or
    3, with libjpeg's default tables and sampling at ``quality``."""
    lib = _load()
    img = np.ascontiguousarray(img, dtype=np.uint8)
    if img.ndim == 2:
        img = img[:, :, None]
    if img.ndim != 3 or img.shape[2] not in (1, 3):
        raise ValueError(f"encode_jpeg: 1 or 3 channels, got shape {img.shape}")
    h, w, c = img.shape
    buf = ctypes.POINTER(ctypes.c_uint8)()
    out_len = ctypes.c_size_t()
    rc = lib.vt_encode_jpeg(img.tobytes(), h, w, c, quality, ctypes.byref(buf),
                            ctypes.byref(out_len))
    if rc != 0:
        raise RuntimeError(f"encode_jpeg: codec error {rc} for shape {img.shape}")
    data = ctypes.string_at(buf, out_len.value)
    lib.vt_free(buf)
    return data
