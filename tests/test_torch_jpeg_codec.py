"""The port's JPEG codec (``vision_tpu_torch/csrc/jpeg_codec.cpp``, bound by
``vision_tpu_torch.io._codecs``) against libjpeg through the JAX package's
shim (``vision_tpu.io._codecs``), on the CPU.

Huffman decoding is lossless, so on one stream the port's quantised
coefficients, tables, sampling factors and size must equal what libjpeg's
``jpeg_read_coefficients`` gives, bit for bit. The port's host decode
follows the JAX device path's float arithmetic (float IDCT, bilinear
chroma), so against libjpeg's fixed-point decode it is held to the JAX
package's own bound (max 8, mean under 1: ``tests/test_jpeg_tpu.py``),
and against the port's torch ``decode_coefs`` on the same coefficients to
one count (the same float arithmetic, summed in another order).

The JAX shim builds itself when a test module calls ``has_native()`` at
collection, in place and in every xdist worker at once, so a worker can
find the library half-written and cache its absence. Each test that needs
the shim goes through ``jax_codecs``, which reloads the module once in that
case and fails if the shim is still missing.
"""

import importlib
import io
import threading

import numpy as np
import PIL.Image
import pytest
import torch

import vision_tpu.io._codecs as jcodecs
from vision_tpu.io import image as jimage
from vision_tpu_torch.io import _codecs, decode_jpeg, encode_jpeg
from vision_tpu_torch.io import jpeg_device


def jax_codecs():
    """``vision_tpu.io._codecs`` with its native shim loaded."""
    if not jcodecs.has_native():
        importlib.reload(jcodecs)
    if not jcodecs.has_native():
        pytest.fail("vision_tpu's native codec shim did not load")
    return jcodecs


def photo(h=120, w=160, seed=0):
    """``tests/test_jpeg_tpu.py``'s photo-like image (HWC uint8)."""
    rng = np.random.RandomState(seed)
    x, y = np.meshgrid(np.arange(w), np.arange(h))
    base = 128 + 60 * np.sin(x / 17.0) * np.cos(y / 23.0)
    img = base[..., None] + rng.randn(h, w, 3) * 18
    return np.clip(img, 0, 255).astype(np.uint8)


def pil_jpeg(img, **kw):
    buf = io.BytesIO()
    PIL.Image.fromarray(img).save(buf, "JPEG", **kw)
    return buf.getvalue()


def assert_same_coefficients(got, want):
    coefs, qtabs, samp, hw = got
    w_coefs, w_qtabs, w_samp, w_hw = want
    assert hw == w_hw
    assert samp == [tuple(s) for s in w_samp]
    assert len(coefs) == len(w_coefs)
    for a, b in zip(qtabs, w_qtabs):
        assert a.dtype == np.uint16
        np.testing.assert_array_equal(a, b)
    for a, b in zip(coefs, w_coefs):
        assert a.dtype == np.int16 and a.shape == b.shape
        np.testing.assert_array_equal(a, b)


def chw(x):
    return torch.from_numpy(np.ascontiguousarray(x)).permute(2, 0, 1)


# ------------------------------------------------------- entropy decoding


@pytest.mark.parametrize("quality", [50, 75, 95])
@pytest.mark.parametrize("subsampling", [0, 1, 2])  # 4:4:4, 4:2:2, 4:2:0
def test_coefficients_equal_libjpeg(subsampling, quality):
    data = pil_jpeg(photo(seed=subsampling), quality=quality,
                    subsampling=subsampling)
    assert_same_coefficients(_codecs.jpeg_coefficients_native(data),
                             jax_codecs().jpeg_coefficients_native(data))


@pytest.mark.parametrize("hw", [(121, 163), (7, 5), (17, 250)])
@pytest.mark.parametrize("subsampling", [0, 1, 2])
def test_coefficients_equal_libjpeg_at_odd_sizes(hw, subsampling):
    """Sizes off the block and MCU grid: the padded MCUs are decoded and
    dropped, as libjpeg's ``width_in_blocks`` counts them."""
    data = pil_jpeg(photo(*hw, seed=3), quality=80, subsampling=subsampling)
    assert_same_coefficients(_codecs.jpeg_coefficients_native(data),
                             jax_codecs().jpeg_coefficients_native(data))


@pytest.mark.parametrize("quality", [50, 95])
def test_coefficients_equal_libjpeg_grey(quality):
    data = pil_jpeg(photo()[..., 0], quality=quality)
    got = _codecs.jpeg_coefficients_native(data)
    assert len(got[0]) == 1 and got[2] == [(1, 1)]
    assert_same_coefficients(got, jax_codecs().jpeg_coefficients_native(data))


@pytest.mark.parametrize("restart", [{"restart_marker_blocks": 3},
                                     {"restart_marker_rows": 1}])
def test_coefficients_equal_libjpeg_with_restart_markers(restart):
    data = pil_jpeg(photo(121, 163, seed=4), quality=75, **restart)
    assert b"\xff\xdd" in data and b"\xff\xd0" in data  # DRI, RST0
    assert_same_coefficients(_codecs.jpeg_coefficients_native(data),
                             jax_codecs().jpeg_coefficients_native(data))


@pytest.mark.parametrize("m", range(1, 8))
def test_coefficients_equal_libjpeg_at_coef_limit(m):
    data = pil_jpeg(photo(121, 163, seed=5), quality=85, subsampling=2)
    got = _codecs.jpeg_coefficients_native(data, m)
    assert got[0][0].shape == (16, 21, m * m)
    assert_same_coefficients(got, jax_codecs().jpeg_coefficients_native(data, m))


def test_progressive_stream_is_refused():
    """Arithmetic coding is what the codec refuses now: a hand-made SOF9
    stream (a baseline stream's frame marker rewritten) gives code 2, the
    binding None, and ``decode_jpeg`` raises naming it. A progressive
    stream (SOF2), refused before, reads: its coefficients are libjpeg's."""
    base = pil_jpeg(photo(), quality=75)
    sof = base.index(b"\xff\xc0")
    arithmetic = base[:sof + 1] + b"\xc9" + base[sof + 2:]
    assert _codecs.jpeg_coefficients_native(arithmetic) is None
    assert _codecs.jpeg_coefficients_code(arithmetic)[0] == 2
    with pytest.raises(RuntimeError, match="arithmetic"):
        decode_jpeg(arithmetic, device="cpu")
    with pytest.raises(RuntimeError, match="arithmetic"):
        jpeg_device.decode_jpeg_batch_device([arithmetic], device="cpu")
    data = pil_jpeg(photo(), quality=75, progressive=True)
    assert _codecs.jpeg_coefficients_code(data)[0] == 0
    assert_same_coefficients(_codecs.jpeg_coefficients_native(data),
                             jax_codecs().jpeg_coefficients_native(data))
    assert decode_jpeg(data, device="cpu").shape == (3, 120, 160)


def test_truncated_and_corrupt_streams_fail_cleanly():
    """A stream cut short, or with its entropy-coded bytes overwritten, is
    refused with a code (or, where the damage keeps the stream valid,
    decoded): never a crash, never a read past its end."""
    data = pil_jpeg(photo(), quality=75)
    sos = data.index(b"\xff\xda")
    for cut in (0, 1, 2, 10, sos, sos + 20, len(data) // 2, len(data) - 40):
        assert _codecs.jpeg_coefficients_native(data[:cut]) is None, cut
        with pytest.raises(RuntimeError, match="corrupt or truncated"):
            decode_jpeg(data[:cut], device="cpu")
    # the EOI marker alone may go: every MCU is still there
    assert _codecs.jpeg_coefficients_native(data[:-2]) is not None
    rng = np.random.RandomState(0)
    for _ in range(40):
        bad = bytearray(data)
        at = rng.randint(sos + 14, len(data) - 2, size=4)
        bad[at[0]:at[0] + 4] = rng.randint(0, 256, 4).astype(np.uint8).tobytes()
        rc, out = _codecs.jpeg_coefficients_code(bytes(bad))
        assert (rc == 0) == (out is not None)
        assert rc in (0, -1)
    assert _codecs.jpeg_coefficients_code(b"not a jpeg at all")[0] == -1


def test_decode_into_the_callers_buffers():
    """``out=``: the same pixels and coefficients, written into the given
    arrays; a buffer of another size is refused."""
    data = pil_jpeg(photo(121, 163), quality=75, subsampling=2)
    want = _codecs.decode_jpeg_native(data)
    out = np.zeros_like(want)
    assert _codecs.decode_jpeg_native(data, out=out) is out
    np.testing.assert_array_equal(out, want)
    with pytest.raises(RuntimeError, match="another size"):
        _codecs.decode_jpeg_native(data, out=np.zeros((120, 163, 3), np.uint8))
    coefs = _codecs.jpeg_coefficients_native(data, 5)
    bufs = [np.zeros_like(c) for c in coefs[0]]
    got = _codecs.jpeg_coefficients_native(data, 5, out=bufs)
    assert got[0][0] is bufs[0]
    assert_same_coefficients(got, coefs)
    assert _codecs.jpeg_coefficients_code(data, 5, out=bufs[:1])[0] == 7


# ---------------------------------------------------------------- encoding


@pytest.mark.parametrize("quality", [10, 50, 75, 95, 100])
def test_encoder_tables_equal_libjpegs(quality):
    """libjpeg's defaults: its tables at that quality (IJG scaling of Annex
    K), 2x2 / 1x1 / 1x1 sampling."""
    img = photo(40, 56)
    mine = _codecs.jpeg_coefficients_native(encode_jpeg(chw(img), quality))
    theirs = jax_codecs().jpeg_coefficients_native(
        jimage.encode_jpeg(img, quality=quality))
    assert mine[2] == [(2, 2), (1, 1), (1, 1)] == [tuple(s) for s in theirs[2]]
    for a, b in zip(mine[1], theirs[1]):
        np.testing.assert_array_equal(a, b)


def smooth(h, w, seed):
    """A smooth colour image with mild noise: the error of a JPEG round
    trip there is the encoder's, not the noise's."""
    rng = np.random.RandomState(seed)
    x, y = np.meshgrid(np.arange(w), np.arange(h))
    base = 128 + 60 * np.sin(x / 17.0) * np.cos(y / 23.0)
    img = np.stack([base, 255 - base, base * 0.5 + 60], -1) + rng.randn(h, w, 3) * 3
    return np.clip(img, 0, 255).astype(np.uint8)


def psnr(a, b):
    return 10 * np.log10(255.0 ** 2 / ((a.astype(float) - b) ** 2).mean())


@pytest.mark.parametrize("quality", [50, 95])
@pytest.mark.parametrize("grey", [False, True])
def test_encoder_output_decodes_under_libjpeg_as_libjpegs_own(grey, quality):
    """libjpeg (the JAX package's ``decode_jpeg``) decodes the port's stream
    as close to the source as libjpeg's own encoding at that quality: PSNR
    within 0.1 dB, mean error within 0.25 (the two read 0.05 dB and 0.02
    apart at most; a wrong table, sampling or colour transform costs
    decibels)."""
    img = smooth(90, 130, seed=2)
    if grey:
        img = img[..., :1]
    mine = jimage.decode_jpeg(encode_jpeg(chw(img), quality)).astype(int)
    jax_codecs()
    theirs = jimage.decode_jpeg(jimage.encode_jpeg(img, quality=quality)).astype(int)
    assert mine.shape == theirs.shape == img.shape
    assert psnr(mine, img) >= psnr(theirs, img) - 0.1
    assert np.abs(mine - img).mean() <= np.abs(theirs - img).mean() + 0.25


@pytest.mark.parametrize("quality", [50, 90])
def test_encoder_output_reads_the_same_in_both_decoders(quality):
    data = encode_jpeg(chw(photo(75, 99, seed=1)), quality)
    assert data[:4] == b"\xff\xd8\xff\xe0" and data[6:11] == b"JFIF\x00"
    assert_same_coefficients(_codecs.jpeg_coefficients_native(data),
                             jax_codecs().jpeg_coefficients_native(data))


def test_encoder_refuses_other_layouts():
    with pytest.raises(ValueError, match="1 or 3"):
        encode_jpeg(torch.zeros(4, 8, 8, dtype=torch.uint8))
    with pytest.raises(TypeError, match="uint8"):
        encode_jpeg(torch.zeros(3, 8, 8))
    with pytest.raises(ValueError, match="quality"):
        encode_jpeg(torch.zeros(3, 8, 8, dtype=torch.uint8), 0)


# --------------------------------------------------------------- decoding


@pytest.mark.parametrize("subsampling", [0, 1, 2])
def test_host_decode_within_libjpegs_bound(subsampling):
    data = pil_jpeg(photo(121, 163, seed=6), quality=80, subsampling=subsampling)
    got = decode_jpeg(data, device="cpu")
    assert got.dtype == torch.uint8 and got.shape == (3, 121, 163)
    want = jax_codecs().decode_jpeg_native(data).astype(np.int32)
    d = np.abs(got.permute(1, 2, 0).numpy().astype(np.int32) - want)
    assert d.max() <= 8 and d.mean() < 1.0, (d.max(), d.mean())


def test_host_decode_grey_within_libjpegs_bound():
    data = pil_jpeg(photo()[..., 0], quality=80)
    got = decode_jpeg(data, device="cpu")
    assert got.shape == (1, 120, 160)
    want = jax_codecs().decode_jpeg_native(data)[..., 0].astype(np.int32)
    d = np.abs(got[0].numpy().astype(np.int32) - want)
    assert d.max() <= 2, d.max()


@pytest.mark.parametrize("m", [8, 5, 3])
@pytest.mark.parametrize("subsampling", [0, 1, 2])
def test_host_decode_against_torch_decode_coefs(subsampling, m):
    """The C++ host decode and the torch device path (run on the CPU) on
    the same coefficients: the same arithmetic, within one count."""
    data = pil_jpeg(photo(121, 163, seed=7), quality=75, subsampling=subsampling)
    coefs, qtabs, samp, (h, w) = _codecs.jpeg_coefficients_native(data, m)
    want = jpeg_device.decode_coefs(
        [torch.from_numpy(c) for c in coefs],
        [torch.from_numpy(q.astype(np.float32)) for q in qtabs], h, w, samp)
    got = decode_jpeg(data, device="cpu", scale=None if m == 8 else (m, 8))
    assert got.shape == want.shape == (3, -(-121 * m // 8), -(-163 * m // 8))
    assert int((got.int() - want.int()).abs().max()) <= 1


# ------------------------------------------------------------------ build


def test_codec_builds_atomically_from_concurrent_callers(tmp_path, monkeypatch):
    """Four threads build into an empty directory at once: each compiles
    into a file of its own and renames it into place, so the libraries that
    stand (the JPEG codec, and the PNG / GIF and WebP codecs ``build``
    makes beside it) are whole and load, and no temporary file is left."""
    monkeypatch.setattr(_codecs, "build_dir", lambda: tmp_path)
    errors = []

    def build():
        try:
            _codecs.build()
        except Exception as e:  # collected for the assertion below
            errors.append(e)

    threads = [threading.Thread(target=build) for _ in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=300)
    assert not any(t.is_alive() for t in threads) and not errors
    built = sorted(p.name for p in tmp_path.iterdir())
    assert built == sorted([_codecs._lib_path().name,
                            _codecs.lib_path(_codecs._IMAGE_SOURCE).name,
                            _codecs.lib_path(_codecs._WEBP_SOURCE).name])
    import ctypes

    assert ctypes.CDLL(str(_codecs._lib_path())).vt_decode_jpeg
    assert ctypes.CDLL(str(_codecs.lib_path(_codecs._IMAGE_SOURCE))).vt_png_decode
    assert ctypes.CDLL(str(_codecs.lib_path(_codecs._WEBP_SOURCE))).vt_decode_webp
