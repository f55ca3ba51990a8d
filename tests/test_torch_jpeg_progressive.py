"""Progressive and 4-component JPEG in the port's codec
(``vision_tpu_torch/csrc/jpeg_codec.cpp``) against libjpeg through
``vision_tpu``'s shim, on the CPU.

A progressive stream's scans (DC first and refinement, AC first with EOB
runs, AC refinement with correction bits, restart intervals in each)
accumulate into the coefficient buffer as libjpeg's
``jpeg_read_coefficients`` leaves it: the port's coefficients must equal
libjpeg's bit for bit, at every coefficient limit. The host decode of a
progressive stream is held to the JAX package's bound against libjpeg's
pixels (``tests/test_jpeg_tpu.py``: max 8, mean under 1) and to one count
against the port's torch decode of the same coefficients (the same float
arithmetic in another order).

A CMYK or YCCK stream decodes on the host only: ``vision_tpu``'s libjpeg
binding refuses it and its ``decode_jpeg`` falls back to Pillow's
``convert("RGB")``, which the port reproduces from its own float decode
of the four planes. Bound: 3 levels, mean under 0.1 (measured here: 2 and
0.02; the float IDCT lies a level from libjpeg's integer one, which
Pillow's conversion carries through).
"""

import io

import numpy as np
import PIL.Image
import pytest
import torch

from vision_tpu.io import image as jimage
from vision_tpu_torch.io import _codecs, decode_jpeg, jpeg_device
from test_torch_jpeg_codec import assert_same_coefficients, jax_codecs, photo

# name -> Pillow's save arguments
STREAMS = {
    "420": dict(subsampling=2),
    "422": dict(subsampling=1),
    "444": dict(subsampling=0),
    "grey": dict(grey=True),
    "restart_rows": dict(subsampling=2, restart_marker_rows=1),
    "restart_blocks": dict(subsampling=0, restart_marker_blocks=5),
    "optimize": dict(subsampling=2, optimize=True),
    "optimize_q95": dict(subsampling=0, optimize=True, quality=95),
}


def progressive(name, h=121, w=163, seed=0):
    kw = dict(STREAMS[name])
    img = photo(h, w, seed=seed)
    if kw.pop("grey", False):
        img = img[..., 0]
    kw.setdefault("quality", 75)
    buf = io.BytesIO()
    PIL.Image.fromarray(img).save(buf, "JPEG", progressive=True, **kw)
    data = buf.getvalue()
    assert b"\xff\xc2" in data[:data.index(b"\xff\xda")]
    return data


@pytest.mark.parametrize("name", sorted(STREAMS))
@pytest.mark.parametrize("hw", [(121, 163), (17, 9), (64, 48)])
def test_progressive_coefficients_equal_libjpeg(name, hw):
    data = progressive(name, *hw, seed=hw[0])
    assert_same_coefficients(_codecs.jpeg_coefficients_native(data),
                             jax_codecs().jpeg_coefficients_native(data))


@pytest.mark.parametrize("m", range(1, 8))
def test_progressive_coefficients_equal_libjpeg_at_coef_limit(m):
    for name in ("420", "restart_rows"):
        data = progressive(name, seed=m)
        got = _codecs.jpeg_coefficients_native(data, m)
        assert got[0][0].shape == (16, 21, m * m)
        assert_same_coefficients(got, jax_codecs().jpeg_coefficients_native(data, m))


@pytest.mark.parametrize("name", ["420", "444", "grey", "restart_rows", "optimize"])
def test_progressive_host_decode_against_libjpeg_and_the_torch_decode(name):
    data = progressive(name, 375, 500, seed=3)
    got = decode_jpeg(data, device="cpu")
    want = torch.from_numpy(jimage.decode_jpeg(data)).permute(2, 0, 1)
    diff = (got.int() - want.int()).abs()
    assert got.shape == want.shape
    assert int(diff.max()) <= 8 and float(diff.float().mean()) < 1.0
    coefs, qtabs, samp, (h, w) = _codecs.jpeg_coefficients_native(data)
    dev = jpeg_device.decode_coefs(
        [torch.from_numpy(c) for c in coefs],
        [torch.from_numpy(q.astype(np.float32)) for q in qtabs], h, w, samp)
    host = got.expand(3, -1, -1) if got.shape[0] == 1 else got
    assert int((host.int() - dev.int()).abs().max()) <= 1


def test_progressive_streams_group_and_batch_like_baseline_ones():
    """A list of progressive and sequential streams of one frame is one
    batch, on the host and through the device path (run on the CPU)."""
    prog = progressive("420", 120, 160, seed=1)
    base = PIL.Image.fromarray(photo(seed=2))
    buf = io.BytesIO()
    base.save(buf, "JPEG", quality=75, subsampling=2)
    streams = [prog, buf.getvalue(), prog]
    assert jpeg_device.group_by_frame(streams) == [[0, 1, 2]]
    host = decode_jpeg(streams, device="cpu")
    dev = jpeg_device.decode_jpeg_batch_device(streams, device="cpu")
    for h, d in zip(host, dev):
        assert int((h.int() - d.int()).abs().max()) <= 1


def test_truncated_and_corrupt_progressive_streams_return_minus_one():
    """Cut anywhere before its EOI (between two scans too: no count of
    scans says when a progressive stream is whole), or with bytes of its
    scans overwritten where that breaks them, the stream gives -1; never a
    crash."""
    data = progressive("restart_rows", seed=9)
    for cut in list(range(0, len(data) - 1, 97)) + [len(data) - 2]:
        assert _codecs.jpeg_coefficients_code(data[:cut])[0] == -1, cut
    with pytest.raises(RuntimeError, match="corrupt or truncated"):
        decode_jpeg(data[:len(data) // 2], device="cpu")
    rng = np.random.RandomState(0)
    sos = data.index(b"\xff\xda")
    for _ in range(20):
        bad = bytearray(data)
        for at in rng.randint(sos + 20, len(data) - 2, size=8):
            bad[at] = 0xFF
        assert _codecs.jpeg_coefficients_code(bytes(bad))[0] in (0, -1)


def test_other_frame_types_keep_their_codes():
    base = progressive("420")
    sof = base.index(b"\xff\xc2")
    for marker, code in ((0xCA, 2), (0xC6, 3), (0xC3, 3)):
        assert _codecs.jpeg_coefficients_code(
            base[:sof + 1] + bytes([marker]) + base[sof + 2:])[0] == code
    twelve = bytearray(base)
    twelve[sof + 4] = 12
    assert _codecs.jpeg_coefficients_code(bytes(twelve))[0] == 4


# ------------------------------------------------------------- CMYK / YCCK

def cmyk_jpeg(h=121, w=163, seed=0, progressive_=False, quality=90):
    rng = np.random.RandomState(seed)
    x, y = np.meshgrid(np.arange(w), np.arange(h))
    base = 128 + 70 * np.sin(x / 11.0) * np.cos(y / 17.0)
    img = np.clip(base[..., None] + np.array([-40, 0, 30, -60]) + rng.randn(h, w, 4) * 10,
                  0, 255).astype(np.uint8)
    buf = io.BytesIO()
    PIL.Image.frombytes("CMYK", (w, h), img.tobytes()).save(
        buf, "JPEG", quality=quality, progressive=progressive_)
    return buf.getvalue()


@pytest.mark.parametrize("progressive_", [False, True])
@pytest.mark.parametrize("quality", [75, 95])
def test_cmyk_host_decode_matches_jax_within_the_bound(progressive_, quality):
    data = cmyk_jpeg(seed=quality, progressive_=progressive_, quality=quality)
    assert jax_codecs().jpeg_coefficients_native(data) is None  # libjpeg refuses
    got = decode_jpeg(data, device="cpu").permute(1, 2, 0).numpy().astype(int)
    want = jimage.decode_jpeg(data).astype(int)  # Pillow's convert("RGB")
    assert got.shape == want.shape == (121, 163, 3)
    diff = np.abs(got - want)
    assert diff.max() <= 3 and diff.mean() < 0.1


def test_ycck_host_decode_matches_pillow_within_the_bound():
    """The APP14 transform flag 2 makes the first three planes YCbCr of the
    inverted CMY: libjpeg converts them (Pillow then inverts), and so does
    the port."""
    data = bytearray(cmyk_jpeg(seed=4))
    at = data.index(b"Adobe")
    assert data[at + 11] == 0
    data[at + 11] = 2
    data = bytes(data)
    got = decode_jpeg(data, device="cpu").permute(1, 2, 0).numpy().astype(int)
    want = np.asarray(PIL.Image.open(io.BytesIO(data)).convert("RGB")).astype(int)
    diff = np.abs(got - want)
    assert diff.max() <= 3 and diff.mean() < 0.5


def test_cmyk_coefficients_are_refused_and_the_card_path_raises():
    data = cmyk_jpeg()
    assert _codecs.jpeg_coefficients_code(data)[0] == 5
    assert _codecs.jpeg_frame(data) == ((121, 163), [(1, 1)] * 4)
    with pytest.raises(RuntimeError, match="4 components|CMYK"):
        jpeg_device.decode_jpeg_batch_device([data], device="cpu")
    assert decode_jpeg([data, data], device="cpu")[1].shape == (3, 121, 163)
