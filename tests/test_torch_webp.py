"""WebP in the port's decoder (``vision_tpu_torch/csrc/webp_codec.cpp``,
no library) against ``vision_tpu``'s ``decode_webp`` (libwebp's
``WebPDecodeRGBA``, and Pillow for an animation), on the CPU, byte for
byte.

Every committed WebP fixture (lossy at three qualities and odd sizes, the
simple filter over four token partitions, one and four segments, lossless
photographs, palettes with pixel bundling and the colour cache, lossy
with an alpha plane raw and VP8L-compressed under each filter, a VP8X file
with ICC and EXIF chunks, a two-frame animation) in every read mode and
through ``decode_image`` / ``read_image``; seeded Pillow streams at odd
sizes and qualities; broken streams, which ``vision_tpu`` refuses too,
raise ``RuntimeError`` naming WebP. The card's copy of a decode is checked
in ``test_torch_small_data_cuda.py``.
"""

import io
import struct

import numpy as np
import PIL.Image
import pytest
import torch

from vision_tpu.io import image as jimage
from vision_tpu_torch.io import (
    ImageReadMode,
    _image_codecs,
    decode_image,
    decode_webp,
    read_image,
)
from torch_io_fixtures import DATA, load_manifest, photo, riff_chunks, soft_alpha

WEBPS = sorted(n for n, e in load_manifest().items() if e["kind"] == "webp")
MODES = {ImageReadMode.UNCHANGED: jimage.ImageReadMode.UNCHANGED,
         ImageReadMode.GRAY: jimage.ImageReadMode.GRAY,
         ImageReadMode.GRAY_ALPHA: jimage.ImageReadMode.GRAY_ALPHA,
         ImageReadMode.RGB: jimage.ImageReadMode.RGB,
         ImageReadMode.RGB_ALPHA: jimage.ImageReadMode.RGB_ALPHA}


def hwc(t: torch.Tensor) -> np.ndarray:
    return t.permute(1, 2, 0).numpy()


def assert_equal_to_jax(data: bytes) -> None:
    for mode, jmode in MODES.items():
        np.testing.assert_array_equal(hwc(decode_webp(data, mode, device="cpu")),
                                      jimage.decode_webp(data, jmode), err_msg=str(mode))


@pytest.mark.parametrize("name", WEBPS)
def test_every_fixture_equals_vision_tpu_in_every_mode(name, tmp_path):
    data = (DATA / name).read_bytes()
    assert_equal_to_jax(data)
    want = jimage.decode_webp(data, jimage.ImageReadMode.RGB)
    np.testing.assert_array_equal(
        hwc(decode_image(data, ImageReadMode.RGB, device="cpu")), want)
    path = tmp_path / name
    path.write_bytes(data)
    np.testing.assert_array_equal(hwc(read_image(path, device="cpu")),
                                  jimage.read_image(str(path)))


def pillow_webp(img: np.ndarray, **kw) -> bytes:
    buf = io.BytesIO()
    PIL.Image.fromarray(img).save(buf, "WEBP", **kw)
    return buf.getvalue()


SEEDED = [(k, kind) for k in range(8) for kind in ("lossy", "lossless", "alpha")]


@pytest.mark.parametrize("k,kind", SEEDED)
def test_seeded_pillow_streams_equal_vision_tpu(k, kind):
    """Odd sizes (1 to 99 pixels a side) and qualities drawn from a seed."""
    rng = np.random.RandomState(1000 * k + len(kind))
    h, w = (int(v) for v in rng.randint(1, 100, 2))
    img = photo(h, w, seed=k, channels=4 if kind == "alpha" else 3)
    if kind == "alpha":
        img[..., 3] = soft_alpha(h, w)
    kw = {"lossy": dict(quality=int(rng.randint(0, 101)), method=int(rng.randint(0, 7))),
          "lossless": dict(lossless=True, quality=int(rng.randint(0, 101)),
                           method=int(rng.randint(0, 7))),
          "alpha": dict(quality=int(rng.randint(0, 101)),
                        alpha_quality=int(rng.randint(0, 101)))}[kind]
    data = pillow_webp(img, **kw)
    got = _image_codecs.decode_webp_native(data)
    np.testing.assert_array_equal(got, jimage.decode_webp(data))
    assert got.shape == (h, w, 4)


def test_an_animation_without_the_alpha_flag_reads_as_rgb():
    """Pillow gives an animation RGB where its VP8X header has no alpha
    flag: the canvas around the first frame black, the frame's alpha
    dropped."""
    data = bytearray((DATA / "webp_anim.webp").read_bytes())
    assert data[12:16] == b"VP8X" and data[20] & 0x10
    data[20] &= ~0x10
    data = bytes(data)
    want = jimage.decode_webp(data)
    assert want.shape == (48, 64, 3)
    np.testing.assert_array_equal(_image_codecs.decode_webp_native(data), want)
    assert_equal_to_jax(data)


@pytest.mark.parametrize("name", ["webp_lossy_q75_odd.webp", "webp_lossless_photo.webp"])
def test_a_bitstream_without_its_container_reads_as_libwebp_reads_it(name):
    """libwebp (and so ``vision_tpu``'s ``decode_webp``) also takes a bare
    VP8 or VP8L bitstream, the image chunk's payload alone."""
    payload = [c for c in riff_chunks((DATA / name).read_bytes())
               if c[0] in (b"VP8 ", b"VP8L")][0][1]
    assert_equal_to_jax(payload)


def broken_streams():
    lossy = (DATA / "webp_lossy_q75_odd.webp").read_bytes()
    lossless = (DATA / "webp_lossless_photo.webp").read_bytes()
    alpha = (DATA / "webp_alpha_vp8l_gradient.webp").read_bytes()
    vp8l_at = lossless.index(b"VP8L") + 8
    alph_at = alpha.index(b"ALPH") + 8
    vp8_at = lossy.index(b"VP8 ") + 8

    def poke(data, at, value):
        out = bytearray(data)
        out[at] = value
        return bytes(out)

    return {
        "riff_size_zero": b"RIFF\x00\x00\x00\x00WEBPVP8 " + bytes(20),
        "truncated_lossy": lossy[:len(lossy) // 2],
        "truncated_lossless": lossless[:len(lossless) - 40],
        "truncated_alpha": alpha[:alph_at + 30],
        "no_start_code": poke(lossy, vp8_at + 3, 0x00),
        "not_a_key_frame": poke(lossy, vp8_at, lossy[vp8_at] | 1),
        "vp8l_signature": poke(lossless, vp8l_at, 0x2e),
        "vp8l_version": poke(lossless, vp8l_at + 4, lossless[vp8l_at + 4] | 0x20),
        "alph_reserved_bits": poke(alpha, alph_at, alpha[alph_at] | 0xC0),
        "vp8x_canvas_size": poke(alpha, 24, alpha[24] ^ 0x01),
        "chunk_past_riff": alpha[:4] + struct.pack("<I", 30) + alpha[8:],
    }


BROKEN = broken_streams()


@pytest.mark.parametrize("name", sorted(BROKEN))
def test_broken_streams_raise_as_vision_tpu_does(name):
    data = BROKEN[name]
    with pytest.raises(Exception):
        jimage.decode_webp(data)
    with pytest.raises(RuntimeError, match="decode_webp: "):
        decode_webp(data, device="cpu")
    with pytest.raises(RuntimeError, match="decode_webp: "):
        decode_image(data, device="cpu")


def test_the_fixtures_cover_the_formats_features():
    """The streams hold what their names say (read from the chunks)."""
    chunks = {n: dict(riff_chunks((DATA / n).read_bytes())) for n in WEBPS}
    assert b"VP8L" in chunks["webp_lossless_palette.webp"]
    assert b"ICCP" in chunks["webp_vp8x_icc_exif.webp"]
    assert b"EXIF" in chunks["webp_vp8x_icc_exif.webp"]
    assert b"ANMF" in chunks["webp_anim.webp"]
    for f, method in enumerate(("none", "horizontal", "vertical", "gradient")):
        for kind, compressed in (("raw", 0), ("vp8l", 1)):
            alph = chunks[f"webp_alpha_{kind}_{method}.webp"][b"ALPH"]
            assert alph[0] == compressed | (f << 2)
    vp8 = chunks["webp_simple_4parts.webp"][b"VP8 "]
    assert vp8[0] & 1 == 0  # a key frame


def test_entry_points_default_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    data = (DATA / "webp_lossy_q5.webp").read_bytes()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        decode_webp(data)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        decode_image(data)

