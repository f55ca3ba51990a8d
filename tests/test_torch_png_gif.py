"""PNG and GIF in the port's codec (``vision_tpu_torch/csrc/image_codecs.cpp``
and ``io/_image_codecs.py``) against ``vision_tpu``'s (libpng, and its
clean-room GIF decoder), on the CPU, element for element (WebP has its own
file, ``test_torch_webp.py``; its fixtures' digests are checked here with
the others').

Every colour type and bit depth, every filter type, ``tRNS`` of each kind
and the read modes are held to ``vision_tpu``'s ``decode_png``; 16-bit
streams to its ``decode_png16``. Adam7 streams are the exception:
``vision_tpu``'s reader reads them without libpng's interlace handling
and gives other pixels (a fault recorded in ``ROADMAP.md``, pinned here),
so the port is held to Pillow and to the source array there. The
committed fixtures' digests (``tests/torch_io_data/manifest.json``, made
by ``tests/torch_io_fixtures.py``) must match the port's decodes.
"""

import hashlib
import importlib
import io
import struct
import zlib

import numpy as np
import PIL.Image
import pytest
import torch

import vision_tpu.io._codecs as jcodecs
from vision_tpu.io import image as jimage
from vision_tpu_torch.io import (
    ImageReadMode,
    _codecs,
    _image_codecs,
    decode_gif,
    decode_image,
    decode_png,
    decode_png16,
    decode_webp,
    encode_png,
    image,
    read_image,
    write_png,
)
from torch_io_fixtures import DATA, load_manifest, png_stream


def jax_codecs():
    """``vision_tpu.io._codecs`` with its native shim loaded (see
    ``tests/test_torch_jpeg_codec.py``: it may be half-built in a worker)."""
    if not jcodecs.has_native():
        importlib.reload(jcodecs)
    if not jcodecs.has_native():
        pytest.fail("vision_tpu's native codec shim did not load")
    return jcodecs


def samples_of(color_type, depth, h=23, w=29, seed=0):
    """Raw sample values of an image of that type and depth, ``(H, W, C)``."""
    c = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}[color_type]
    rng = np.random.RandomState(seed + 16 * color_type + depth)
    top = (1 << depth) - 1
    if color_type == 3:
        top = min(top, 11)  # indices of a 12-entry palette, and a few past it
    return rng.randint(0, top + 1, (h, w, c)).astype(np.uint16)


PALETTE = bytes(np.random.RandomState(5).randint(0, 256, 3 * 10, np.uint8))
TYPES = [(0, 1), (0, 2), (0, 4), (0, 8), (0, 16), (2, 8), (2, 16), (3, 1),
         (3, 2), (3, 4), (3, 8), (4, 8), (4, 16), (6, 8), (6, 16)]


def stream(color_type, depth, filters=(0, 1, 2, 3, 4), interlace=False,
           trns=None, seed=0, h=23, w=29):
    return png_stream(samples_of(color_type, depth, h, w, seed), color_type, depth,
                      filters, interlace,
                      plte=PALETTE if color_type == 3 else None, trns=trns)


def port_hwc(data, **kw):
    return decode_png(data, device="cpu", **kw).permute(1, 2, 0).numpy()


@pytest.mark.parametrize("color_type,depth", TYPES)
def test_every_colour_type_and_depth_equals_libpng(color_type, depth):
    """Palette indices past the 10-entry palette read black, as libpng
    pads the palette."""
    data = stream(color_type, depth)
    want = jax_codecs().decode_png_native(data)
    got = _image_codecs.decode_png_native(data)
    assert got.dtype == np.uint8 and got.shape == want.shape
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(port_hwc(data), want)


@pytest.mark.parametrize("f", range(5))
@pytest.mark.parametrize("color_type,depth", [(2, 8), (0, 1), (6, 16), (4, 8)])
def test_each_filter_type_equals_libpng(f, color_type, depth):
    data = stream(color_type, depth, filters=(f,), seed=f)
    np.testing.assert_array_equal(_image_codecs.decode_png_native(data),
                                  jax_codecs().decode_png_native(data))


TRNS = {
    "grey1": (0, 1, struct.pack(">H", 1)),
    "grey2": (0, 2, struct.pack(">H", 2)),
    "grey8": (0, 8, struct.pack(">H", 77)),
    "grey16": (0, 16, struct.pack(">H", 12345)),
    "rgb8": (2, 8, struct.pack(">HHH", 3, 200, 17)),
    "rgb16": (2, 16, struct.pack(">HHH", 300, 2000, 17)),
    "palette": (3, 4, bytes([0, 90, 255, 12])),
    "palette8_full": (3, 8, bytes([0, 5, *range(30, 38)])),
}


@pytest.mark.parametrize("name", sorted(TRNS))
def test_trns_becomes_alpha_as_libpng_makes_it(name):
    color_type, depth, trns = TRNS[name]
    samples = samples_of(color_type, depth, seed=3)
    if color_type != 3:  # make the key colour occur
        key = np.frombuffer(trns, ">u2").astype(np.uint16)
        samples[::3, ::2] = key
    data = png_stream(samples, color_type, depth, (0, 1, 4),
                      plte=PALETTE if color_type == 3 else None, trns=trns)
    want = jax_codecs().decode_png_native(data)
    got = _image_codecs.decode_png_native(data)
    assert got.shape[2] == want.shape[2] == (4 if color_type in (2, 3) else 2)
    np.testing.assert_array_equal(got, want)
    assert (got[..., -1] == 0).any() and (got[..., -1] == 255).any()


@pytest.mark.parametrize("color_type,trns", [(0, None), (2, None), (4, None), (6, None),
                                             (0, struct.pack(">H", 9)),
                                             (2, struct.pack(">HHH", 1, 2, 3))])
def test_decode_png16_equals_libpng(color_type, trns):
    samples = samples_of(color_type, 16, seed=7)
    if trns is not None:
        samples[1::4, ::3] = np.frombuffer(trns, ">u2")
    data = png_stream(samples, color_type, 16, (0, 2, 4), trns=trns)
    want = jax_codecs().decode_png16_native(data)
    got = decode_png16(data, device="cpu")
    assert got.dtype == torch.uint16
    np.testing.assert_array_equal(got.permute(1, 2, 0).numpy(), want)
    with pytest.raises(RuntimeError, match="16-bit"):
        decode_png16(stream(2, 8), device="cpu")


@pytest.mark.parametrize("color_type,depth", [(2, 8), (0, 1), (0, 4), (3, 2), (6, 16),
                                              (4, 8)])
@pytest.mark.parametrize("hw", [(37, 53), (1, 1), (3, 9), (9, 2)])
def test_adam7_equals_pillow_and_the_source(color_type, depth, hw):
    """Every pass (empty ones of a small image included) lands in place:
    the port equals the non-interlaced stream's decode of the same samples,
    and Pillow's decode of the interlaced one where Pillow reads that
    type."""
    samples = samples_of(color_type, depth, *hw, seed=11)
    plte = PALETTE + bytes(3 * 6) if color_type == 3 else None
    inter = png_stream(samples, color_type, depth, (0, 1, 2, 3, 4), True, plte=plte)
    flat = png_stream(samples, color_type, depth, (0,), False, plte=plte)
    got = _image_codecs.decode_png_native(inter)
    np.testing.assert_array_equal(got, _image_codecs.decode_png_native(flat))
    np.testing.assert_array_equal(got, jax_codecs().decode_png_native(flat))
    if (color_type, depth) in ((2, 8), (4, 8)):
        want = np.asarray(PIL.Image.open(io.BytesIO(inter)))
        np.testing.assert_array_equal(got.reshape(want.shape), want)
        np.testing.assert_array_equal(got, samples.astype(np.uint8))


def voc_palette():
    """VOC's 256-entry colour map (``bitget`` of each index's bits)."""
    cmap = []
    for i in range(256):
        r = g = b = 0
        c = i
        for j in range(8):
            r |= ((c >> 0) & 1) << (7 - j)
            g |= ((c >> 1) & 1) << (7 - j)
            b |= ((c >> 2) & 1) << (7 - j)
            c >>= 3
        cmap += [r, g, b]
    return cmap


@pytest.mark.parametrize("hw,interlace", [((37, 53), False), ((375, 500), False),
                                          ((41, 29), True)])
def test_voc_palette_masks_read_as_pillows_indices(hw, interlace, tmp_path):
    """The private palette-index read (``decode_png_indices_native``) of
    VOC-style class masks, written by Pillow in mode ``"P"`` with VOC's
    colour map: classes 0-20 in blobs and index 255 on their borders, equal
    to ``np.asarray(PIL.Image.open(...))``; the public ``decode_png``
    expands the same file to the colour map's RGB."""
    h, w = hw
    rng = np.random.RandomState(h + w)
    mask = np.zeros((h, w), np.uint8)
    yy, xx = np.mgrid[:h, :w]
    for c in rng.randint(1, 21, 6):
        cy, cx, r = rng.randint(0, h), rng.randint(0, w), rng.randint(3, max(h, w) // 3)
        d = np.hypot(yy - cy, xx - cx)
        mask[d < r] = c
        mask[(d >= r) & (d < r + 2)] = 255
    img = PIL.Image.fromarray(mask, mode="P")
    img.putpalette(voc_palette())
    path = tmp_path / "mask.png"
    img.save(path, interlace=interlace)
    data = path.read_bytes()
    want = np.asarray(PIL.Image.open(path))
    assert want.dtype == np.uint8 and (want == 255).any()
    np.testing.assert_array_equal(_image_codecs.decode_png_indices_native(data), want)
    rgb = np.asarray(PIL.Image.open(path).convert("RGB"))
    np.testing.assert_array_equal(
        decode_png(data, device="cpu").permute(1, 2, 0).numpy(), rgb)
    grey = png_stream(mask[..., None], 0, 8)
    np.testing.assert_array_equal(_image_codecs.decode_png_indices_native(grey), mask)
    with pytest.raises(RuntimeError, match="palette or 8-bit grey"):
        _image_codecs.decode_png_indices_native(png_stream(samples_of(2, 8), 2, 8))


def test_jax_decode_png_reads_adam7_wrongly():
    """``vision_tpu``'s libpng reader calls ``png_read_row`` over the rows
    without ``png_set_interlace_handling`` (``image_codecs.cpp:313-315``):
    on a 37x53 RGB stream (filter 0) it gives pixels of the
    right shape that are not the image's. The port reads it right."""
    src = samples_of(2, 8, 37, 53, seed=1).astype(np.uint8)
    data = png_stream(src, 2, 8, (0,), interlace=True)
    pillow = np.asarray(PIL.Image.open(io.BytesIO(data)))
    np.testing.assert_array_equal(pillow, src)
    jax = jimage.decode_png(data)
    assert jax.shape == src.shape and not (jax == src).all()
    np.testing.assert_array_equal(port_hwc(data), src)


@pytest.mark.parametrize("mode", list(ImageReadMode))
@pytest.mark.parametrize("color_type", [0, 4, 2, 6, 3])
def test_read_modes_equal_jax(mode, color_type):
    data = stream(color_type, 8, seed=2)
    want = jimage.decode_png(data, mode=jimage.ImageReadMode[mode.name])
    np.testing.assert_array_equal(port_hwc(data, mode=mode), want)


def exif_png(data: bytes, orientation: int) -> bytes:
    """``data`` with an eXIf chunk (little-endian TIFF) after IHDR."""
    tiff = (b"II*\x00" + struct.pack("<I", 8) + struct.pack("<H", 1)
            + struct.pack("<HHIHH", 0x0112, 3, 1, orientation, 0) + bytes(4))
    chunk = (struct.pack(">I", len(tiff)) + b"eXIf" + tiff
             + struct.pack(">I", zlib.crc32(b"eXIf" + tiff)))
    at = 8 + 25  # signature and IHDR
    return data[:at] + chunk + data[at:]


@pytest.mark.parametrize("orientation", range(1, 9))
def test_exif_orientation_of_png_equals_jax(orientation):
    data = exif_png(stream(2, 8, seed=orientation), orientation)
    want = jimage.decode_png(data, apply_exif_orientation=True)
    np.testing.assert_array_equal(port_hwc(data, apply_exif_orientation=True), want)
    got = read_image_bytes(data, apply_exif_orientation=True)
    np.testing.assert_array_equal(got.permute(1, 2, 0).numpy(), want)


def read_image_bytes(data, **kw):
    return decode_image(data, device="cpu", **kw)


def animated_gif(interlace=False, frames=4):
    rng = np.random.RandomState(1)
    imgs = []
    for k in range(frames):
        a = rng.randint(0, 256, (30, 44, 3), np.uint8)
        a[4:15, 3 + 6 * k:20 + 6 * k] = (255, 0, 0)
        imgs.append(PIL.Image.fromarray(a).quantize(24))
    buf = io.BytesIO()
    if frames == 1:
        imgs[0].save(buf, "GIF", interlace=interlace)
    else:
        imgs[0].save(buf, "GIF", save_all=True, append_images=imgs[1:],
                     disposal=[0, 2, 3, 1][:frames], transparency=3,
                     duration=30, loop=0, interlace=interlace)
    return buf.getvalue()


@pytest.mark.parametrize("interlace", [False, True])
@pytest.mark.parametrize("frames", [1, 4])
def test_gif_equals_jax(interlace, frames):
    data = animated_gif(interlace, frames)
    want = jimage.decode_gif(data)
    got = decode_gif(data, device="cpu")
    assert got.shape == ((3, 30, 44) if frames == 1 else (4, 3, 30, 44))
    np.testing.assert_array_equal(got.movedim(-3, -1).numpy(), want)
    np.testing.assert_array_equal(
        _image_codecs.decode_gif_native(data), jax_codecs().decode_gif_native(data))
    one = decode_image(data, ImageReadMode.GRAY, device="cpu")
    assert one.shape == ((1, 30, 44) if frames == 1 else (4, 3, 30, 44))


@pytest.mark.parametrize("channels", [1, 2, 3, 4])
@pytest.mark.parametrize("level", [0, 6, 9])
def test_encode_png_round_trips_through_jax(channels, level, tmp_path):
    rng = np.random.RandomState(channels)
    x, y = np.meshgrid(np.arange(41), np.arange(31))
    img = (np.sin(x / 5.0)[..., None] * 90 + y[..., None] * 3
           + rng.randint(0, 20, (31, 41, channels))).astype(np.uint8)
    t = torch.from_numpy(img).permute(2, 0, 1)
    data = encode_png(t, compression_level=level)
    np.testing.assert_array_equal(jimage.decode_png(data), img)
    np.testing.assert_array_equal(port_hwc(data), img)
    path = tmp_path / "x.png"
    write_png(t, path, level)
    assert torch.equal(read_image(path, device="cpu"), t)
    if channels == 1:
        assert torch.equal(decode_png(encode_png(t[0]), device="cpu"), t)


def test_broken_streams_raise():
    data = stream(2, 8)
    bad_crc = bytearray(data)
    bad_crc[8 + 8 + 5] ^= 1  # inside IHDR: a critical chunk
    with pytest.raises(RuntimeError, match="CRC"):
        decode_png(bytes(bad_crc), device="cpu")
    # an ancillary chunk with a bad CRC is skipped, as libpng does
    tiff = exif_png(data, 6)
    skipped = bytearray(tiff)
    skipped[8 + 25 + 8] ^= 0xFF
    np.testing.assert_array_equal(port_hwc(bytes(skipped), apply_exif_orientation=True),
                                  port_hwc(data))
    idat = data.index(b"IDAT")
    n = struct.unpack(">I", data[idat - 4:idat])[0]
    with pytest.raises(RuntimeError, match="corrupt or truncated|inflate|cut short"):
        decode_png(data[:idat + 4 + n // 2], device="cpu")
    short = png_stream(samples_of(2, 8)[:10], 2, 8)
    ihdr_h = bytearray(short)
    ihdr_h[8 + 8 + 4:8 + 8 + 8] = struct.pack(">I", 23)
    ihdr_h[8 + 8 + 13:8 + 8 + 17] = struct.pack(">I", zlib.crc32(bytes(ihdr_h[12:29])))
    with pytest.raises(RuntimeError, match="corrupt or truncated"):
        decode_png(bytes(ihdr_h), device="cpu")
    with pytest.raises(RuntimeError, match="decode_gif"):
        decode_gif(b"GIF89a" + bytes(7), device="cpu")
    with pytest.raises(RuntimeError, match="decode_webp: a RIFF size too small"):
        decode_webp(b"RIFF\x00\x00\x00\x00WEBPVP8 " + bytes(20), device="cpu")


def test_entry_points_default_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for fn, data in ((decode_png, stream(2, 8)), (decode_gif, animated_gif()),
                     (decode_png16, stream(0, 16))):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            fn(data)


# ------------------------------------------------------------ the fixtures

MANIFEST = load_manifest()


def sha256(arr) -> str:
    return hashlib.sha256(np.ascontiguousarray(arr).tobytes()).hexdigest()


@pytest.mark.parametrize("name", sorted(MANIFEST))
def test_fixture_digests_match_the_ports_decodes(name):
    want = MANIFEST[name]
    data = (DATA / name).read_bytes()
    assert len(data) == want["bytes"]
    if want["kind"] == "jpeg":
        px = _codecs.decode_jpeg_native(data)
        for m in (8, 5):
            if f"coefs_sha256_m{m}" in want:
                coefs = _codecs.jpeg_coefficients_native(data, m % 8)[0]
                h = hashlib.sha256()
                for c in coefs:
                    h.update(np.ascontiguousarray(c).tobytes())
                assert h.hexdigest() == want[f"coefs_sha256_m{m}"]
    elif want["kind"] == "png":
        px = _image_codecs.decode_png_native(data)
        if "pixels16_sha256" in want:
            assert sha256(_image_codecs.decode_png_native(data, wide=True)) == \
                want["pixels16_sha256"]
    elif want["kind"] == "webp":
        px = _image_codecs.decode_webp_native(data)
    else:
        px = _image_codecs.decode_gif_native(data)
    assert list(px.shape) == want["shape"]
    assert sha256(px) == want["pixels_sha256"]


def test_the_fixtures_stay_small():
    assert sum(p.stat().st_size for p in DATA.iterdir()) < 1_500_000


def test_image_module_names_the_new_entry_points():
    for name in ("decode_png", "decode_png16", "decode_gif", "decode_webp",
                 "encode_png", "write_png"):
        assert name in image.__all__
