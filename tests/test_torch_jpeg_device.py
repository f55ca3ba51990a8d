"""The port's device half of the JPEG decode (``vision_tpu_torch.io.
jpeg_device``, run here on the CPU) against ``vision_tpu.io.jpeg_tpu`` on
JAX CPU, on the same coefficients; the list contract of ``decode_jpeg``;
EXIF orientation against ``vision_tpu.io._exif``.

Both sides compute the same float arithmetic (dequantise, the float IDCT
of ``_idct_basis``, bilinear chroma upsampling at half-pixel centres,
``planes_to_rgb``), in another summation order, then round: so the pixels
may differ by one count where a value lies within round-off of .5, and no
more.
"""

import importlib
import io
import struct
from concurrent.futures import ThreadPoolExecutor

import jax.numpy as jnp
import numpy as np
import PIL.Image
import pytest
import torch

import vision_tpu.io._codecs as jcodecs
from vision_tpu.io import _exif as jexif
from vision_tpu.io import image as jimage
from vision_tpu.io import jpeg_tpu
from vision_tpu_torch.io import (
    ImageReadMode,
    _codecs,
    _exif,
    decode_image,
    decode_jpeg,
    image,
    jpeg_device,
)


def jax_codecs():
    """``vision_tpu.io._codecs`` with its native shim loaded (see
    ``tests/test_torch_jpeg_codec.py``: it may be half-built in a worker)."""
    if not jcodecs.has_native():
        importlib.reload(jcodecs)
    if not jcodecs.has_native():
        pytest.fail("vision_tpu's native codec shim did not load")
    return jcodecs


def photo(h=120, w=160, seed=0):
    rng = np.random.RandomState(seed)
    x, y = np.meshgrid(np.arange(w), np.arange(h))
    base = 128 + 60 * np.sin(x / 17.0) * np.cos(y / 23.0)
    img = base[..., None] + rng.randn(h, w, 3) * 18
    return np.clip(img, 0, 255).astype(np.uint8)


def pil_jpeg(img, **kw):
    buf = io.BytesIO()
    PIL.Image.fromarray(img).save(buf, "JPEG", **kw)
    return buf.getvalue()


def both_decodes(data, m):
    """The port's and JAX's ``decode_coefs`` of one stream's coefficients
    at limit ``m``, as HWC int arrays."""
    coefs, qtabs, samp, (h, w) = _codecs.jpeg_coefficients_native(data, m)
    got = jpeg_device.decode_coefs(
        [torch.from_numpy(c) for c in coefs],
        [torch.from_numpy(q.astype(np.float32)) for q in qtabs], h, w, samp)
    want = jpeg_tpu.decode_coefs(
        [jnp.asarray(c) for c in coefs],
        [jnp.asarray(q.astype(np.float32)) for q in qtabs], h, w, samp)
    return got.permute(1, 2, 0).numpy().astype(int), np.asarray(want).astype(int)


@pytest.mark.parametrize("m", range(1, 9))
@pytest.mark.parametrize("subsampling", [0, 1, 2])  # 4:4:4, 4:2:2, 4:2:0
def test_decode_coefs_matches_jax(subsampling, m):
    data = pil_jpeg(photo(121, 163, seed=subsampling), quality=80,
                    subsampling=subsampling)
    got, want = both_decodes(data, m)
    assert got.shape == want.shape == (-(-121 * m // 8), -(-163 * m // 8), 3)
    assert np.abs(got - want).max() <= 1


@pytest.mark.parametrize("m", range(1, 9))
def test_decode_coefs_matches_jax_grey(m):
    """A grey stream: one plane, replicated to three channels."""
    data = pil_jpeg(photo(77, 90)[..., 0], quality=90)
    got, want = both_decodes(data, m)
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= 1
    assert (got[..., 0] == got[..., 2]).all()


def test_decode_coefs_of_a_batch_equals_one_by_one():
    """A stacked batch (``[N, bh, bw, M*M]``) decodes as its images do, as
    the JAX module vmaps them."""
    streams = [pil_jpeg(photo(seed=s), quality=75) for s in range(3)]
    decoded = [_codecs.jpeg_coefficients_native(d, 5) for d in streams]
    _, qtabs, samp, (h, w) = decoded[0]
    qt = [torch.from_numpy(q.astype(np.float32)) for q in qtabs]
    batch = jpeg_device.decode_coefs(
        [torch.from_numpy(np.stack([d[0][ci] for d in decoded])) for ci in range(3)],
        qt, h, w, samp)
    assert batch.shape == (3, 3, 75, 100)
    for k, d in enumerate(decoded):
        one = jpeg_device.decode_coefs([torch.from_numpy(c) for c in d[0]], qt,
                                       h, w, samp)
        assert torch.equal(batch[k], one)


def test_batch_decode_matches_jax_batch_decode():
    """``decode_jpeg_batch_device`` against ``decode_jpeg_batch_tpu`` on a
    list of one geometry: a list of CHW images, within one count."""
    streams = [pil_jpeg(photo(seed=s), quality=75) for s in range(3)]
    got = jpeg_device.decode_jpeg_batch_device(streams, 3, device="cpu")
    want = np.asarray(jpeg_tpu.decode_jpeg_batch_tpu(streams, coef_limit=3))
    assert isinstance(got, list) and len(got) == 3
    for g, w in zip(got, want):
        assert g.dtype == torch.uint8 and g.shape == (3, 45, 60)
        assert np.abs(g.permute(1, 2, 0).numpy().astype(int) - w).max() <= 1


def test_mixed_geometry_decodes_one_batch_a_group(monkeypatch):
    """A list of two sizes and a grey stream: one ``decode_coefs`` call a
    geometry, the images back in the list's order, each as JAX decodes
    it."""
    a = pil_jpeg(photo(seed=1), quality=75)
    b = pil_jpeg(photo(64, 48, seed=2), quality=75)
    g = pil_jpeg(photo(seed=3)[..., 0], quality=75)
    calls = []
    real = jpeg_device.decode_coefs

    def counted(coefs, *args):
        calls.append(coefs[0].shape[0])
        return real(coefs, *args)

    monkeypatch.setattr(jpeg_device, "decode_coefs", counted)
    got = jpeg_device.decode_jpeg_batch_device([a, b, a, g, b], device="cpu")
    assert sorted(calls) == [1, 2, 2]
    assert [tuple(x.shape) for x in got] == [(3, 120, 160), (3, 64, 48),
                                             (3, 120, 160), (3, 120, 160),
                                             (3, 64, 48)]
    assert torch.equal(got[0], got[2]) and torch.equal(got[1], got[4])
    for data, img in zip([a, b, g], [got[0], got[1], got[3]]):
        want = np.asarray(jpeg_tpu.decode_jpeg_batch_tpu([data]))[0]
        assert np.abs(img.permute(1, 2, 0).numpy().astype(int) - want).max() <= 1


def test_card_branch_of_decode_jpeg(monkeypatch):
    """``decode_jpeg``'s card branch, run on the CPU by handing it a CUDA
    device and the batch decode a CPU one: a list in gives a list out, one
    stream one tensor; UNCHANGED gives three channels for a grey stream;
    GRAY is ``vision_tpu``'s ``device="tpu"`` GRAY (weights 0.2989, 0.587,
    0.114, truncated) within one count; the alpha modes are refused."""
    real = jpeg_device.decode_jpeg_batch_device
    monkeypatch.setattr(image, "resolve_device", lambda d: torch.device("cuda"))
    monkeypatch.setattr(image, "decode_jpeg_batch_device",
                        lambda bufs, m, device: real(bufs, m, device="cpu"))
    a = pil_jpeg(photo(seed=1), quality=80)
    grey = pil_jpeg(photo(seed=2)[..., 0], quality=80)
    out = decode_jpeg([a, grey])
    assert isinstance(out, list) and [tuple(x.shape) for x in out] == [(3, 120, 160)] * 2
    one = decode_jpeg(a)
    assert isinstance(one, torch.Tensor) and torch.equal(one, out[0])
    jax_codecs()
    for data in (a, grey):
        got = decode_jpeg(data, mode=ImageReadMode.GRAY)
        want = np.asarray(jimage.decode_jpeg(data, mode=jimage.ImageReadMode.GRAY,
                                             device="tpu"))
        assert got.shape == (1, 120, 160)
        assert np.abs(got[0].numpy().astype(int) - want[..., 0]).max() <= 1
    for mode in (ImageReadMode.RGB_ALPHA, ImageReadMode.GRAY_ALPHA):
        with pytest.raises(ValueError, match="UNCHANGED, RGB and GRAY"):
            decode_jpeg(a, mode=mode)


@pytest.mark.parametrize("mode", ["UNCHANGED", "GRAY", "RGB", "RGB_ALPHA",
                                  "GRAY_ALPHA"])
def test_host_decode_modes_follow_apply_mode(mode):
    """``device="cpu"``: every mode, as ``vision_tpu``'s ``_apply_mode`` on
    the same pixels (the port's host decode)."""
    for data in (pil_jpeg(photo(seed=4), quality=80),
                 pil_jpeg(photo(seed=5)[..., 0], quality=80)):
        raw = _codecs.decode_jpeg_native(data)
        want = jimage._apply_mode(raw, jimage.ImageReadMode[mode])
        got = decode_jpeg(data, mode=ImageReadMode[mode], device="cpu")
        np.testing.assert_array_equal(got.permute(1, 2, 0).numpy(), want)


@pytest.mark.parametrize("scale", [(8, 8), (0, 8), (5, 4), (9, 8), (1, 2, 8)])
def test_scale_is_validated(scale):
    """``scale=(M, 8)`` with M in 1..7 only (``vision_tpu/io/image.py:
    160-175``), on both devices."""
    data = pil_jpeg(photo(), quality=75)
    with pytest.raises(ValueError, match="scale=\\(M, 8\\)"):
        decode_jpeg(data, scale=scale, device="cpu")


def test_scaled_decode_sizes():
    data = pil_jpeg(photo(121, 163), quality=75)
    for m in range(1, 8):
        got = decode_jpeg(data, scale=(m, 8), device="cpu")
        assert got.shape == (3, -(-121 * m // 8), -(-163 * m // 8))


def exif_jpeg(data: bytes, orientation: int, little: bool) -> bytes:
    """``data`` with an APP1 Exif segment carrying ``orientation`` after
    SOI, in either byte order."""
    e = "<" if little else ">"
    tiff = (b"II" if little else b"MM") + struct.pack(e + "HI", 42, 8)
    tiff += struct.pack(e + "H", 1) + struct.pack(e + "HHIHH", 0x0112, 3, 1,
                                                  orientation, 0)
    tiff += struct.pack(e + "I", 0)
    payload = b"Exif\x00\x00" + tiff
    return data[:2] + b"\xff\xe1" + struct.pack(">H", len(payload) + 2) + payload + data[2:]


@pytest.mark.parametrize("orientation", range(1, 9))
def test_exif_orientation_matches_jax(orientation):
    """The port's parse of the tag equals ``vision_tpu``'s, and its CHW
    transform is ``vision_tpu``'s HWC one, on the decoded pixels."""
    base = pil_jpeg(photo(40, 56, seed=orientation), quality=80)
    data = exif_jpeg(base, orientation, little=orientation % 2 == 0)
    assert _exif.parse_jpeg_exif_orientation(data) == orientation
    assert jexif.parse_jpeg_exif_orientation(data) == orientation
    plain = decode_jpeg(data, device="cpu")
    got = decode_jpeg(data, device="cpu", apply_exif_orientation=True)
    want = jexif.exif_orientation_transform(plain.permute(1, 2, 0).numpy(),
                                            orientation)
    np.testing.assert_array_equal(got.permute(1, 2, 0).numpy(), want)
    assert got.is_contiguous()


def test_decode_image_dispatches_on_magic_bytes():
    data = pil_jpeg(photo(), quality=75)
    assert decode_image(data, device="cpu").shape == (3, 120, 160)
    assert decode_image(np.frombuffer(data, np.uint8), device="cpu").shape == (3, 120, 160)
    for other in (b"\x89PNG\r\n\x1a\n" + bytes(20), b"GIF89a" + bytes(20),
                  b"RIFF\x00\x00\x00\x00WEBPVP8 " + bytes(20)):
        with pytest.raises(NotImplementedError, match="ROADMAP.md"):
            decode_image(other, device="cpu")
    with pytest.raises(RuntimeError, match="Unsupported image format"):
        decode_image(b"\x00" * 32, device="cpu")


def test_read_image_and_write_jpeg(tmp_path):
    img = torch.from_numpy(photo(48, 64)).permute(2, 0, 1).contiguous()
    path = tmp_path / "x.jpg"
    image.write_jpeg(img, path, quality=90)
    got = image.read_image(path, device="cpu")
    assert got.shape == img.shape
    assert (got.int() - img.int()).abs().float().mean() < 12  # the noise, at q90


def test_entry_points_default_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    data = pil_jpeg(photo(), quality=75)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        decode_jpeg(data)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        jpeg_device.decode_jpeg_batch_device([data])


# ------------------------------------------------- batches on host threads

FRAME_STREAMS = {
    "444": lambda: pil_jpeg(photo(), quality=75, subsampling=0),
    "422": lambda: pil_jpeg(photo(), quality=75, subsampling=1),
    "420": lambda: pil_jpeg(photo(), quality=75, subsampling=2),
    "grey": lambda: pil_jpeg(photo()[..., 0], quality=75),
    "odd_121x163": lambda: pil_jpeg(photo(121, 163), quality=90),
    "restart_markers": lambda: pil_jpeg(photo(), quality=75,
                                        restart_marker_blocks=2),
    "port_encoder": lambda: image.encode_jpeg(
        torch.from_numpy(photo(57, 83)).permute(2, 0, 1)),
}


@pytest.mark.parametrize("name", sorted(FRAME_STREAMS))
def test_jpeg_frame_reads_the_codecs_size_and_sampling(name):
    """The header scan that groups a list by frame finds the size and the
    sampling factors that the codec decodes."""
    data = FRAME_STREAMS[name]()
    _, _, samp, hw = _codecs.jpeg_coefficients_native(data)
    assert _codecs.jpeg_frame(data) == (hw, samp)


def test_jpeg_frame_is_none_where_the_codec_reads_no_baseline_frame():
    """Progressive, cut inside the header, not a JPEG: no frame, and the
    batch decoders raise the codec's own error for the stream."""
    progressive = pil_jpeg(photo(), quality=75, progressive=True)
    good = pil_jpeg(photo(), quality=75)
    for data in (progressive, good[:30], b"\xff\xd8\xff\xd9", b"GIF89a" + bytes(20)):
        assert _codecs.jpeg_frame(data) is None
    with pytest.raises(RuntimeError, match="progressive"):
        jpeg_device.host_entropy_decode_batch([good, progressive])
    with pytest.raises(RuntimeError, match="corrupt or truncated"):
        jpeg_device.host_decode_batch([good[:30]])


@pytest.mark.parametrize("coef_limit", [0, 5])
@pytest.mark.parametrize("grey", [False, True])
def test_host_decode_batch_writes_each_stream_into_its_row(coef_limit, grey):
    """Every row of the batch is that stream's own host decode, bit for
    bit, on the shared pool and on a pool of the caller's."""
    streams = [pil_jpeg(photo(seed=s)[..., 0] if grey else photo(seed=s),
                        quality=60 + 10 * s) for s in range(3)]
    want = np.stack([_codecs.decode_jpeg_native(d, coef_limit) for d in streams])
    got = jpeg_device.host_decode_batch(streams, coef_limit)
    assert got.dtype == torch.uint8 and got.shape == want.shape
    assert got.shape[-1] == (1 if grey else 3)
    np.testing.assert_array_equal(got.numpy(), want)
    with ThreadPoolExecutor(2) as pool:
        again = jpeg_device.host_decode_batch(streams, coef_limit, pool=pool)
    assert torch.equal(again, got)


@pytest.mark.parametrize("subsampling", [0, 2])
def test_host_entropy_decode_batch_keeps_each_streams_tables(subsampling):
    """Streams of one frame at three qualities: each row holds the stream's
    own coefficients and tables, bit for bit, and the batch decodes to each
    stream's own ``decode_coefs``."""
    streams = [pil_jpeg(photo(seed=s), quality=q, subsampling=subsampling)
               for s, q in enumerate((50, 75, 95))]
    coefs, qtabs, samp, hw = jpeg_device.host_entropy_decode_batch(streams, 4)
    batch = jpeg_device.decode_coefs(coefs, qtabs, hw[0], hw[1], samp)
    for k, data in enumerate(streams):
        w_coefs, w_qtabs, w_samp, w_hw = _codecs.jpeg_coefficients_native(data, 4)
        assert hw == w_hw and samp == w_samp
        for c, w in zip(coefs, w_coefs):
            assert c.dtype == torch.int16
            np.testing.assert_array_equal(c[k].numpy(), w)
        for q, w in zip(qtabs, w_qtabs):
            assert q.dtype == torch.float32
            np.testing.assert_array_equal(q[k].numpy(), w.astype(np.float32))
        one = jpeg_device.decode_coefs(
            [torch.from_numpy(c) for c in w_coefs],
            [torch.from_numpy(q.astype(np.float32)) for q in w_qtabs],
            hw[0], hw[1], samp)
        assert torch.equal(batch[k], one)


@pytest.mark.parametrize("fn", ["host_decode_batch", "host_entropy_decode_batch"])
def test_batches_refuse_a_stream_of_another_frame(fn):
    a = pil_jpeg(photo(), quality=75)
    for other in (pil_jpeg(photo(64, 48), quality=75),
                  pil_jpeg(photo(), quality=75, subsampling=0)):
        with pytest.raises(ValueError, match="another size or sampling"):
            getattr(jpeg_device, fn)([a, other])


def test_a_corrupt_stream_in_a_batch_raises_from_its_thread():
    """A stream whose header parses but whose scan is cut: the thread that
    decodes it raises, and the error reaches the caller."""
    good = pil_jpeg(photo(), quality=75)
    cut = good[:len(good) // 2]
    assert _codecs.jpeg_frame(cut) == _codecs.jpeg_frame(good)
    for fn in (jpeg_device.host_decode_batch,
               jpeg_device.host_entropy_decode_batch):
        with pytest.raises(RuntimeError, match="corrupt or truncated"):
            fn([good, cut, good])


def test_cpu_decode_jpeg_of_a_mixed_list_keeps_the_order():
    """``decode_jpeg(list, device="cpu")`` decodes a batch a frame on the
    host threads: each image is that stream's own decode, in the list's
    order; a grey stream keeps one channel."""
    a = pil_jpeg(photo(seed=1), quality=75)
    b = pil_jpeg(photo(64, 48, seed=2), quality=75)
    g = pil_jpeg(photo(seed=3)[..., 0], quality=75)
    got = decode_jpeg([a, b, g, a], device="cpu", scale=(6, 8))
    for img, data in zip(got, [a, b, g, a]):
        want = torch.from_numpy(_codecs.decode_jpeg_native(data, 6)).permute(2, 0, 1)
        assert img.is_contiguous() and torch.equal(img, want)
    assert [x.shape[0] for x in got] == [3, 3, 1, 3]


def test_decode_pool_is_shared_and_sized_to_the_host():
    pool = jpeg_device.decode_pool()
    assert pool is jpeg_device.decode_pool()
    assert pool._max_workers == jpeg_device.decode_threads() >= 1
