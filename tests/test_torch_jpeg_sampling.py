"""JPEG sampling factors 3 and 4 in the port's codec (``csrc/jpeg_codec.cpp``)
and on its card path (``io/jpeg_device.py``), against libjpeg through
``vision_tpu`` on the CPU.

The committed streams (``tests/torch_io_data/samp_*.jpg``, written by
libjpeg from raw planes: luma 3x1, 1x3, 4x1, 1x4, 3x2, 2x3, 4x2 and 2x4
over 1x1 chroma, 4x2 over 2x1 chroma in one scan a component, a 4x4 grey
stream) give libjpeg's coefficients bit for bit; their pixels lie within
the port's bound of libjpeg's (8 levels, ``ROADMAP.md`` section 3), and
the card path's (its torch arithmetic, run here on the CPU) within one
level of the host's. Chroma ratios of 3 or 4 are upsampled by plain
replication, as libjpeg-turbo's ``int_upsample`` does. What libjpeg
refuses raises: more than 10 blocks in an interleaved MCU, and (to pixels)
a luma-to-chroma ratio that is not an integer. The card's own decode is
held to the host's in ``test_torch_small_data_cuda.py``.
"""

import importlib
import tempfile
from pathlib import Path

import numpy as np
import pytest
import torch

import vision_tpu.io._codecs as jcodecs
from vision_tpu.io import image as jimage
from vision_tpu_torch.io import _codecs, decode_jpeg, image, jpeg_device
from vision_tpu_torch.io.device_loader import DeviceJpegLoader
from torch_io_fixtures import (
    DATA,
    JPEG_HELPER,
    SAMPLING,
    build_helper,
    photo,
    sampled_jpeg,
)

STREAMS = sorted(SAMPLING)
PIXEL_BOUND = 8  # the port's float IDCT against libjpeg's integer one


def jax_codecs():
    """``vision_tpu.io._codecs`` with its native shim loaded."""
    if not jcodecs.has_native():
        importlib.reload(jcodecs)
    if not jcodecs.has_native():
        pytest.fail("vision_tpu's native codec shim did not load")
    return jcodecs


@pytest.fixture(scope="module")
def fractional():
    """Luma 3x1 over 2x1 chroma: libjpeg reads its coefficients and
    refuses its pixels ("fractional sampling")."""
    with tempfile.TemporaryDirectory() as tmp:
        helper = build_helper(JPEG_HELPER, "jpeg_helper", "-ljpeg", Path(tmp))
        return sampled_jpeg(helper, photo(64, 80, seed=3), [(3, 1), (2, 1), (2, 1)],
                            Path(tmp))


def card_path(data: bytes) -> torch.Tensor:
    """The card path's arithmetic (entropy decode on the host, the torch
    tail) on the CPU."""
    coefs, qtabs, samp, hw = jpeg_device.host_entropy_decode(data)
    return jpeg_device.decode_coefs([torch.from_numpy(c) for c in coefs],
                                    [torch.from_numpy(q.astype(np.float32)) for q in qtabs],
                                    *hw, samp)


@pytest.mark.parametrize("name", STREAMS)
def test_coefficients_equal_libjpeg_and_pixels_lie_within_the_bound(name):
    data = (DATA / name).read_bytes()
    jc = jax_codecs()
    for m in (0, 5):
        port = _codecs.jpeg_coefficients_native(data, m)
        lib = jc.jpeg_coefficients_native(data, m)
        assert port[2] == [tuple(s) for s in lib[2]] == [tuple(f) for f in SAMPLING[name][0]]
        for a, b in zip(port[0], lib[0]):
            np.testing.assert_array_equal(a, b)
    host = decode_jpeg(data, device="cpu")
    want = jimage.decode_jpeg(data)
    assert host.shape[1:] == want.shape[:2]
    assert np.abs(host.permute(1, 2, 0).numpy().astype(int) - want.astype(int)).max() \
        <= PIXEL_BOUND
    card = card_path(data)
    assert (card.int() - host.expand(3, -1, -1).int()).abs().max() <= 1
    assert _codecs.jpeg_frame(data) == ((host.shape[1], host.shape[2]),
                                        [tuple(f) for f in SAMPLING[name][0]])


@pytest.mark.parametrize("factors", [(1, 3), (3, 1), (4, 2), (2, 4), (4, 4)])
def test_ratios_of_3_and_4_replicate_each_sample(factors):
    """A chroma ratio of 3 or 4 on either axis is plain replication on both
    axes (libjpeg's ``int_upsample``), on the card path and the host's."""
    plane = torch.arange(5 * 7, dtype=torch.float32).reshape(5, 7)
    fv, fh = factors
    got = jpeg_device._upsample_chroma(plane, (5 * fv - 1, 7 * fh - 2), factors)
    want = plane.repeat_interleave(fv, 0).repeat_interleave(fh, 1)[:5 * fv - 1, :7 * fh - 2]
    assert torch.equal(got, want)


def test_the_card_branch_of_decode_jpeg_reads_them(monkeypatch):
    """``decode_jpeg``'s card branch, run on the CPU, groups the streams by
    frame and decodes them within a level of the host."""
    real = jpeg_device.decode_jpeg_batch_device
    monkeypatch.setattr(image, "resolve_device", lambda d: torch.device("cuda"))
    monkeypatch.setattr(image, "decode_jpeg_batch_device",
                        lambda bufs, m, device: real(bufs, m, device="cpu"))
    streams = [(DATA / n).read_bytes() for n in STREAMS]
    assert len(jpeg_device.group_by_frame(streams)) == len(STREAMS)
    for data, out in zip(streams, decode_jpeg(streams)):
        host = decode_jpeg(data, device="cpu").expand(3, -1, -1)
        assert (out.int() - host.int()).abs().max() <= 1


def test_the_device_loader_takes_them_on_its_device_lane():
    samples = [((DATA / n).read_bytes(), k) for k, n in enumerate(STREAMS)]
    loader = DeviceJpegLoader(samples, 2, 32, train=False, device="cpu")
    for data, _ in samples:
        assert loader._offload(data) is not None
    batches = list(loader)
    assert sum(len(b["label"]) for b in batches) == len(samples)
    assert loader.stats["offload"] == len(samples) and loader.stats["dropped"] == 0


def test_fractional_sampling_reads_coefficients_and_refuses_pixels(fractional):
    jc = jax_codecs()
    port = _codecs.jpeg_coefficients_native(fractional)
    lib = jc.jpeg_coefficients_native(fractional)
    for a, b in zip(port[0], lib[0]):
        np.testing.assert_array_equal(a, b)
    with pytest.raises(Exception):
        jimage.decode_jpeg(fractional)
    with pytest.raises(RuntimeError, match="not an integer"):
        decode_jpeg(fractional, device="cpu")
    with pytest.raises(ValueError, match="not an integer"):
        card_path(fractional)
    assert not jpeg_device.pixel_sampling(port[2])
    loader = DeviceJpegLoader([(fractional, 0)], 1, 32, train=False, device="cpu")
    assert loader._offload(fractional) is None


def test_more_than_ten_blocks_an_mcu_raise_as_libjpeg_does():
    """Luma 3x3 over 1x1 chroma, an interleaved scan: 11 blocks an MCU."""
    data = bytearray((DATA / "samp_3x2.jpg").read_bytes())
    sof = data.index(b"\xff\xc0")
    assert data[sof + 11] == 0x32
    data[sof + 11] = 0x33
    data = bytes(data)
    jc = jax_codecs()
    assert jc.jpeg_coefficients_native(data) is None
    with pytest.raises(Exception):
        jimage.decode_jpeg(data)
    assert _codecs.jpeg_coefficients_code(data)[0] == -1
    with pytest.raises(RuntimeError, match="corrupt"):
        decode_jpeg(data, device="cpu")

