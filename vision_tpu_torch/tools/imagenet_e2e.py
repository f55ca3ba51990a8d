"""The ImageNet eval pipelines from encoded JPEGs, as ``bench.py`` measures
them for the JAX package (``_bench_e2e``, ``_bench_e2e_tpu_decode``,
``_bench_e2e_device_input``), for the port on the card. Shared by
``chip_smoke.py`` and ``profile_imagenet_e2e``.

* host decode: JPEG streams decoded whole on host threads (the port's
  codec, ``io.jpeg_device.host_decode_batch``) -> uint8 NHWC batches,
  pinned -> ``prefetch_to_device`` ->
  ``preprocess`` (resize to 232x309, bilinear with antialias, centre crop
  224, normalise, cast) -> forward;
* device decode: the host threads stop after the Huffman pass
  (``host_entropy_decode_batch``, coefficient limit 5: the top-left 5x5 of
  each block, (5/8)^2 of the bytes) ->
  ``prefetch_to_device`` -> dequantise, 5-point IDCT, chroma upsampling and
  colour on the card (``decode_coefs``, 235x313 images) -> ``preprocess``
  -> forward;
* device input: decoded uint8 frames already on the card ->
  ``preprocess`` -> forward (what a host that keeps up would sustain).

The JPEGs are ``bench.py``'s ``_make_jpegs`` to the letter (the same seed
and formula: smooth structure plus sensor-like noise, 375x500, quality
75), encoded by the port's encoder. BASELINE config 1 (ResNet-18, f32)
takes its weights' ``ImageClassification`` preset (resize 256, crop 224)
in the place of ``preprocess``.
"""

from __future__ import annotations

import time
from concurrent.futures import ThreadPoolExecutor
from typing import Iterator, List, Optional, Sequence, Tuple

import numpy as np
import torch

from vision_tpu_torch.io import _codecs
from vision_tpu_torch.io.image import encode_jpeg
from vision_tpu_torch.io.jpeg_device import (
    decode_coefs,
    host_decode_batch,
    host_entropy_decode_batch,
)
from vision_tpu_torch.transforms.v2 import functional as F

__all__ = [
    "COEF_LIMIT",
    "CROP",
    "RESIZE_HW",
    "coef_batches",
    "decode_on_device",
    "host_decode_batches",
    "host_decode_ms",
    "make_jpegs",
    "preprocess",
]

RESIZE_HW = (232, 309)  # bench.py: the short side 232, 375x500 -> 232x309
CROP = 224
COEF_LIMIT = 5  # bench.py:193: 235x313 images, short side above 232
MEAN = (0.485, 0.456, 0.406)
STD = (0.229, 0.224, 0.225)


def make_jpegs(n_unique: int = 32, h: int = 375, w: int = 500,
               quality: int = 75) -> List[bytes]:
    """``bench.py:_make_jpegs``: photo-like synthetic JPEGs (smooth
    structure plus noise; pure noise would be the worst case for Huffman
    decoding and unlike a photograph), encoded by the port's encoder."""
    rng = np.random.RandomState(0)
    yy, xx = np.meshgrid(np.arange(h), np.arange(w), indexing="ij")
    out = []
    for k in range(n_unique):
        base = 128 + 60 * np.sin(xx / (13 + k % 7)) * np.cos(yy / (19 + k % 5))
        img = base[..., None] + rng.randn(h, w, 3) * 18
        img = np.clip(img, 0, 255).astype(np.uint8)
        out.append(encode_jpeg(torch.from_numpy(img).permute(2, 0, 1), quality))
    return out


def _streams(jpegs: Sequence[bytes], batch: int, b: int) -> List[bytes]:
    """Batch ``b``'s streams: image ``i`` is ``jpegs[(b * batch + i) %
    len(jpegs)]``, as ``bench.py`` cycles through its unique images."""
    return [jpegs[(b * batch + i) % len(jpegs)] for i in range(batch)]


def host_decode_batches(jpegs: Sequence[bytes], batch: int, n_batches: int,
                        pool: Optional[ThreadPoolExecutor] = None,
                        pin: bool = False) -> Iterator[torch.Tensor]:
    """``n_batches`` uint8 ``[batch, H, W, 3]`` batches, each decoded by
    ``jpeg_device.host_decode_batch`` on the threads of ``pool`` straight
    into a new batch (in pinned memory with ``pin``, which a prefetch queue
    may take over: ``donate_pinned``)."""
    for b in range(n_batches):
        yield host_decode_batch(_streams(jpegs, batch, b), pool=pool, pin=pin)


def coef_batches(jpegs: Sequence[bytes], batch: int, n_batches: int,
                 pool: Optional[ThreadPoolExecutor] = None,
                 coef_limit: int = COEF_LIMIT, pin: bool = False) -> Iterator:
    """Per batch, ``jpeg_device.host_entropy_decode_batch``'s ``(coefs,
    qtabs, samp, (H, W))``: the Huffman pass of each stream (the images as
    in :func:`host_decode_batches`) on the threads of ``pool``, written
    straight into the batch. A stream of another frame than the first's
    raises."""
    for b in range(n_batches):
        yield host_entropy_decode_batch(_streams(jpegs, batch, b), coef_limit,
                                        pool, pin)


def decode_on_device(batch) -> torch.Tensor:
    """A batch of :func:`coef_batches`, its tensors on the card -> uint8
    ``[N, 3, H', W']`` there."""
    coefs, qtabs, samp, (h, w) = batch
    return decode_coefs(coefs, qtabs, h, w, samp)


def preprocess(img: torch.Tensor, dtype: torch.dtype = torch.bfloat16,
               nhwc: bool = True) -> torch.Tensor:
    """``bench.py:143-153`` on the image's device: uint8 ``[N, H, W, 3]``
    (``nhwc``) or ``[N, 3, H, W]`` -> f32, resized to 232x309 (bilinear,
    antialias), centre crop 224, ``(x - 255 mean) / (255 std)``, cast to
    ``dtype``."""
    if nhwc:
        img = img.permute(0, 3, 1, 2)
    x = img.contiguous().to(torch.float32)
    x = F.resize_image(x, list(RESIZE_HW), "bilinear", antialias=True)
    x = F.center_crop_image(x, CROP)
    x = F.normalize_image(x, [255.0 * m for m in MEAN], [255.0 * s for s in STD])
    return x.to(dtype)


def host_decode_ms(jpegs: Sequence[bytes], n_images: int = 64,
                   coef_limit: int = COEF_LIMIT) -> Tuple[float, float]:
    """``bench.py:_bench_host_decode_cost`` for the port's codec: ms an
    image on one core (this thread) for the whole host decode, and for the
    Huffman pass alone (coefficient limit ``coef_limit``)."""
    _codecs.decode_jpeg_native(jpegs[0])
    _codecs.jpeg_coefficients_native(jpegs[0], coef_limit)
    t0 = time.perf_counter()
    for i in range(n_images):
        _codecs.decode_jpeg_native(jpegs[i % len(jpegs)])
    full = (time.perf_counter() - t0) / n_images * 1e3
    t0 = time.perf_counter()
    for i in range(n_images):
        _codecs.jpeg_coefficients_native(jpegs[i % len(jpegs)], coef_limit)
    huff = (time.perf_counter() - t0) / n_images * 1e3
    return full, huff
