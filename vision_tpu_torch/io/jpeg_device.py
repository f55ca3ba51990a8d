"""JPEG decode with the data-parallel tail on the card: the counterpart of
``vision_tpu/io/jpeg_tpu.py``.

The host stops after Huffman decoding (``host_entropy_decode``, the port's
own codec), the only serial stage of a JPEG decode, and ships the
quantised DCT coefficients. The card then runs

    dequantise -> M x M IDCT (two ``torch.matmul`` products with the cached
    basis) -> chroma upsampling -> YCbCr -> RGB -> uint8

as plain PyTorch on the coefficients' device. There is no ``pallas_call``
in the JAX module (its IDCT is an einsum left to XLA), so no hand-written
kernel stands behind this one either.

Numerics are the JAX module's: a float IDCT with the basis of
``_idct_basis``, planes kept as unclamped floats until the end, chroma
upsampled by the exact integer sampling ratio with half-pixel-centre
bilinear weights (0.75 / 0.25; an edge sample keeps its own value, which
is ``jax.image.resize``'s filter renormalised at the border) where both
ratios are 1 or 2, and by replication where one is 3 or 4 (libjpeg's
choice), the ``planes_to_rgb`` constants, then round half to even and clip. The port's
host decode (``_codecs.decode_jpeg_native``) does the same arithmetic in
C++; the two differ by float summation order only.

Batches: ``host_entropy_decode_batch`` (the Huffman pass) and
``host_decode_batch`` (the whole decode, the CPU's counterpart) decode
streams of one frame on host threads, each straight into its row of one
batch, pinned where it is bound for the card; the codec releases the
interpreter lock inside each call.

Layout: coefficients are ``[..., blocks_h, blocks_w, M*M]`` as the JAX
module takes them; images come out ``[..., 3, H, W]`` (CHW), the port's
convention.
"""

from __future__ import annotations

import functools
import os
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from vision_tpu_torch.io import _codecs
from vision_tpu_torch.models._api import resolve_device

__all__ = [
    "decode_coefs",
    "decode_jpeg_batch_device",
    "decode_pool",
    "coef_shapes",
    "decode_threads",
    "group_by_frame",
    "host_decode_batch",
    "host_entropy_decode",
    "host_entropy_decode_batch",
    "idct8x8",
    "pixel_sampling",
    "planes_to_rgb",
]


@functools.lru_cache(maxsize=8)
def _idct_basis(m: int = 8) -> np.ndarray:
    """B_M[u, j] = c(u)/2 * cos((2j+1) u pi / (2M)); pixel = B^T F B.

    m == 8 is the exact inverse of the JPEG forward DCT; m < 8 is the
    M-point truncated IDCT of DCT-scaled decoding (an M/8-scale image from
    the top-left M x M coefficients)."""
    u = np.arange(m)[:, None]
    j = np.arange(m)[None, :]
    b = 0.5 * np.cos((2 * j + 1) * u * np.pi / (2.0 * m))
    b[0, :] *= 1.0 / np.sqrt(2.0)
    return b.astype(np.float32)


_BASES: Dict[Tuple[int, torch.device], torch.Tensor] = {}


def _basis(m: int, device: torch.device) -> torch.Tensor:
    """The basis as a tensor on ``device``, moved there once."""
    key = (m, device)
    b = _BASES.get(key)
    if b is None:
        b = _BASES[key] = torch.from_numpy(_idct_basis(m)).to(device)
    return b


def idct8x8(blocks: torch.Tensor) -> torch.Tensor:
    """Inverse M x M DCT over the last two axes (``[..., M, M]`` float32):
    ``B^T F B`` as two right products, ``(F B)`` and then ``(B^T (F B))``
    computed as ``((F B)^T B)^T``."""
    b = _basis(blocks.shape[-1], blocks.device)
    t = torch.matmul(blocks, b)
    return torch.matmul(t.transpose(-1, -2), b).transpose(-1, -2)


def _component_plane(coefs: torch.Tensor, qtab: torch.Tensor) -> torch.Tensor:
    """``[..., bh, bw, M*M]`` quantised coefficients -> ``[..., bh*M, bw*M]``
    float plane, level-shifted by 128. ``qtab`` is the full 64-entry table
    (``[..., 64]``); its top-left M x M is used."""
    *lead, bh, bw, per_block = coefs.shape
    m = int(round(per_block ** 0.5))
    q = qtab.to(torch.float32).reshape(*qtab.shape[:-1], 8, 8)[..., :m, :m]
    q = q.reshape(*qtab.shape[:-1], 1, 1, m, m)
    deq = coefs.to(torch.float32).reshape(*lead, bh, bw, m, m) * q
    px = idct8x8(deq) + 128.0
    return px.transpose(-3, -2).reshape(*lead, bh * m, bw * m)


def _upsample_axis(x: torch.Tensor, dim: int) -> torch.Tensor:
    """Twice the size along ``dim``: half-pixel-centre bilinear, weights
    0.75 / 0.25, an edge sample keeping its own value."""
    n = x.shape[dim]
    if n == 1:
        return torch.repeat_interleave(x, 2, dim=dim)
    prev = torch.cat([x.narrow(dim, 0, 1), x.narrow(dim, 0, n - 1)], dim)
    nxt = torch.cat([x.narrow(dim, 1, n - 1), x.narrow(dim, n - 1, 1)], dim)
    even = 0.25 * prev + 0.75 * x
    odd = 0.75 * x + 0.25 * nxt
    # the border samples take their own value, as the renormalised filter
    even.narrow(dim, 0, 1).copy_(x.narrow(dim, 0, 1))
    odd.narrow(dim, n - 1, 1).copy_(x.narrow(dim, n - 1, 1))
    out = torch.stack([even, odd], dim=dim + 1 if dim >= 0 else dim)
    shape = list(x.shape)
    shape[dim] = 2 * n
    return out.reshape(shape)


def _upsample_chroma(plane: torch.Tensor, y_shape: Tuple[int, int],
                     factors: Tuple[int, int]) -> torch.Tensor:
    """Upsample a chroma plane ``[..., H, W]`` by the exact integer
    ``factors`` (v, h), each 1 to 4, then crop to the luma plane, with
    libjpeg-turbo 2.1.5's choice of filter: ratios of 1 or 2 through the
    triangle filter, the vertical axis first (as ``jax.image.resize``
    contracts in order); a ratio of 3 or 4 on either axis by replicating
    each sample over ``fv x fh`` pixels (its ``int_upsample``)."""
    fv, fh = factors
    if not (1 <= fv <= 4 and 1 <= fh <= 4):
        raise ValueError(f"chroma sampling ratio {factors}: 1 to 4 only")
    if fv > 2 or fh > 2:
        plane = plane.repeat_interleave(fv, dim=-2).repeat_interleave(fh, dim=-1)
        return plane[..., :y_shape[0], :y_shape[1]]
    if fv == 2:
        plane = _upsample_axis(plane, -2)
    if fh == 2:
        plane = _upsample_axis(plane, -1)
    return plane[..., :y_shape[0], :y_shape[1]]


def planes_to_rgb(y: torch.Tensor, cb: torch.Tensor, cr: torch.Tensor,
                  h: int, w: int,
                  chroma_factors: Tuple[int, int] = (2, 2)) -> torch.Tensor:
    """Full-plane Y / Cb / Cr (chroma possibly subsampled), ``[..., H, W]``
    floats -> ``[..., 3, h, w]`` uint8."""
    if cb.shape != y.shape:
        cb = _upsample_chroma(cb, tuple(y.shape[-2:]), chroma_factors)
        cr = _upsample_chroma(cr, tuple(y.shape[-2:]), chroma_factors)
    y = y[..., :h, :w]
    cb = cb[..., :h, :w] - 128.0
    cr = cr[..., :h, :w] - 128.0
    r = y + 1.402 * cr
    g = y - 0.344136 * cb - 0.714136 * cr
    b = y + 1.772 * cb
    rgb = torch.stack([r, g, b], dim=-3)
    return torch.clamp(torch.round(rgb), 0, 255).to(torch.uint8)


def pixel_sampling(samp) -> bool:
    """Whether a frame's ``samp`` (``(h, v)`` a component) decodes to
    pixels: luma sampled at the highest factors and every chroma ratio an
    integer, where libjpeg's upsampler refuses the rest."""
    if len(samp) < 3:
        return True
    max_h = max(s[0] for s in samp)
    max_v = max(s[1] for s in samp)
    return (tuple(samp[0]) == (max_h, max_v)
            and not any(max_h % sh or max_v % sv for sh, sv in samp))


def decode_coefs(coefs: Sequence[torch.Tensor], qtabs: Sequence[torch.Tensor],
                 h: int, w: int,
                 samp: Optional[Sequence[Tuple[int, int]]] = None
                 ) -> torch.Tensor:
    """Decode the DCT coefficients of one image, or of a batch of images of
    one geometry, on the coefficients' device.

    ``coefs[ci]``: ``[..., bh, bw, M*M]`` int16 (natural order; M = 8 a
    full decode, M < 8 a DCT-scaled one at M/8 size); ``qtabs[ci]``:
    ``[..., 64]``; ``samp[ci]``: ``(h_samp, v_samp)``, 1 to 4 with integer
    luma-to-chroma ratios (default 4:2:0).
    ``h`` / ``w`` are the full image's. Returns ``[..., 3, ceil(h*M/8),
    ceil(w*M/8)]`` uint8 RGB, a grey image replicated."""
    m = int(round(coefs[0].shape[-1] ** 0.5))
    h = -(-h * m // 8)
    w = -(-w * m // 8)
    planes = [_component_plane(c, q) for c, q in zip(coefs, qtabs)]
    if len(planes) == 1:
        g = torch.clamp(torch.round(planes[0][..., :h, :w]), 0, 255)
        g = g.to(torch.uint8).unsqueeze(-3)
        return g.expand(*g.shape[:-3], 3, h, w).contiguous()
    if samp is None:
        samp = [(2, 2), (1, 1), (1, 1)]
    max_h = max(s[0] for s in samp)
    max_v = max(s[1] for s in samp)
    if tuple(samp[0]) != (max_h, max_v):
        raise ValueError(f"sampling {samp}: chroma sampled finer than luma")
    if not pixel_sampling(samp):
        raise ValueError(f"sampling {samp}: a luma-to-chroma ratio that is not "
                         "an integer (libjpeg's fractional sampling)")
    y, cb, cr = planes
    y_shape = tuple(y.shape[-2:])
    # each chroma plane by its own factors: Cb and Cr may differ
    if cb.shape != y.shape:
        cb = _upsample_chroma(cb, y_shape, (max_v // samp[1][1], max_h // samp[1][0]))
    if cr.shape != y.shape:
        cr = _upsample_chroma(cr, y_shape, (max_v // samp[2][1], max_h // samp[2][0]))
    return planes_to_rgb(y, cb, cr, h, w)


def host_entropy_decode(data, coef_limit: int = 0):
    """The host half: Huffman decode to coefficients, as
    ``_codecs.jpeg_coefficients_native`` returns them. Raises
    ``RuntimeError`` naming the stream's type where the decoder does not
    read it."""
    rc, out = _codecs.jpeg_coefficients_code(data, coef_limit)
    if rc != 0:
        raise RuntimeError(f"decode_jpeg: {_codecs.stream_error(rc)}")
    return out


def decode_threads() -> int:
    """Host threads for batch decoding: every CPU this process may run on
    but one, which the thread that launches the card's work keeps (some 800
    launches a batch of ResNet-50)."""
    return max(1, len(os.sched_getaffinity(0)) - 1)


_POOL: Optional[ThreadPoolExecutor] = None
_POOL_LOCK = threading.Lock()


def decode_pool() -> ThreadPoolExecutor:
    """The process's pool of :func:`decode_threads` threads, which the
    batch decoders use where the caller gives none; made at first use."""
    global _POOL
    with _POOL_LOCK:
        if _POOL is None:
            _POOL = ThreadPoolExecutor(decode_threads(),
                                       thread_name_prefix="jpeg-decode")
        return _POOL


def _each(pool: Optional[ThreadPoolExecutor], fn, n: int) -> None:
    """``fn(i)`` for ``i < n`` on the threads of ``pool`` (the shared one by
    default; one stream runs on the caller's thread); the first error
    raises here."""
    if n == 1:
        fn(0)
        return
    for _ in (pool or decode_pool()).map(fn, range(n)):
        pass


def _frame(data) -> Tuple[Tuple[int, int], Tuple[Tuple[int, int], ...]]:
    """The stream's ``((H, W), samp)``; where the header does not parse, the
    decoder's own error, as ``RuntimeError``."""
    frame = _codecs.jpeg_frame(data)
    if frame is None:
        rc = _codecs.jpeg_coefficients_code(data)[0]
        raise RuntimeError(f"decode_jpeg: {_codecs.stream_error(rc or -1)}")
    return frame[0], tuple(frame[1])


def _one_frame(buffers: Sequence[bytes]):
    """The frame that every stream of ``buffers`` shares."""
    if not buffers:
        raise ValueError("a batch of no streams")
    first = _frame(buffers[0])
    for i, data in enumerate(buffers[1:], 1):
        if _frame(data) != first:
            raise ValueError(
                f"stream {i}: a JPEG of another size or sampling than the "
                f"batch's first {first}")
    return first


def group_by_frame(buffers: Sequence[bytes]) -> List[List[int]]:
    """The indices of ``buffers`` by frame (size and sampling), each group
    in order, the groups in the order of their first stream."""
    groups: Dict[tuple, List[int]] = {}
    for i, data in enumerate(buffers):
        groups.setdefault(_frame(data), []).append(i)
    return list(groups.values())


def _coef_m(coef_limit: int) -> int:
    return coef_limit if 0 < coef_limit < 8 else 8


def coef_shapes(hw: Tuple[int, int], samp, coef_limit: int = 0):
    """Each component's coefficient array shape ``(bh, bw, M*M)`` for a
    frame of size ``hw`` and sampling ``samp`` (``_codecs.jpeg_frame``'s)."""
    (h, w), m = hw, _coef_m(coef_limit)
    hmax = max(s[0] for s in samp)
    vmax = max(s[1] for s in samp)
    return [(-(-h * sv // (8 * vmax)), -(-w * sh // (8 * hmax)), m * m)
            for sh, sv in samp]


def host_decode_batch(buffers: Sequence[bytes], coef_limit: int = 0,
                      pool: Optional[ThreadPoolExecutor] = None,
                      pin: bool = False) -> torch.Tensor:
    """The whole decode of streams of one frame on the host: uint8
    ``[N, H', W', C]`` (the codec's interleaved layout; C = 1 for grey
    streams, 3 otherwise; H' = ceil(H*M/8), M = ``coef_limit`` in 1..7,
    else 8), each stream decoded on a thread of ``pool`` straight into its
    row of the batch (pinned with ``pin``): no allocation and no copy an
    image. A stream of another frame than the first's raises
    ``ValueError``; one the decoder does not read, ``RuntimeError``."""
    (h, w), samp = _one_frame(buffers)
    m = _coef_m(coef_limit)
    out = torch.empty((len(buffers), -(-h * m // 8), -(-w * m // 8),
                       1 if len(samp) == 1 else 3),
                      dtype=torch.uint8, pin_memory=pin)
    arr = out.numpy()

    def one(i):
        _codecs.decode_jpeg_native(buffers[i], coef_limit, out=arr[i])

    _each(pool, one, len(buffers))
    return out


def host_entropy_decode_batch(buffers: Sequence[bytes], coef_limit: int = 0,
                              pool: Optional[ThreadPoolExecutor] = None,
                              pin: bool = False):
    """The host half for streams of one frame: ``(coefs, qtabs, samp,
    (H, W))`` with ``coefs[ci]`` int16 ``[N, bh, bw, M*M]`` and
    ``qtabs[ci]`` float32 ``[N, 64]`` (each stream's own table), what
    :func:`decode_coefs` takes. Each stream's Huffman pass runs on a thread
    of ``pool`` and writes straight into its row of the batch (pinned with
    ``pin``). Raises as :func:`host_decode_batch`."""
    (h, w), samp = _one_frame(buffers)
    n = len(buffers)
    coefs = tuple(torch.empty((n, *shape), dtype=torch.int16, pin_memory=pin)
                  for shape in coef_shapes((h, w), samp, coef_limit))
    qtabs = tuple(torch.empty((n, 64), dtype=torch.float32, pin_memory=pin)
                  for _ in samp)
    carr = [c.numpy() for c in coefs]
    qarr = [q.numpy() for q in qtabs]

    def one(i):
        rc, got = _codecs.jpeg_coefficients_code(
            buffers[i], coef_limit, out=[a[i] for a in carr])
        if rc != 0:
            raise RuntimeError(f"decode_jpeg: {_codecs.stream_error(rc)}")
        for q, table in zip(qarr, got[1]):
            q[i] = table

    _each(pool, one, n)
    return coefs, qtabs, list(samp), (h, w)


def decode_jpeg_batch_device(
    buffers: Sequence[bytes],
    coef_limit: int = 0,
    device: Union[str, torch.device, None] = None,
    pool: Optional[ThreadPoolExecutor] = None,
) -> List[torch.Tensor]:
    """Decode a list of JPEG streams with the IDCT tail on ``device`` (the
    card unless the caller asks for the CPU): the counterpart of
    ``decode_jpeg_batch_tpu``.

    Images of one frame (size and sampling) are entropy-decoded on the
    threads of ``pool`` (:func:`decode_pool` by default) into one pinned
    batch (:func:`host_entropy_decode_batch`), copied to the card without
    waiting and decoded there as one batch, as the JAX module vmaps them; a
    list that mixes frames is decoded one group at a time, each group one
    batch on the device. Returns one ``[3, H', W']`` uint8 tensor an image,
    in the order of ``buffers``. ``coef_limit`` M in 1..7 decodes at M/8
    size, shipping (M/8)^2 of the coefficients."""
    device = resolve_device(device)
    pin = device.type == "cuda"
    out: List[Optional[torch.Tensor]] = [None] * len(buffers)
    for idx in group_by_frame(buffers):
        coefs, qtabs, samp, (h, w) = host_entropy_decode_batch(
            [buffers[i] for i in idx], coef_limit, pool, pin)
        imgs = decode_coefs([c.to(device, non_blocking=True) for c in coefs],
                            [q.to(device, non_blocking=True) for q in qtabs],
                            h, w, samp)
        for k, i in enumerate(idx):
            out[i] = imgs[k]
    return out
