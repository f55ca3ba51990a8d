"""The ImageNet input path with the JPEG decode's tail on the card: the
counterpart of ``vision_tpu/io/tpu_loader.py`` (``TpuJpegLoader``).

The host entropy-decodes each JPEG to its DCT coefficients (the port's own
codec, on the threads of ``jpeg_device.decode_pool``: sequential and
progressive streams alike) and buckets the images by coefficient canvas.
Each full bucket becomes one batch, which the card turns into training or
evaluation input in one program of plain PyTorch:

    dequantise + IDCT (``jpeg_device.decode_coefs``) -> a resized crop of
    each image, bilinear, its samples clamped to the image's true size so
    that the canvas padding is never read (``crop_resize_clamped``) ->
    horizontal flip -> normalisation

Streams the coefficient path does not take (CMYK, arithmetic-coded; and,
with ``apply_exif_orientation``, images whose EXIF tag turns them, whose
block grid a transpose would break) are decoded whole on the host, made
upright, and re-encoded as a quality-97 baseline JPEG, so that they ride
the same program; the re-encode lane decodes any format the port reads
(PNG and GIF too). A stream that neither lane reads is counted in
``stats["dropped"]`` and its error kept in ``drop_reasons``.

Differences by design from the JAX loader: the crop boxes and flips are
Python numbers drawn on the host from a CPU ``torch.Generator`` (each
image's true size is known there), not ``jax.random`` keys traced into the
program, so nothing waits for the card; the crop is one batched function of
the boxes and sizes (``crop_resize_clamped``) that the tests call with
JAX's boxes; the shuffle is the JAX loader's own ``numpy`` permutation, so
the two loaders visit the samples, fill the buckets and shard them alike.
"""

from __future__ import annotations

import collections
import math
import os
import threading
from typing import Dict, Iterator, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from vision_tpu_torch.io import _codecs, _exif
from vision_tpu_torch.io.image import (
    ImageReadMode,
    _apply_mode,
    decode_image,
    encode_jpeg,
)
from vision_tpu_torch.io.jpeg_device import (
    coef_shapes,
    decode_coefs,
    decode_pool,
    pixel_sampling,
)
from vision_tpu_torch.models._api import resolve_device

__all__ = ["DeviceJpegLoader", "crop_resize_clamped", "rrc_box",
           "IMAGENET_MEAN", "IMAGENET_STD"]

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)
REENCODE_QUALITY = 97
_LANES = ("offload", "reencode_fallback", "exif_reorient", "dropped")
AHEAD_BATCHES = 4  # batches of samples being decoded ahead of the buckets


class _Recycled:
    """Coefficient arrays kept by shape once a batch is staged, for the
    next images to decode into: fresh arrays fault in fresh pages, and
    decode threads faulting at once wait on each other."""

    def __init__(self):
        self._free: Dict[tuple, list] = {}
        self._lock = threading.Lock()

    def take(self, shape) -> np.ndarray:
        with self._lock:
            free = self._free.get(shape)
            if free:
                return free.pop()
        return np.empty(shape, np.int16)

    def give(self, arrays) -> None:
        with self._lock:
            for a in arrays:
                self._free.setdefault(a.shape, []).append(a)


def rrc_box(th: float, tw: float, draws: Sequence[float], scale, ratio):
    """RandomResizedCrop's box ``(top, left, h, w)`` of an image of true
    size ``th`` x ``tw`` from 22 uniform draws in [0, 1): ten candidates
    (area share and log aspect ratio each), the first that fits, else the
    centre box at the clamped aspect; then the top and left draws
    (``tpu_loader.py:42-75``)."""
    log_r0, log_r1 = math.log(ratio[0]), math.log(ratio[1])
    for i in range(10):
        area = th * tw * (scale[0] + (scale[1] - scale[0]) * draws[i])
        aspect = math.exp(log_r0 + (log_r1 - log_r0) * draws[10 + i])
        w = round(math.sqrt(area * aspect))
        h = round(math.sqrt(area / aspect))
        if 0 < w <= tw and 0 < h <= th:
            top = math.floor(draws[20] * (th - h + 1.0))
            left = math.floor(draws[21] * (tw - w + 1.0))
            return float(top), float(left), float(h), float(w)
    in_ratio = tw / th
    if in_ratio < ratio[0]:
        w, h = tw, round(tw / ratio[0])
    elif in_ratio > ratio[1]:
        w, h = round(th * ratio[1]), th
    else:
        w, h = tw, th
    return float((th - h) // 2), float((tw - w) // 2), float(h), float(w)


def crop_resize_clamped(imgs: torch.Tensor, boxes: torch.Tensor,
                        dims: torch.Tensor, out_size: Tuple[int, int]
                        ) -> torch.Tensor:
    """Bilinear resized crops of a batch: ``imgs`` ``[B, C, H, W]`` float
    (padded canvases), ``boxes`` ``[B, 4]`` (top, left, height, width in
    pixels of the true image), ``dims`` ``[B, 2]`` each image's true
    (height, width); returns ``[B, C, out_h, out_w]``. Sample coordinates
    are clamped to the true size, so the canvas padding is never read
    (``tpu_loader.py:78-112``, in its order of operations)."""
    out_h, out_w = out_size
    dev = imgs.device
    b, c, hh, ww = imgs.shape
    top, left, height, width = boxes.to(dev, torch.float32).unbind(1)
    th, tw = dims.to(dev, torch.float32).unbind(1)
    ys = torch.arange(out_h, device=dev, dtype=torch.float32)
    xs = torch.arange(out_w, device=dev, dtype=torch.float32)
    gy = top[:, None] + (ys + 0.5) * height[:, None] / out_h - 0.5
    gx = left[:, None] + (xs + 0.5) * width[:, None] / out_w - 0.5
    gy = torch.minimum(torch.clamp(gy, min=0.0), (th - 1.0)[:, None])
    gx = torch.minimum(torch.clamp(gx, min=0.0), (tw - 1.0)[:, None])
    y0 = torch.floor(gy).to(torch.int64)
    x0 = torch.floor(gx).to(torch.int64)
    y1 = torch.minimum(y0 + 1, (th - 1.0).to(torch.int64)[:, None])
    x1 = torch.minimum(x0 + 1, (tw - 1.0).to(torch.int64)[:, None])
    f = imgs.to(torch.float32)

    def rows(y):  # [B, C, out_h, W]
        return torch.gather(f, 2, y[:, None, :, None].expand(b, c, out_h, ww))

    def cols(r, x):  # [B, C, out_h, out_w]
        return torch.gather(r, 3, x[:, None, None, :].expand(b, c, out_h, out_w))

    ly = (gy - y0)[:, None, :, None]
    lx = (gx - x0)[:, None, None, :]
    r0, r1 = rows(y0), rows(y1)
    return (cols(r0, x0) * (1 - ly) * (1 - lx) + cols(r0, x1) * (1 - ly) * lx
            + cols(r1, x0) * ly * (1 - lx) + cols(r1, x1) * ly * lx)


def _world() -> Tuple[int, int]:
    """(rank, world size) of ``torch.distributed`` where it is initialised,
    else (0, 1)."""
    dist = torch.distributed
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


class DeviceJpegLoader:
    """Iterate ``(jpeg bytes or a file path, label)`` samples as batches on
    the card (``TpuJpegLoader``'s arguments and semantics).

    Args:
        samples: a sequence whose items are ``(bytes, label)`` or
            ``(path, label)`` (an ``ImageFolder``'s ``samples``).
        batch_size: images a batch (each batch from one bucket).
        crop_size: the output side.
        train: RandomResizedCrop (``scale``, ``ratio``) + a horizontal flip
            at even odds; else the short side resized to
            ``val_resize_size`` and a centre crop, as one crop box.
        coef_limit: 0 / 8 a full decode; M in 1..7 decodes from the
            top-left M x M coefficients, at M/8 size.
        bucket_blocks: the canvas granularity, in luma blocks.
        drop_remainder: drop each bucket's partial batch at the epoch's end.
        process_index, process_count: this process's shard; by default
            ``torch.distributed``'s rank and world size where it is
            initialised, else 0 and 1. With more than one process every
            process emits exactly ``len(self)`` full batches an epoch.
        apply_exif_orientation: images with an EXIF orientation tag take
            the re-encode lane, upright.
        device: where batches land (None: the card).

    Batches are ``{"image": [B, 3, S, S] float32, "label": [B] int64}`` on
    ``device``. ``stats`` counts this epoch's samples by lane (``offload``,
    ``reencode_fallback``, ``exif_reorient``, ``dropped``), ``stats_total``
    the earlier epochs'; ``buckets`` lists the bucket of each batch of the
    epoch.
    """

    def __init__(
        self,
        samples: Sequence,
        batch_size: int,
        crop_size: int = 224,
        *,
        train: bool = True,
        coef_limit: int = 0,
        val_resize_size: int = 256,
        bucket_blocks: int = 8,
        mean=IMAGENET_MEAN,
        std=IMAGENET_STD,
        scale=(0.08, 1.0),
        ratio=(3.0 / 4.0, 4.0 / 3.0),
        seed: int = 0,
        drop_remainder: bool = False,
        process_index: Optional[int] = None,
        process_count: Optional[int] = None,
        apply_exif_orientation: bool = False,
        device: Union[str, torch.device, None] = None,
    ):
        self.samples = samples
        self.batch_size = batch_size
        self.crop_size = crop_size
        self.train = train
        self.coef_limit = coef_limit
        self.val_resize_size = val_resize_size
        self.bucket_blocks = bucket_blocks
        self.mean = tuple(float(x) for x in mean)
        self.std = tuple(float(x) for x in std)
        self.scale = tuple(scale)
        self.ratio = tuple(ratio)
        self.seed = seed
        self._base_seed = seed
        self.drop_remainder = drop_remainder
        self.apply_exif_orientation = apply_exif_orientation
        self.device = resolve_device(device)
        self._m = coef_limit if 0 < coef_limit < 8 else 8
        self.stats = dict.fromkeys(_LANES, 0)
        self.stats_total: Dict[str, int] = {}
        self.drop_reasons: List[Tuple[int, str]] = []
        self.buckets: List[tuple] = []
        rank, world = _world()
        self.process_index = rank if process_index is None else process_index
        self.process_count = world if process_count is None else process_count
        self._norm: Dict[torch.device, Tuple[torch.Tensor, torch.Tensor]] = {}
        self._recycled = _Recycled()

    @property
    def offload_hit_rate(self) -> float:
        """The share of this epoch's samples whose entropy decode fed the
        card directly (1.0: all of them)."""
        total = sum(self.stats.values())
        return self.stats["offload"] / total if total else 1.0

    def _shard_len(self) -> int:
        return -(-len(self.samples) // max(self.process_count, 1))

    def __len__(self) -> int:
        return max(self._shard_len() // self.batch_size, 1)

    def set_epoch(self, epoch: int) -> None:
        """Reseed the shuffle and the draws for ``epoch``."""
        self.seed = self._base_seed + epoch

    # ------------------------------------------------------- host side
    def _bucket_key(self, coef_shapes, samp):
        bh, bw = coef_shapes[0][:2]
        g = self.bucket_blocks
        return (-(-bh // g) * g, -(-bw // g) * g,
                tuple(tuple(s) for s in samp), len(coef_shapes))

    def _read(self, index: int):
        data, label = self.samples[index]
        if isinstance(data, (str, os.PathLike)):
            with open(data, "rb") as f:
                data = f.read()
        return bytes(data), int(label)

    def _offload(self, data: bytes):
        """The coefficients of a stream the codec reads, decoded into
        recycled arrays of the frame's shapes; None where it refuses it."""
        frame = _codecs.jpeg_frame(data)
        if frame is None or len(frame[1]) == 4 or not pixel_sampling(frame[1]):
            return None
        out = [self._recycled.take(s) for s in coef_shapes(*frame, self.coef_limit)]
        rc, r = _codecs.jpeg_coefficients_code(data, self.coef_limit, out=out)
        if rc != 0:
            self._recycled.give(out)
            return None
        return r

    def _coefficients(self, index: int):
        """``(lane, coefficients or the error, label)`` of one sample; runs
        on a decode thread."""
        data, label = self._read(index)
        reorient = (self.apply_exif_orientation
                    and _exif.parse_jpeg_exif_orientation(data) > 1)
        if not reorient:
            r = self._offload(data)
            if r is not None:
                return "offload", r, label
        try:
            img = decode_image(data, device="cpu", apply_exif_orientation=reorient)
            if img.ndim == 4:  # an animation: its first frame
                img = img[0]
            if img.shape[0] not in (1, 3):  # alpha: dropped, as JPEG has none
                img = _apply_mode(img, ImageReadMode.RGB)
            rc, r = _codecs.jpeg_coefficients_code(
                encode_jpeg(img, REENCODE_QUALITY), self.coef_limit)
            if rc != 0:
                raise RuntimeError(_codecs.stream_error(rc))
        except (RuntimeError, ValueError) as e:
            return "dropped", f"{type(e).__name__}: {e}", label
        return ("exif_reorient" if reorient else "reencode_fallback"), r, label

    def _decoded(self, order) -> Iterator[Tuple[int, object, int]]:
        """``(index, coefficients or None, label)`` in ``order``, each
        sample decoded on the pool's threads up to ``AHEAD_BATCHES``
        batches ahead; samples not started when the caller stops are
        cancelled."""
        pool = decode_pool()
        todo = iter(int(i) for i in order)
        pending: collections.deque = collections.deque()

        def top_up():
            while len(pending) < AHEAD_BATCHES * self.batch_size:
                i = next(todo, None)
                if i is None:
                    return
                pending.append((i, pool.submit(self._coefficients, i)))

        try:
            top_up()
            while pending:
                idx, future = pending.popleft()
                lane, r, label = future.result()
                top_up()
                self.stats[lane] += 1
                if lane == "dropped":
                    self.drop_reasons.append((idx, r))
                    r = None
                yield idx, r, label
        finally:
            for _, future in pending:
                future.cancel()

    def _draws(self, gen: torch.Generator, dims: List[Tuple[int, int]]):
        """Each image's crop box and flip, Python numbers from ``gen``."""
        boxes, flips = [], []
        for th, tw in dims:
            if self.train:
                u = torch.rand(23, generator=gen, dtype=torch.float64).tolist()
                boxes.append(rrc_box(th, tw, u[:22], self.scale, self.ratio))
                flips.append(u[22] < 0.5)
            else:
                side = min(th, tw) * self.crop_size / float(self.val_resize_size)
                boxes.append(((th - side) / 2.0, (tw - side) / 2.0, side, side))
                flips.append(False)
        return boxes, flips

    def __iter__(self) -> Iterator[Dict[str, torch.Tensor]]:
        for k, v in self.stats.items():
            self.stats_total[k] = self.stats_total.get(k, 0) + v
        self.stats = dict.fromkeys(_LANES, 0)
        self.drop_reasons = []
        self.buckets = []
        rng = np.random.RandomState(self.seed)
        n = len(self.samples)
        order = rng.permutation(n) if self.train else np.arange(n)
        lockstep = self.process_count > 1
        if lockstep:
            # wrap-around duplicates make every shard equal (the reference
            # DistributedSampler), then this process's strided slice
            total = self._shard_len() * self.process_count
            if total > len(order):
                order = np.concatenate([order, order[:total - len(order)]])
            order = order[self.process_index::self.process_count]
        steps = len(self) if lockstep else None
        gen = torch.Generator().manual_seed(
            (self.seed << 16) + self.process_index)
        emitted = 0
        buckets: Dict[tuple, list] = {}
        for _, r, label in self._decoded(order):
            if r is None:
                continue
            coefs, qtabs, samp, hw = r
            bk = self._bucket_key([c.shape for c in coefs], samp)
            buckets.setdefault(bk, []).append((coefs, qtabs, hw, label))
            if len(buckets[bk]) == self.batch_size:
                yield self._emit(bk, buckets.pop(bk), gen)
                emitted += 1
                if steps is not None and emitted >= steps:
                    return
        if steps is None:
            if not self.drop_remainder:
                for bk, items in buckets.items():
                    yield self._emit(bk, items, gen)
            return
        # lockstep top-up: the largest partial buckets filled to whole
        # batches with their own samples until every process has emitted
        # len(self) batches
        for bk, items in sorted(buckets.items(), key=lambda kv: -len(kv[1])):
            if emitted >= steps:
                break
            reps = -(-self.batch_size // len(items))
            yield self._emit(bk, (items * reps)[:self.batch_size], gen)
            emitted += 1
        if emitted < steps:
            raise RuntimeError(
                f"lockstep underrun: emitted {emitted} of {steps} batches "
                f"(dropped={self.stats['dropped']}); the shard lost too many "
                "samples to streams that neither lane reads")

    def stage(self, bk, items):
        """One bucket's host tensors: ``(coefs, qtabs, dims, labels)`` with
        each image's coefficients edge-replicated over the canvas (zero
        blocks would decode to grey, which the chroma upsampling would
        blend into the last row and column), pinned where the batch is
        bound for the card; ``dims`` each image's true size at the decoded
        scale."""
        cbh, cbw, samp, ncomp = bk
        m = self._m
        pin = self.device.type == "cuda"
        hmax = max(s[0] for s in samp)
        vmax = max(s[1] for s in samp)
        coefs, qtabs = [], []
        for ci in range(ncomp):
            sh, sv = samp[ci]
            tbh, tbw = -(-cbh * sv // vmax), -(-cbw * sh // hmax)
            out = torch.empty((len(items), tbh, tbw, m * m), dtype=torch.int16,
                              pin_memory=pin)
            arr = out.numpy()
            for i, it in enumerate(items):
                c = it[0][ci]
                bh, bw = c.shape[:2]
                arr[i, :bh, :bw] = c
                arr[i, bh:, :bw] = c[bh - 1:bh]
                arr[i, :, bw:] = arr[i, :, bw - 1:bw]
            coefs.append(out)
            q = torch.empty((len(items), 64), dtype=torch.float32, pin_memory=pin)
            q.numpy()[:] = np.stack([it[1][ci] for it in items])
            qtabs.append(q)
        dims = [(-(-it[2][0] * m // 8), -(-it[2][1] * m // 8)) for it in items]
        labels = torch.tensor([it[3] for it in items], dtype=torch.int64)
        return coefs, qtabs, dims, labels

    def _emit(self, bk, items, gen):
        self.buckets.append(bk)
        coefs, qtabs, dims, labels = self.stage(bk, items)
        # a lockstep top-up repeats items: give each array back once
        self._recycled.give({id(c): c for it in items for c in it[0]}.values())
        boxes, flips = self._draws(gen, dims)
        return self.device_batch(coefs, qtabs, dims, labels, boxes, flips, bk)

    # ----------------------------------------------------- device side
    def device_batch(self, coefs, qtabs, dims, labels, boxes, flips, bk):
        """The per-bucket program: the staged coefficients to ``device``
        without waiting, decoded at the canvas, cropped, flipped where
        ``flips`` says, normalised. ``boxes`` / ``dims`` are Python numbers
        or tensors; JAX's boxes can be handed in here."""
        dev = self.device
        cbh, cbw, samp, _ = bk
        imgs = decode_coefs([c.to(dev, non_blocking=True) for c in coefs],
                            [q.to(dev, non_blocking=True) for q in qtabs],
                            cbh * 8, cbw * 8, samp)
        boxes = torch.as_tensor(boxes, dtype=torch.float32)
        dims = torch.as_tensor(dims, dtype=torch.float32)
        flips = torch.as_tensor(flips, dtype=torch.bool)
        if dev.type == "cuda":
            boxes, dims, flips = (t.pin_memory().to(dev, non_blocking=True)
                                  for t in (boxes, dims, flips))
        out = crop_resize_clamped(imgs, boxes, dims,
                                  (self.crop_size, self.crop_size))
        out = torch.where(flips.to(dev)[:, None, None, None], out.flip(-1), out)
        mean, std = self._mean_std(dev)
        return {"image": (out - mean) / std,
                "label": labels.to(dev, non_blocking=dev.type == "cuda")}

    def _mean_std(self, dev):
        if dev not in self._norm:
            self._norm[dev] = tuple(
                (torch.tensor(v, dtype=torch.float32) * 255.0).view(1, 3, 1, 1).to(dev)
                for v in (self.mean, self.std))
        return self._norm[dev]
