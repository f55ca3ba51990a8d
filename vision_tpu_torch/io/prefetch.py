"""Host -> card prefetch queue (counterpart of ``vision_tpu/io/prefetch.py``).

Throughput comes from fanning JPEG decoding across host threads (the
codec releases the interpreter lock inside each ctypes call) and from
overlapping the transfer of batch N+1 with the card's work on batch N.

Two stages run in threads of their own: a producer that pulls host batches
from the caller's iterable and, bound for the card, copies each into a
pinned block that the queue owns before it asks for the next; and a
transfer thread that copies each block to the card with ``non_blocking``
copies on a side CUDA stream, then records an event. So a loader may
refill its own buffers as soon as it is asked for the next batch. A
loader that allocates each batch anew in pinned memory (as
``jpeg_device.host_decode_batch(..., pin=True)`` does) may donate it
(``donate_pinned=True``): it is then copied to the card from where it lies,
with no host copy, and must not be written again. The consumer's stream
waits on that event (on the card, not on the host) and each tensor is
marked as used on the consumer's stream (``record_stream``), so the
caching allocator does not hand its memory to the side stream while the
consumer still reads it. Nothing synchronises the host per batch. On a
host with one CPU the two stages thrash it, so one worker thread does
both, as in the JAX module. Sharding is not ported: one card.
"""

from __future__ import annotations

import os
import queue
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Callable, Iterable, Iterator, Optional, Union

import numpy as np
import torch

from vision_tpu_torch.models._api import resolve_device

__all__ = ["PrefetchIterator", "decode_batch", "prefetch_to_device"]


def decode_batch(
    buffers: Iterable[bytes],
    decode_fn: Optional[Callable[[bytes], Any]] = None,
    num_threads: int = 8,
) -> list:
    """Decode a batch of compressed images across ``num_threads`` host
    threads, in order. ``decode_fn`` defaults to ``decode_image``, which
    decodes on the card and raises without CUDA; pass
    ``functools.partial(decode_image, device="cpu")`` for the host."""
    if decode_fn is None:
        from vision_tpu_torch.io.image import decode_image

        resolve_device(None)  # raise before any thread starts
        decode_fn = decode_image
    with ThreadPoolExecutor(max_workers=num_threads) as pool:
        return list(pool.map(decode_fn, buffers))


def _tree_map(fn, batch):
    if isinstance(batch, (torch.Tensor, np.ndarray)):
        return fn(batch)
    if isinstance(batch, dict):
        return {k: _tree_map(fn, v) for k, v in batch.items()}
    if isinstance(batch, (list, tuple)):
        return type(batch)(_tree_map(fn, v) for v in batch)
    return batch


def _tensors(batch) -> list:
    out = []
    _tree_map(lambda t: out.append(t), batch)
    return out


class PrefetchIterator:
    """Wrap a host batch iterable (tensors or numpy arrays, alone or in
    tuples, lists and dicts); background threads stay up to ``depth``
    batches ahead and land them on ``device`` (the card unless the caller
    asks for the CPU, where batches become tensors and move nowhere). With
    ``donate_pinned`` a tensor in pinned memory is handed over to the
    queue, which copies it to the card without a host copy: the caller
    must not write to it again."""

    _SENTINEL = object()

    def __init__(self, iterable: Iterable[Any], depth: int = 2,
                 device: Union[str, torch.device, None] = None,
                 donate_pinned: bool = False):
        if depth < 1:
            raise ValueError(f"depth must be at least 1, got {depth}")
        self._iterable = iterable
        self._depth = depth
        self._donate_pinned = donate_pinned
        self._device = resolve_device(device)
        self._stream = (torch.cuda.Stream(self._device)
                        if self._device.type == "cuda" else None)

    def _stage(self, batch):
        """Arrays become tensors; bound for the card, every tensor is copied
        into a pinned block of the queue's own (a donated pinned one is
        taken as it is), so the loader may write its buffers again."""
        def host(x):
            t = torch.from_numpy(x) if isinstance(x, np.ndarray) else x
            if (self._stream is None or t.device.type != "cpu"
                    or (self._donate_pinned and t.is_pinned())):
                return t
            pinned = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
            return pinned.copy_(t)

        return _tree_map(host, batch)

    def _put(self, batch):
        """Land a staged batch on the device: on the card, ``(batch,
        event)``, the event recorded on the side stream after the copies."""
        if self._stream is None:
            return batch, None

        def to_device(t):
            # the pinned block goes back to the caching host allocator only
            # once the copy that reads it has finished on the side stream
            return t.to(self._device, non_blocking=True)

        with torch.cuda.stream(self._stream):
            out = _tree_map(to_device, batch)
            event = torch.cuda.Event()
            event.record(self._stream)
        return out, event

    def _hand_over(self, item):
        batch, event = item
        if event is not None:
            consumer = torch.cuda.current_stream(self._device)
            consumer.wait_event(event)
            for t in _tensors(batch):
                t.record_stream(consumer)
        return batch

    def __iter__(self) -> Iterator[Any]:
        if os.cpu_count() == 1:
            yield from self._iter_single_worker()
            return
        q_host: "queue.Queue" = queue.Queue(maxsize=self._depth)
        q_dev: "queue.Queue" = queue.Queue(maxsize=self._depth)
        err = []
        put = self._put

        def producer():
            try:
                for batch in self._iterable:
                    q_host.put(self._stage(batch))
            except Exception as e:  # surfaced on the consumer's side
                err.append(e)
            finally:
                q_host.put(self._SENTINEL)

        def transfer():
            try:
                while True:
                    batch = q_host.get()
                    if batch is self._SENTINEL:
                        break
                    q_dev.put(put(batch))
            except Exception as e:
                err.append(e)
            finally:
                q_dev.put(self._SENTINEL)

        for fn in (producer, transfer):
            threading.Thread(target=fn, daemon=True).start()
        while True:
            item = q_dev.get()
            if item is self._SENTINEL:
                if err:
                    raise err[0]
                return
            yield self._hand_over(item)

    def _iter_single_worker(self) -> Iterator[Any]:
        """One background thread produces and lands each batch; the
        consumer still overlaps the card's work with the next batch."""
        q_dev: "queue.Queue" = queue.Queue(maxsize=self._depth)
        err = []
        put = self._put

        def worker():
            try:
                for batch in self._iterable:
                    q_dev.put(put(self._stage(batch)))
            except Exception as e:
                err.append(e)
            finally:
                q_dev.put(self._SENTINEL)

        threading.Thread(target=worker, daemon=True).start()
        while True:
            item = q_dev.get()
            if item is self._SENTINEL:
                if err:
                    raise err[0]
                return
            yield self._hand_over(item)


def prefetch_to_device(iterable, depth: int = 2,
                       device: Union[str, torch.device, None] = None,
                       donate_pinned: bool = False):
    """``for batch in prefetch_to_device(loader): ...``"""
    return iter(PrefetchIterator(iterable, depth=depth, device=device,
                                 donate_pinned=donate_pinned))
