"""The port's prefetch queue (``vision_tpu_torch.io.prefetch``) on the CPU:
the batches come out in order and whole, the producer runs no more than
the queues hold ahead of the consumer, a producer's exception reaches the
consumer, and on a host with one CPU a single worker does both stages, as
``vision_tpu/io/prefetch.py`` does. The pinned copies and the side stream
run only on the card (``tests/test_torch_io_cuda.py`` and
``chip_smoke.py``'s e2e phases)."""

import functools
import threading
import time

import numpy as np
import pytest
import torch

from vision_tpu_torch.io import prefetch
from vision_tpu_torch.io.prefetch import PrefetchIterator, decode_batch, prefetch_to_device


def batches(n, seed=0):
    rng = np.random.RandomState(seed)
    return [rng.randint(0, 256, (2, 4, 5, 3)).astype(np.uint8) for _ in range(n)]


def test_batches_come_out_in_order_as_tensors():
    want = batches(20)
    got = list(prefetch_to_device(iter(want), depth=2, device="cpu"))
    assert len(got) == 20
    for g, w in zip(got, want):
        assert isinstance(g, torch.Tensor) and g.dtype == torch.uint8
        np.testing.assert_array_equal(g.numpy(), w)


def test_nested_batches_keep_their_structure():
    src = [({"image": b, "label": np.arange(2)}, torch.full((3,), i))
           for i, b in enumerate(batches(5))]
    got = list(prefetch_to_device(src, device="cpu"))
    for i, ((d, t), (sd, st)) in enumerate(zip(got, src)):
        assert set(d) == {"image", "label"}
        assert torch.equal(d["image"], torch.from_numpy(sd["image"]))
        assert torch.equal(d["label"], torch.arange(2))
        assert torch.equal(t, st)


@pytest.mark.parametrize("depth", [1, 2, 4])
def test_depth_bounds_how_far_the_producer_runs_ahead(depth):
    """With the consumer holding one batch, the producer has made at most
    the two queues' ``depth`` each, one batch each thread holds, and the
    consumer's: ``2 * depth + 3``, however long it waits."""
    made = []

    def source():
        for b in batches(50):
            made.append(1)
            yield b

    it = prefetch_to_device(source(), depth=depth, device="cpu")
    next(it)
    deadline = time.monotonic() + 10.0
    while len(made) < depth + 1 and time.monotonic() < deadline:
        time.sleep(0.01)  # the producer runs ahead of the consumer ...
    time.sleep(0.2)
    assert depth + 1 <= len(made) <= 2 * depth + 3  # ... and no further
    assert len(list(it)) == 49


def test_a_producers_exception_reaches_the_consumer():
    def source():
        yield from batches(3)
        raise ValueError("decode failed")

    it = prefetch_to_device(source(), device="cpu")
    got = [next(it) for _ in range(3)]
    assert len(got) == 3
    with pytest.raises(ValueError, match="decode failed"):
        next(it)


def test_one_cpu_runs_one_worker(monkeypatch):
    """``os.cpu_count() == 1``: one background thread decodes and lands the
    batches (the two stages would thrash the one CPU); same order, same
    exception surfacing."""
    monkeypatch.setattr(prefetch.os, "cpu_count", lambda: 1)
    started = []
    real = threading.Thread.start

    def start(self):
        if "PrefetchIterator" in getattr(self._target, "__qualname__", ""):
            started.append(self)
        real(self)

    monkeypatch.setattr(threading.Thread, "start", start)
    want = batches(6)
    got = list(PrefetchIterator(want, depth=2, device="cpu"))
    assert len(started) == 1
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), w)

    def source():
        yield want[0]
        raise KeyError("boom")

    with pytest.raises(KeyError, match="boom"):
        list(PrefetchIterator(source(), device="cpu"))


def test_depth_must_be_positive():
    with pytest.raises(ValueError, match="depth"):
        PrefetchIterator([], depth=0, device="cpu")


def test_default_device_is_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        prefetch_to_device(batches(1))


def test_decode_batch_keeps_the_order_across_threads():
    def slow_identity(x):
        time.sleep(0.01 * (5 - x % 5))
        return x * 2

    assert decode_batch(list(range(20)), slow_identity, num_threads=4) == [
        2 * i for i in range(20)]


def test_decode_batch_on_the_host_is_decode_jpeg_of_the_list():
    """``decode_batch`` with ``decode_image`` on the CPU: each stream's own
    host decode, in order, whatever thread decoded it."""
    from vision_tpu_torch.io import decode_image, decode_jpeg, encode_jpeg

    rng = np.random.RandomState(3)
    streams = [encode_jpeg(torch.from_numpy(
        rng.randint(0, 256, (3, 24 + 8 * i, 40), dtype=np.uint8)), 80)
        for i in range(6)]
    got = decode_batch(streams, functools.partial(decode_image, device="cpu"),
                       num_threads=3)
    for g, w in zip(got, decode_jpeg(streams, device="cpu")):
        assert torch.equal(g, w)


@pytest.mark.parametrize("donate", [False, True])
def test_donate_pinned_changes_nothing_on_the_cpu(donate):
    """On the CPU no batch is staged or copied, donated or not: the
    batches are the loader's own tensors."""
    want = [torch.from_numpy(b) for b in batches(4)]
    got = list(prefetch_to_device(want, device="cpu", donate_pinned=donate))
    assert all(g is w for g, w in zip(got, want))
