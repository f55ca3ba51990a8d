"""The port's image IO on the card: the pinned prefetch queue and the
decode's tail on the card. Marked ``cuda``; every test skips where no
CUDA device is present (decided inside the fixture). Run on a GPU host
with:

    python -m pytest tests/test_torch_io_cuda.py -m cuda

Tolerances: the queue's batches exactly equal to the host's, also where
the loader refills one pinned buffer; the card's
decode within one count of the host decode (the same float arithmetic in
another order).
"""

from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch

from vision_tpu_torch.io import decode_jpeg, prefetch_to_device
from vision_tpu_torch.tools import imagenet_e2e as e2e

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("requires a CUDA device")
    return torch.device("cuda")


def test_prefetch_lands_batches_on_the_card_in_order(dev):
    rng = np.random.RandomState(0)
    want = [rng.randint(0, 256, (4, 30, 40, 3)).astype(np.uint8) for _ in range(9)]
    pinned = torch.empty((4, 30, 40, 3), dtype=torch.uint8, pin_memory=True)
    pinned.copy_(torch.from_numpy(want[0]))
    got = list(prefetch_to_device([pinned] + want[1:], depth=2, device=dev))
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        assert g.device.type == "cuda"
        np.testing.assert_array_equal(g.cpu().numpy(), w)


def test_prefetch_stages_a_refilled_pinned_buffer(dev):
    """A loader that refills one pinned buffer for every batch, as soon as
    it is asked for the next: the queue stages each batch into a block of
    its own before it asks, so every batch lands with its own contents,
    though the copies of 64 MiB to the card are still in flight when the
    loader writes again."""
    buf = torch.empty((64, 1024, 1024), dtype=torch.uint8, pin_memory=True)

    def loader():
        for b in range(12):
            buf.fill_(b)
            yield buf

    got = list(prefetch_to_device(loader(), depth=3, device=dev))
    torch.cuda.synchronize()
    for b, g in enumerate(got):
        assert int(g.min()) == int(g.max()) == b


def test_prefetch_takes_donated_pinned_batches_as_they_are(dev):
    """``donate_pinned``: batches decoded into new pinned memory go to the
    card with no host copy, whole and in order."""
    jpegs = e2e.make_jpegs(6, 75, 99)
    with ThreadPoolExecutor(2) as pool:
        want = list(e2e.host_decode_batches(jpegs, 4, 5, pool))
        got = list(prefetch_to_device(e2e.host_decode_batches(
            jpegs, 4, 5, pool, pin=True), device=dev, donate_pinned=True))
    torch.cuda.synchronize()
    assert len(got) == 5
    for g, w in zip(got, want):
        assert g.device.type == "cuda" and torch.equal(g.cpu(), w)


def test_pipelines_make_no_host_synchronisation_per_batch(dev):
    """Under the sync debug mode "error" any PyTorch operation that waits
    for the card raises: the queue's copies and hand-over, the card's
    decode of a coefficient batch, ``decode_jpeg`` of a list on the card
    and the preprocessing make none, once their constants are on the card
    (one warm-up batch)."""
    jpegs = e2e.make_jpegs(4, 96, 128)
    with ThreadPoolExecutor(2) as pool:

        def steps(batches):
            for coefs in prefetch_to_device(batches, device=dev,
                                            donate_pinned=True):
                e2e.preprocess(e2e.decode_on_device(coefs), nhwc=False)
            for raw in prefetch_to_device(e2e.host_decode_batches(
                    jpegs, 4, 2, pool, pin=True), device=dev):
                e2e.preprocess(raw)
            decode_jpeg(jpegs, scale=(5, 8), device=dev)

        steps(e2e.coef_batches(jpegs, 4, 1, pool, pin=True))
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            steps(e2e.coef_batches(jpegs, 4, 3, pool, pin=True))
        finally:
            torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()


def test_card_decode_within_one_count_of_the_host_decode(dev):
    jpegs = e2e.make_jpegs(6, 75, 99)
    for scale in (None, (5, 8)):
        card = decode_jpeg(jpegs, scale=scale, device=dev)
        host = decode_jpeg(jpegs, scale=scale, device="cpu")
        for c, h in zip(card, host):
            assert c.device.type == "cuda" and c.shape == h.shape
            assert int((c.cpu().int() - h.int()).abs().max()) <= 1
