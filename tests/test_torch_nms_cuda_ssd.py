"""The bitmask NMS kernel at SSD300's candidate count, on the card: one
image of 36,000 score-sorted boxes in 90 labels (the top 400 of each
foreground class, ``ssd.SSD.postprocess_detections``), moved apart by
``batched_nms_mask``'s offsets, IoU threshold 0.45. Its keep mask is held
against the plain version's (``nms_keep_sorted_plain``, on the card: its
N x N matrix and intermediates take some 35 GB), exactly. Marked
``cuda``; skips where no CUDA device is present (decided in the fixture).
Run on a GPU host with:

    python -m pytest tests/test_torch_nms_cuda_ssd.py -m cuda --noconftest
"""

import numpy as np
import pytest
import torch

from vision_tpu_torch.ops.nms import (
    batched_nms_mask,
    nms_keep_sorted_cuda,
    nms_keep_sorted_plain,
    nms_mask,
)

pytestmark = pytest.mark.cuda

CLASSES = 90
PER_CLASS = 400


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("requires a CUDA device")
    return torch.device("cuda")


def _ssd_candidates(seed: int):
    """One image's candidates as SSD's postprocess lays them: per class its
    top 400 boxes (clustered about a few centres on a 300 canvas, so that
    boxes of one class overlap at every IoU), scores descending within a
    class and about a fifth of them under the 0.01 threshold."""
    rng = np.random.RandomState(seed)
    centres = rng.uniform(20, 280, (CLASSES, 6, 2))
    pick = rng.randint(0, 6, (CLASSES, PER_CLASS))
    xy = centres[np.arange(CLASSES)[:, None], pick] + rng.randn(CLASSES, PER_CLASS, 2) * 15
    wh = rng.uniform(8, 120, (CLASSES, PER_CLASS, 2))
    boxes = np.clip(np.concatenate([xy - wh / 2, xy + wh / 2], -1), 0, 300)
    scores = -np.sort(-rng.beta(0.6, 6.0, (CLASSES, PER_CLASS)), axis=1)
    labels = np.repeat(np.arange(1, CLASSES + 1), PER_CLASS)
    return (torch.from_numpy(boxes.reshape(-1, 4).astype(np.float32)),
            torch.from_numpy(scores.reshape(-1).astype(np.float32)),
            torch.from_numpy(labels))


@pytest.mark.parametrize("seed", [0, 1])
def test_nms_kernel_at_ssd_candidate_count(dev, seed):
    boxes, scores, labels = _ssd_candidates(seed)
    valid = scores > 0.01
    assert boxes.shape == (36_000, 4) and 0.5 < float(valid.float().mean()) < 0.95
    boxes, scores, labels, valid = (t.to(dev) for t in (boxes, scores, labels, valid))
    before = nms_keep_sorted_cuda.launches
    got = batched_nms_mask(boxes, scores, labels, 0.45, valid=valid)
    torch.cuda.synchronize()
    assert nms_keep_sorted_cuda.launches == before + 1
    # the same problem for the plain version: offsets, sort and mask as
    # batched_nms_mask builds them
    max_coord = torch.where(valid[:, None], boxes, torch.zeros_like(boxes)).max()
    shifted = boxes + (labels.float() * (max_coord + 1.0))[:, None]
    masked = torch.where(valid, scores, torch.full_like(scores, -torch.inf))
    order = torch.sort(masked, descending=True, stable=True).indices
    sboxes = torch.where(valid[order, None], shifted[order], torch.zeros_like(boxes))
    keep_sorted = nms_keep_sorted_plain(sboxes[None], valid[order][None], 0.45)[0]
    want = torch.zeros_like(keep_sorted).scatter_(0, order, keep_sorted)
    assert torch.equal(got, want)
    kept = int(want.sum())
    assert 0 < kept < int(valid.sum())  # some boxes suppressed
    # the kernel through the presorted entry point: the same mask
    again = nms_mask(sboxes, masked[order], 0.45, valid=valid[order],
                     presorted=True)
    assert torch.equal(again, keep_sorted)
