"""The rest of ``ops/`` and the v2 detectors on the card. Marked ``cuda``;
every test skips where no CUDA device is present (the decision is made
inside the fixture, never at import). Run on a GPU host with:

    python -m pytest tests/test_torch_rcnn_v2_cuda.py -m cuda --noconftest

Tolerances: each op on the card against the same call on CPU tensors
(the random ones handed the same draws), forward and input gradient,
within 1e-5 of the largest CPU value; ``ps_roi_align`` at a fixed
sampling ratio and the random ops make no host synchronisation. A small v2
Faster and Mask R-CNN (ResNet-18, 5 classes, a 256x320 canvas) served on
the card launch the NMS, window-pool and RoIAlign kernels and give the CPU
model's detections (TF32 off): valid rows equal, scores within 1e-4, each
row's box within 1e-2 px of a row of the CPU's with its label and a score
within twice the largest score error (near-tied scores may come out in
either order), masks within 1e-4 of the CPU model's at the card's own
boxes and labels. (With cuDNN's default TF32 the scores read 1.1e-4 and
the masks 7.6e-3 apart.) one train step launches the two backward kernels too and moves
the trunk's and box head's running statistics and not the FPN's or the
mask head's.
"""

import numpy as np
import pytest
import torch

from vision_tpu_torch import ops
from vision_tpu_torch.models.detection.faster_rcnn import FasterRCNN, init_weights
from vision_tpu_torch.models.detection.mask_rcnn import MaskRCNN
from vision_tpu_torch.ops.drop_block import drop_block_seeds
from vision_tpu_torch.ops.misc import BatchNorm2d
from vision_tpu_torch.ops.nms import nms_keep_sorted_cuda
from vision_tpu_torch.ops.poolers import window_pool_backward_cuda, window_pool_cuda
from vision_tpu_torch.ops.roi_align import roi_align_backward_cuda, roi_align_cuda
from vision_tpu_torch.ops.stochastic_depth import stochastic_depth_keep
from vision_tpu_torch.tools.detection_request import ellipse_masks

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    """The card, with TF32 off (cuDNN's convolutions take it by default),
    so that the card computes in f32 as the CPU does."""
    if not torch.cuda.is_available():
        pytest.skip("requires a CUDA device")
    flags = (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    yield torch.device("cuda")
    torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = flags


def _rois(n, images, height, width, seed):
    g = torch.Generator().manual_seed(seed)
    side = torch.exp(torch.empty(n, 2).uniform_(np.log(8), np.log(400), generator=g))
    xy = torch.rand(n, 2, generator=g) * torch.tensor([width, height]) - 20
    b = torch.randint(0, images, (n, 1), generator=g).float()
    return torch.cat([b, xy, xy + side], 1)


def _close(got, want, rel=1e-5):
    err = float((got.detach().cpu() - want.detach()).abs().max())
    assert err <= rel * float(want.abs().max()), err


POOLERS = {
    "roi_pool": (lambda x, r: ops.roi_pool(x, r, 7, 1 / 16), 64),
    "ps_roi_pool": (lambda x, r: ops.ps_roi_pool(x, r, 7, 1 / 16), 2 * 49),
    "ps_roi_align_sr2": (lambda x, r: ops.ps_roi_align(x, r, 7, 1 / 16, 2), 2 * 49),
    "ps_roi_align_sr0": (lambda x, r: ops.ps_roi_align(x, r, 7, 1 / 16, 0), 2 * 49),
}


@pytest.mark.parametrize("name", list(POOLERS))
def test_pooler_on_card_matches_cpu(dev, name):
    fn, channels = POOLERS[name]
    g = torch.Generator().manual_seed(1)
    x = torch.randn(2, channels, 38, 50, generator=g)
    rois = _rois(200, 2, 600, 800, 2)
    xc = x.clone().requires_grad_()
    want = fn(xc, rois)
    cot = torch.randn(want.shape, generator=g)
    want.backward(cot)
    xd = x.to(dev).requires_grad_()
    got = fn(xd, rois.to(dev))
    got.backward(cot.to(dev))
    _close(got, want)
    _close(xd.grad, xc.grad)


@pytest.mark.parametrize("name", ["drop_block2d", "stochastic_depth"])
def test_random_ops_on_card_match_cpu(dev, name):
    x = torch.randn(4, 16, 28, 28, generator=torch.Generator().manual_seed(3))
    g = torch.Generator(device=dev).manual_seed(4)
    if name == "drop_block2d":
        draws = drop_block_seeds(x.shape, 0.2, 5, g, dev)
        assert draws.is_cuda

        def fn(t, d):
            return ops.drop_block2d(t, 0.2, 5, seeds=d)
    else:
        draws = stochastic_depth_keep(x.shape, 0.3, "row", g, dev)

        def fn(t, d):
            return ops.stochastic_depth(t, 0.3, "row", keep=d)
    xc = x.clone().requires_grad_()
    want = fn(xc, draws.cpu())
    want.backward(torch.ones_like(want))
    xd = x.to(dev).requires_grad_()
    got = fn(xd, draws)
    got.backward(torch.ones_like(got))
    _close(got, want)
    _close(xd.grad, xc.grad)
    # drawing on the card from a card generator, and ps_roi_align at a
    # fixed sampling ratio: no host synchronisation
    maps = torch.randn(1, 98, 20, 20, device=dev)
    rois = _rois(10, 1, 300, 300, 5).to(dev)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        if name == "drop_block2d":
            ops.drop_block2d(xd.detach(), 0.2, 5, generator=g)
        else:
            ops.stochastic_depth(xd.detach(), 0.3, "row", generator=g)
        ops.ps_roi_align(maps, rois, 7, 1 / 16, 2)
    finally:
        torch.cuda.set_sync_debug_mode("default")


def _counts():
    return [f.launches for f in (nms_keep_sorted_cuda, window_pool_cuda,
                                 roi_align_cuda, window_pool_backward_cuda,
                                 roi_align_backward_cuda)]


def _same_detections(got, want, score_tol, box_tol):
    """The same valid rows; each valid row of ``got`` within ``box_tol`` of
    a valid row of ``want`` in its image with its label and a score within
    twice the largest score error (near-tied scores may come out in either
    order on the card and on the CPU), the scores within ``score_tol``."""
    got = [t.cpu() for t in got]
    assert torch.equal(got[3], want.valid)
    valid = want.valid
    err = float((got[1][valid] - want.scores[valid]).abs().max())
    assert err <= score_tol, err
    for b in range(valid.shape[0]):
        v = valid[b]
        pair = ((got[2][b][v][:, None] == want.labels[b][v][None, :])
                & ((got[1][b][v][:, None] - want.scores[b][v][None, :]).abs()
                   <= 2 * err))
        dist = (got[0][b][v][:, None] - want.boxes[b][v][None]).abs().amax(-1)
        dist = torch.where(pair, dist, torch.full_like(dist, float("inf")))
        assert float(dist.amin(1).max()) <= box_tol


def _stats(model):
    return {f"{mn}.{bn}": b.detach().cpu().clone()
            for mn, m in model.named_modules() if isinstance(m, BatchNorm2d)
            for bn, b in m.named_buffers(recurse=False) if "running" in bn}


@pytest.mark.parametrize("cls", [FasterRCNN, MaskRCNN], ids=["faster", "mask"])
def test_v2_serve_and_train_step_on_card(dev, cls):
    cfg = dict(backbone_depth=18, num_classes=5, v2=True)
    cpu = cls(**cfg)
    init_weights(cpu, torch.Generator().manual_seed(0))
    cpu.eval()
    card = cls(**cfg)
    card.load_state_dict(cpu.state_dict())
    card.eval().to(dev)
    images = torch.rand(2, 3, 256, 320, generator=torch.Generator().manual_seed(6))
    before = _counts()
    with torch.no_grad():
        got = card(images.to(dev))
        want = cpu(images)
    torch.cuda.synchronize()
    launched = [a - b for a, b in zip(_counts(), before)]
    assert all(launched[:3]), launched
    valid = want.valid
    assert int(valid.sum()) > 0
    _same_detections(got, want, 1e-4, 1e-2)
    if cls is MaskRCNN:  # the CPU model's masks at the card's own rows
        with torch.no_grad():
            masks = cpu.masks(cpu.backbone(images), got.boxes.cpu(),
                              got.labels.cpu(), (256, 320))
        torch.testing.assert_close(got.masks.cpu()[valid], masks[valid],
                                   rtol=0, atol=1e-4)

    boxes = torch.tensor([[[10, 12, 160, 170], [30, 40, 200, 220]],
                          [[50, 60, 300, 250], [0, 0, 0, 0]]], dtype=torch.float32)
    valid_gt = torch.tensor([[True, True], [True, False]])
    labels = torch.tensor([[1, 2], [3, 0]])
    extra = ({"gt_masks": ellipse_masks(boxes, valid_gt, (256, 320)).to(dev)}
             if cls is MaskRCNN else {})
    stats0 = _stats(card)
    card.train()
    before = _counts()
    losses = card.compute_loss(images.to(dev), boxes.to(dev), labels.to(dev),
                               valid_gt.to(dev), torch.Generator(device=dev).manual_seed(0),
                               **extra)
    sum(losses.values()).backward()
    torch.cuda.synchronize()
    launched = [a - b for a, b in zip(_counts(), before)]
    assert all(launched), launched
    assert all(torch.isfinite(v) for v in losses.values())
    for name, value in _stats(card).items():
        moved = not torch.equal(value, stats0[name])
        assert moved == name.startswith(("backbone.body.", "roi_heads.box_head.")), name
