"""Region Proposal Network (counterpart of
``vision_tpu/models/detection/rpn.py``): the head; ``filter_proposals`` as
fixed-size per-level top-k, decode, clip and per-level NMS, emitting
``post_nms_top_n`` proposals with a validity mask; and the training loss,
``compute_loss``."""

from __future__ import annotations

from typing import Dict, List, NamedTuple, Tuple

import torch
from torch import nn

from vision_tpu_torch.models.detection._utils import (
    BalancedPositiveNegativeSampler,
    BoxCoder,
    Matcher,
    smooth_l1,
    unit_box_where,
)
from vision_tpu_torch.models.detection.anchor_utils import AnchorGenerator
from vision_tpu_torch.ops._topk import top_k
from vision_tpu_torch.ops.boxes import box_iou
from vision_tpu_torch.ops.misc import Conv2dNormActivation
from vision_tpu_torch.ops.nms import nms_mask

__all__ = ["Proposals", "RPNHead", "RegionProposalNetwork"]


class Proposals(NamedTuple):
    boxes: torch.Tensor  # [N, P, 4]
    scores: torch.Tensor  # [N, P]
    valid: torch.Tensor  # [N, P] bool


class RPNHead(nn.Module):
    """``conv_depth`` shared 3x3 conv + ReLU layers (one in v1, two in the
    v2 detectors), then 1x1 objectness and box-delta convs. Names as
    torchvision's (``conv.{i}.0``, ``cls_logits``, ``bbox_pred``).

    Returns per level ``objectness [N, H*W*A]`` and ``deltas
    [N, H*W*A, 4]`` flattened in ``(h, w, a)`` order, the order of the
    anchors."""

    def __init__(self, in_channels: int, num_anchors: int,
                 conv_depth: int = 1):
        super().__init__()
        self.conv = nn.Sequential(*(
            Conv2dNormActivation(in_channels, in_channels, 3, norm_layer=None)
            for _ in range(conv_depth)))
        self.cls_logits = nn.Conv2d(in_channels, num_anchors, 1)
        self.bbox_pred = nn.Conv2d(in_channels, num_anchors * 4, 1)
        self.num_anchors = num_anchors

    def forward(self, features: List[torch.Tensor]):
        objectness, deltas = [], []
        a = self.num_anchors
        for f in features:
            t = self.conv(f)
            o = self.cls_logits(t)  # [N, A, H, W]
            d = self.bbox_pred(t)  # [N, A*4, H, W]
            n, _, h, w = o.shape
            objectness.append(o.permute(0, 2, 3, 1).reshape(n, h * w * a))
            deltas.append(
                d.view(n, a, 4, h, w).permute(0, 3, 4, 1, 2).reshape(n, -1, 4)
            )
        return objectness, deltas


class RegionProposalNetwork(nn.Module):
    """Holds the head and the anchor generator (``rpn.head`` in the state
    dict), the proposal filter's hyperparameters and the loss's matcher
    and sampler."""

    def __init__(
        self,
        anchor_generator: AnchorGenerator,
        head: RPNHead,
        pre_nms_top_n: int = 1000,
        post_nms_top_n: int = 1000,
        nms_thresh: float = 0.7,
        score_thresh: float = 0.0,
        min_size: float = 1e-3,
    ):
        super().__init__()
        self.anchor_generator = anchor_generator
        self.head = head
        self.box_coder = BoxCoder(weights=(1.0, 1.0, 1.0, 1.0))
        # torchvision's training defaults: IoU >= 0.7 positive, < 0.3
        # negative; 256 anchors an image, half of them positive at most
        self.proposal_matcher = Matcher(0.7, 0.3, allow_low_quality_matches=True)
        self.sampler = BalancedPositiveNegativeSampler(256, 0.5)
        self.pre_nms_top_n = pre_nms_top_n
        self.post_nms_top_n = post_nms_top_n
        self.nms_thresh = nms_thresh
        self.score_thresh = score_thresh
        self.min_size = min_size

    def filter_proposals(
        self,
        objectness: List[torch.Tensor],
        deltas: List[torch.Tensor],
        anchors: List[torch.Tensor],
        image_size: Tuple[int, int],
    ) -> Proposals:
        """Per level: top ``pre_nms_top_n`` objectness -> decode -> clip ->
        small-box / low-score mask, padded to one row length; then NMS per
        (image, level) in one batched call — levels never suppress each
        other — and the top ``post_nms_top_n`` over all levels."""
        h, w = image_size
        n = objectness[0].shape[0]
        boxes_l, scores_l, valid_l = [], [], []
        kmax = max(min(self.pre_nms_top_n, o.shape[1]) for o in objectness)
        for obj, dl, anch in zip(objectness, deltas, anchors):
            obj = obj.detach()
            k = min(self.pre_nms_top_n, obj.shape[1])
            top_scores, top_idx = top_k(obj, k)  # [N, k]
            sel_dl = torch.gather(dl.detach(), 1,
                                  top_idx[..., None].expand(-1, -1, 4))
            dec = self.box_coder.decode(sel_dl, anch[top_idx])[:, :, 0]
            x = dec[..., 0::2].clamp(0, w)
            y = dec[..., 1::2].clamp(0, h)
            dec = torch.stack([x[..., 0], y[..., 0], x[..., 1], y[..., 1]], -1)
            ws = dec[..., 2] - dec[..., 0]
            hs = dec[..., 3] - dec[..., 1]
            valid = (ws >= self.min_size) & (hs >= self.min_size)
            valid &= torch.sigmoid(top_scores) > self.score_thresh
            if k < kmax:  # small levels pad to one row length
                pad = kmax - k
                dec = torch.cat([dec, dec.new_zeros(n, pad, 4)], 1)
                top_scores = torch.cat(
                    [top_scores, top_scores.new_full((n, pad), -torch.inf)], 1)
                valid = torch.cat([valid, valid.new_zeros(n, pad)], 1)
            boxes_l.append(dec)
            scores_l.append(top_scores)
            valid_l.append(valid)

        num_levels = len(boxes_l)
        boxes = torch.stack(boxes_l, 1)  # [N, L, kmax, 4]
        scores = torch.stack(scores_l, 1)  # [N, L, kmax]
        valid = torch.stack(valid_l, 1)
        # rows come straight out of top_k: descending, ties in index order
        keep = nms_mask(
            boxes.reshape(n * num_levels, kmax, 4),
            scores.reshape(n * num_levels, kmax),
            self.nms_thresh,
            valid=valid.reshape(n * num_levels, kmax),
            presorted=True,
        ).reshape(n, num_levels * kmax)
        kept_scores = torch.where(
            keep, scores.reshape(n, -1), torch.full_like(keep, -torch.inf,
                                                         dtype=scores.dtype))
        boxes = boxes.reshape(n, -1, 4)
        p = min(self.post_nms_top_n, boxes.shape[1])
        top_scores, top_idx = top_k(kept_scores, p)
        top_boxes = torch.gather(boxes, 1, top_idx[..., None].expand(-1, -1, 4))
        return Proposals(top_boxes, top_scores, top_scores > -torch.inf)

    def compute_loss(
        self,
        objectness: List[torch.Tensor],
        deltas: List[torch.Tensor],
        anchors: List[torch.Tensor],
        gt_boxes: torch.Tensor,
        gt_valid: torch.Tensor,
        generator: torch.Generator,
    ) -> Dict[str, torch.Tensor]:
        """Binary cross-entropy of the objectness on the sampled anchors,
        and smooth-L1 (beta 1/9) of the deltas on the sampled positives,
        each summed over an image over its number of sampled anchors, then
        averaged over the images. ``gt_boxes [N, G, 4]`` with ``gt_valid
        [N, G]``; the sampler draws from ``generator``.

        Unlike the JAX package (``rpn.py:196-200``), anchors that are not
        positive are encoded against a unit box: there their matched gt
        can be a padding row of zeros, whose ``log(0)`` target made the
        masked loss's gradient NaN."""
        obj = torch.cat(objectness, 1).float()  # [N, R]
        dl = torch.cat(deltas, 1).float()  # [N, R, 4]
        all_anchors = torch.cat(anchors, 0)  # [R, 4]
        matched = self.proposal_matcher(box_iou(gt_boxes, all_anchors),
                                        valid_gt=gt_valid)  # [N, R]
        pos, neg = self.sampler(matched, generator)
        sampled = pos | neg
        num_sampled = sampled.sum(1).clamp(min=1)

        labels = (matched >= 0).to(obj.dtype)
        bce = obj.clamp(min=0) - obj * labels + torch.log1p(torch.exp(-obj.abs()))
        obj_loss = (bce * sampled).sum(1) / num_sampled

        idx = matched.clamp(min=0)[..., None].expand(-1, -1, 4)
        matched_boxes = torch.gather(gt_boxes.float(), 1, idx)  # [N, R, 4]
        target = self.box_coder.encode(
            unit_box_where(pos, matched_boxes),
            unit_box_where(pos, all_anchors.expand_as(matched_boxes)))
        box_loss = (smooth_l1(dl - target).sum(-1) * pos).sum(1) / num_sampled
        return {"loss_objectness": obj_loss.mean(),
                "loss_rpn_box_reg": box_loss.mean()}
