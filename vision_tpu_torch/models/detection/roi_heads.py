"""RoI heads, box branch (counterpart of
``vision_tpu/models/detection/roi_heads.py``): ``TwoMLPHead``,
``FastRCNNPredictor``, ``postprocess_detections`` with fixed-size
results, and for training ``select_training_samples`` (a fixed budget of
sampled proposals an image) and ``fastrcnn_loss``. The mask and keypoint
branches wait."""

from __future__ import annotations

from typing import Dict, NamedTuple, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from vision_tpu_torch.models.detection._utils import (
    BELOW_LOW_THRESHOLD,
    BalancedPositiveNegativeSampler,
    BoxCoder,
    Matcher,
    smooth_l1,
    unit_box_where,
)
from vision_tpu_torch.ops._topk import top_k
from vision_tpu_torch.ops.boxes import box_iou
from vision_tpu_torch.ops.nms import batched_nms_mask
from vision_tpu_torch.ops.poolers import MultiScaleRoIAlign

__all__ = ["Detections", "FastRCNNPredictor", "RoIHeads", "SampledProposals",
           "TwoMLPHead"]

SAMPLES_PER_IMAGE = 512  # torchvision's box_batch_size_per_image


class Detections(NamedTuple):
    """Fixed-size detections: ``boxes [N, D, 4]``, ``scores``/``labels``/
    ``valid [N, D]``; rows with ``valid`` False are padding."""

    boxes: torch.Tensor
    scores: torch.Tensor
    labels: torch.Tensor
    valid: torch.Tensor


class SampledProposals(NamedTuple):
    """The proposals an image trains on, ``[N, S]`` rows: ``boxes [N, S,
    4]``, ``labels`` (0 = background), ``reg_targets [N, S, 4]``,
    ``pos_mask``, ``valid`` (sampled; the rest is padding) and
    ``matched_gt`` (the gt row of each, 0 where none)."""

    boxes: torch.Tensor
    labels: torch.Tensor
    reg_targets: torch.Tensor
    pos_mask: torch.Tensor
    valid: torch.Tensor
    matched_gt: torch.Tensor


class TwoMLPHead(nn.Module):
    """Flatten the pooled ``[K, C, 7, 7]`` in CHW order, then fc6, fc7."""

    def __init__(self, in_channels: int, representation_size: int = 1024):
        super().__init__()
        self.fc6 = nn.Linear(in_channels, representation_size)
        self.fc7 = nn.Linear(representation_size, representation_size)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.flatten(1)
        return F.relu(self.fc7(F.relu(self.fc6(x))))


class FastRCNNPredictor(nn.Module):
    def __init__(self, in_channels: int, num_classes: int):
        super().__init__()
        self.cls_score = nn.Linear(in_channels, num_classes)
        self.bbox_pred = nn.Linear(in_channels, num_classes * 4)

    def forward(self, x: torch.Tensor):
        return self.cls_score(x), self.bbox_pred(x)


class RoIHeads(nn.Module):
    """``box_roi_pool`` -> ``box_head`` -> ``box_predictor``, the
    fixed-size postprocess, and the training samples and loss."""

    def __init__(
        self,
        box_roi_pool: MultiScaleRoIAlign,
        box_head: nn.Module,
        box_predictor: nn.Module,
        bbox_reg_weights: Tuple[float, ...] = (10.0, 10.0, 5.0, 5.0),
        score_thresh: float = 0.05,
        nms_thresh: float = 0.5,
        detections_per_img: int = 100,
        topk_candidates: int = 1000,
    ):
        super().__init__()
        self.box_roi_pool = box_roi_pool
        self.box_head = box_head
        self.box_predictor = box_predictor
        self.box_coder = BoxCoder(weights=bbox_reg_weights)
        # torchvision's training defaults: IoU >= 0.5 positive, below
        # negative; a quarter of the samples positive at most
        self.proposal_matcher = Matcher(0.5, 0.5)
        self.sampler = BalancedPositiveNegativeSampler(SAMPLES_PER_IMAGE, 0.25)
        self.score_thresh = score_thresh
        self.nms_thresh = nms_thresh
        self.detections_per_img = detections_per_img
        self.topk_candidates = topk_candidates

    def select_training_samples(
        self,
        proposals: torch.Tensor,  # [N, P, 4]
        proposals_valid: torch.Tensor,  # [N, P]
        gt_boxes: torch.Tensor,  # [N, G, 4]
        gt_labels: torch.Tensor,  # [N, G]
        gt_valid: torch.Tensor,  # [N, G]
        generator: torch.Generator,
    ) -> SampledProposals:
        """Append the gt boxes to the proposals, match them to the gt
        (IoU >= 0.5 positive, below negative; invalid rows negative and
        never matched), sample (the sampler draws from ``generator``), and
        keep ``S = min(SAMPLES_PER_IMAGE, P + G)`` rows an image: the
        sampled positives first, then the sampled negatives, each in index
        order, then padding. Regression targets of rows that are not
        positive are those of a unit box."""
        proposals = proposals.detach()
        props = torch.cat([proposals, gt_boxes.to(proposals.dtype)], 1)
        pvalid = torch.cat([proposals_valid, gt_valid], 1)
        iou = box_iou(gt_boxes, props)  # [N, G, P + G]
        iou = torch.where(pvalid[:, None, :], iou, torch.full_like(iou, -1.0))
        matched = self.proposal_matcher(iou, valid_gt=gt_valid)
        matched = torch.where(pvalid, matched, BELOW_LOW_THRESHOLD)
        pos, neg = self.sampler(matched, generator)
        sampled = pos | neg

        s = min(SAMPLES_PER_IMAGE, props.shape[1])
        _, idx = top_k(sampled.float() + 0.5 * pos.float(), s)
        sel_boxes = torch.gather(props, 1, idx[..., None].expand(-1, -1, 4))
        sel_pos = torch.gather(pos, 1, idx)
        clamped = torch.gather(matched, 1, idx).clamp(min=0)
        sel_labels = torch.where(sel_pos, torch.gather(gt_labels.long(), 1,
                                                       clamped), 0)
        matched_boxes = torch.gather(gt_boxes.to(props.dtype), 1,
                                     clamped[..., None].expand(-1, -1, 4))
        reg_targets = self.box_coder.encode(unit_box_where(sel_pos, matched_boxes),
                                            unit_box_where(sel_pos, sel_boxes))
        return SampledProposals(sel_boxes, sel_labels, reg_targets, sel_pos,
                                torch.gather(sampled, 1, idx), clamped)

    def fastrcnn_loss(
        self,
        class_logits: torch.Tensor,  # [N, S, C]
        box_regression: torch.Tensor,  # [N, S, C*4]
        sampled: SampledProposals,
    ) -> Dict[str, torch.Tensor]:
        """Cross-entropy over the sampled rows, and smooth-L1 (beta 1/9)
        of the positives' deltas of their own class, each summed over the
        batch over its number of sampled rows."""
        n, s, c = class_logits.shape
        valid = sampled.valid
        num_valid = valid.sum().clamp(min=1)
        logp = F.log_softmax(class_logits.float(), dim=-1)
        ce = -torch.gather(logp, 2, sampled.labels[..., None])[..., 0]
        cls_loss = (ce * valid).sum() / num_valid
        reg = box_regression.float().reshape(n, s, c, 4)
        reg_sel = torch.gather(
            reg, 2, sampled.labels[..., None, None].expand(n, s, 1, 4))[:, :, 0]
        sl1 = smooth_l1(reg_sel - sampled.reg_targets).sum(-1)
        box_loss = (sl1 * sampled.pos_mask).sum() / num_valid
        return {"loss_classifier": cls_loss, "loss_box_reg": box_loss}

    def postprocess_detections(
        self,
        class_logits: torch.Tensor,  # [N, P, C]
        box_regression: torch.Tensor,  # [N, P, C*4]
        proposals: torch.Tensor,  # [N, P, 4]
        proposals_valid: torch.Tensor,  # [N, P]
        image_size: Tuple[int, int],
    ) -> Detections:
        """Softmax, decode and clip per class; drop the background class;
        mask low scores, invalid proposals and tiny boxes; keep the top
        ``topk_candidates`` (RoI, class) pairs; one class-aware NMS per
        image; the top ``detections_per_img`` kept."""
        h, w = image_size
        n, p, c = class_logits.shape
        scores = F.softmax(class_logits.float(), dim=-1)
        boxes = self.box_coder.decode(box_regression, proposals)  # [N,P,C,4]
        x = boxes[..., 0::2].clamp(0, w)
        y = boxes[..., 1::2].clamp(0, h)
        boxes = torch.stack([x[..., 0], y[..., 0], x[..., 1], y[..., 1]], -1)

        fg_scores = scores[:, :, 1:].reshape(n, -1)
        fg_boxes = boxes[:, :, 1:].reshape(n, -1, 4)
        fg_labels = torch.arange(1, c, device=scores.device).repeat(p)
        valid = fg_scores > self.score_thresh
        valid &= proposals_valid.repeat_interleave(c - 1, dim=1)
        ws = fg_boxes[..., 2] - fg_boxes[..., 0]
        hs = fg_boxes[..., 3] - fg_boxes[..., 1]
        valid &= (ws >= 1e-2) & (hs >= 1e-2)

        kcap = min(self.topk_candidates, fg_scores.shape[1])
        cand_scores, cand_idx = top_k(
            torch.where(valid, fg_scores, torch.full_like(fg_scores, -1.0)),
            kcap,
        )
        fg_boxes = torch.gather(fg_boxes, 1, cand_idx[..., None].expand(-1, -1, 4))
        fg_scores = torch.gather(fg_scores, 1, cand_idx)
        fg_labels = fg_labels[cand_idx]
        valid = cand_scores > 0

        keep = batched_nms_mask(fg_boxes, fg_scores, fg_labels,
                                self.nms_thresh, valid=valid)
        kept = torch.where(keep, fg_scores, torch.full_like(fg_scores, -1.0))
        top_scores, top_idx = top_k(kept, self.detections_per_img)
        return Detections(
            torch.gather(fg_boxes, 1, top_idx[..., None].expand(-1, -1, 4)),
            torch.where(top_scores > 0, top_scores, torch.zeros_like(top_scores)),
            torch.gather(fg_labels, 1, top_idx),
            top_scores > 0,
        )
