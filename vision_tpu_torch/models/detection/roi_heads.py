"""RoI heads, box branch, inference path (counterpart of
``vision_tpu/models/detection/roi_heads.py``): ``TwoMLPHead``,
``FastRCNNPredictor`` and ``postprocess_detections`` with fixed-size
results. The mask and keypoint branches wait."""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from vision_tpu_torch.models.detection._utils import BoxCoder
from vision_tpu_torch.ops._topk import top_k
from vision_tpu_torch.ops.nms import batched_nms_mask
from vision_tpu_torch.ops.poolers import MultiScaleRoIAlign

__all__ = ["Detections", "FastRCNNPredictor", "RoIHeads", "TwoMLPHead"]


class Detections(NamedTuple):
    """Fixed-size detections: ``boxes [N, D, 4]``, ``scores``/``labels``/
    ``valid [N, D]``; rows with ``valid`` False are padding."""

    boxes: torch.Tensor
    scores: torch.Tensor
    labels: torch.Tensor
    valid: torch.Tensor


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
    """``box_roi_pool`` -> ``box_head`` -> ``box_predictor``, and the
    fixed-size postprocess."""

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
        self.score_thresh = score_thresh
        self.nms_thresh = nms_thresh
        self.detections_per_img = detections_per_img
        self.topk_candidates = topk_candidates

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
