"""Box coding, matching and sampling (counterpart of
``vision_tpu/models/detection/_utils.py``): ``BoxCoder``, ``Matcher`` and
``BalancedPositiveNegativeSampler``, batched over images on fixed-size,
padded tensors with validity masks."""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch

__all__ = [
    "BELOW_LOW_THRESHOLD",
    "BETWEEN_THRESHOLDS",
    "BalancedPositiveNegativeSampler",
    "BoxCoder",
    "Matcher",
    "smooth_l1",
    "unit_box_where",
]

BELOW_LOW_THRESHOLD = -1
BETWEEN_THRESHOLDS = -2


def smooth_l1(diff: torch.Tensor, beta: float = 1.0 / 9.0) -> torch.Tensor:
    """Elementwise smooth-L1 of ``diff`` (Huber with threshold ``beta``)."""
    diff = diff.abs()
    return torch.where(diff < beta, 0.5 * diff ** 2 / beta, diff - 0.5 * beta)


def unit_box_where(keep: torch.Tensor, boxes: torch.Tensor) -> torch.Tensor:
    """``boxes [..., 4]`` where ``keep [...]``, else the box (0, 0, 1, 1):
    rows that a loss masks out go through ``BoxCoder.encode`` as finite
    deltas, where a degenerate box would give ``log(0)``, and ``inf * 0``
    is NaN in the loss and in its gradient."""
    unit = boxes.new_tensor([0.0, 0.0, 1.0, 1.0])
    return torch.where(keep[..., None], boxes, unit)


class BoxCoder:
    """Encodes and decodes ``(dx, dy, dw, dh)`` deltas with per-coordinate
    weights and the ``bbox_xform_clip`` clamp on ``dw``/``dh``, always in
    f32."""

    def __init__(
        self,
        weights: Tuple[float, float, float, float],
        bbox_xform_clip: float = math.log(1000.0 / 16),
    ):
        self.weights = weights
        self.bbox_xform_clip = bbox_xform_clip

    def encode(self, reference_boxes: torch.Tensor,
               proposals: torch.Tensor) -> torch.Tensor:
        """The deltas that take ``proposals [..., N, 4]`` to
        ``reference_boxes [..., N, 4]`` (xyxy) -> ``[..., N, 4]``."""
        wx, wy, ww, wh = self.weights
        ex_w = proposals[..., 2] - proposals[..., 0]
        ex_h = proposals[..., 3] - proposals[..., 1]
        ex_cx = proposals[..., 0] + 0.5 * ex_w
        ex_cy = proposals[..., 1] + 0.5 * ex_h

        gt_w = reference_boxes[..., 2] - reference_boxes[..., 0]
        gt_h = reference_boxes[..., 3] - reference_boxes[..., 1]
        gt_cx = reference_boxes[..., 0] + 0.5 * gt_w
        gt_cy = reference_boxes[..., 1] + 0.5 * gt_h

        dx = wx * (gt_cx - ex_cx) / ex_w
        dy = wy * (gt_cy - ex_cy) / ex_h
        dw = ww * torch.log(gt_w / ex_w)
        dh = wh * torch.log(gt_h / ex_h)
        return torch.stack([dx, dy, dw, dh], dim=-1)

    def decode(self, rel_codes: torch.Tensor, boxes: torch.Tensor) -> torch.Tensor:
        """``rel_codes [..., N, K*4]``, ``boxes [..., N, 4]`` ->
        ``[..., N, K, 4]`` xyxy."""
        rel_codes = rel_codes.float()
        boxes = boxes.float()
        widths = boxes[..., 2] - boxes[..., 0]
        heights = boxes[..., 3] - boxes[..., 1]
        ctr_x = boxes[..., 0] + 0.5 * widths
        ctr_y = boxes[..., 1] + 0.5 * heights

        wx, wy, ww, wh = self.weights
        codes = rel_codes.reshape(*rel_codes.shape[:-1], -1, 4)
        dx = codes[..., 0] / wx
        dy = codes[..., 1] / wy
        dw = (codes[..., 2] / ww).clamp(max=self.bbox_xform_clip)
        dh = (codes[..., 3] / wh).clamp(max=self.bbox_xform_clip)

        pred_cx = dx * widths[..., None] + ctr_x[..., None]
        pred_cy = dy * heights[..., None] + ctr_y[..., None]
        pred_w = torch.exp(dw) * widths[..., None]
        pred_h = torch.exp(dh) * heights[..., None]
        return torch.stack(
            [pred_cx - 0.5 * pred_w, pred_cy - 0.5 * pred_h,
             pred_cx + 0.5 * pred_w, pred_cy + 0.5 * pred_h],
            dim=-1,
        )


class Matcher:
    """``__call__(quality [..., M, N], valid_gt [..., M])`` -> int64
    matches ``[..., N]``: for each of N predictions the gt index of its
    best quality (the first on ties), or ``BELOW_LOW_THRESHOLD`` /
    ``BETWEEN_THRESHOLDS``. Padded gt rows (``valid_gt`` False) never
    match. With ``allow_low_quality_matches`` every prediction that ties a
    valid gt's best quality keeps its own best gt whatever its quality."""

    def __init__(
        self,
        high_threshold: float,
        low_threshold: float,
        allow_low_quality_matches: bool = False,
    ):
        if low_threshold > high_threshold:
            raise ValueError("low_threshold must be <= high_threshold")
        self.high_threshold = high_threshold
        self.low_threshold = low_threshold
        self.allow_low_quality_matches = allow_low_quality_matches

    def __call__(self, match_quality_matrix: torch.Tensor,
                 valid_gt: Optional[torch.Tensor] = None) -> torch.Tensor:
        m = match_quality_matrix
        if valid_gt is not None:
            m = torch.where(valid_gt[..., None], m, torch.full_like(m, -1.0))
        matched_vals = m.amax(dim=-2)
        all_matches = m.argmax(dim=-2)  # the first maximum, as jnp.argmax
        below = matched_vals < self.low_threshold
        between = ~below & (matched_vals < self.high_threshold)
        matches = torch.where(below, BELOW_LOW_THRESHOLD, all_matches)
        matches = torch.where(between, BETWEEN_THRESHOLDS, matches)
        if self.allow_low_quality_matches:
            is_best = m == m.amax(dim=-1, keepdim=True)  # [..., M, N]
            if valid_gt is not None:
                is_best &= valid_gt[..., None]
            matches = torch.where(is_best.any(dim=-2), all_matches, matches)
        return matches


class BalancedPositiveNegativeSampler:
    """Per image at most ``batch_size_per_image`` predictions: ``min(#pos,
    int(batch_size_per_image * positive_fraction))`` positives (matches
    >= 0), then ``min(#neg, batch_size_per_image - num_pos)`` negatives
    (matches == ``BELOW_LOW_THRESHOLD``), each set chosen by the rank of
    a uniform priority drawn from ``generator`` (positives' priorities
    first, then negatives', each ``[..., N]``, on the matches' device).
    Fixed-size masks, no host synchronisation."""

    def __init__(self, batch_size_per_image: int, positive_fraction: float):
        self.batch_size_per_image = batch_size_per_image
        self.positive_fraction = positive_fraction

    @staticmethod
    def _first(candidates: torch.Tensor, priority: torch.Tensor,
               num: torch.Tensor) -> torch.Tensor:
        """The ``num [..., 1]`` candidates of highest priority."""
        pri = torch.where(candidates, priority,
                          torch.full_like(priority, -math.inf))
        order = torch.sort(pri, dim=-1, descending=True, stable=True).indices
        rank = torch.empty_like(order)
        rank.scatter_(-1, order, torch.arange(
            order.shape[-1], device=order.device).expand_as(order))
        return candidates & (rank < num)

    def __call__(self, matched_idxs: torch.Tensor,
                 generator: torch.Generator) -> Tuple[torch.Tensor, torch.Tensor]:
        positive = matched_idxs >= 0
        negative = matched_idxs == BELOW_LOW_THRESHOLD
        shape, dev = matched_idxs.shape, matched_idxs.device
        pri_pos = torch.rand(shape, generator=generator, device=dev)
        pri_neg = torch.rand(shape, generator=generator, device=dev)
        budget = int(self.batch_size_per_image * self.positive_fraction)
        num_pos = positive.sum(-1, keepdim=True).clamp(max=budget)
        num_neg = negative.sum(-1, keepdim=True).clamp(
            max=self.batch_size_per_image - num_pos)
        return (self._first(positive, pri_pos, num_pos),
                self._first(negative, pri_neg, num_neg))
