"""Box coding (counterpart of ``vision_tpu/models/detection/_utils.py``,
BoxCoder only; the matcher and sampler wait for training)."""

from __future__ import annotations

import math
from typing import Tuple

import torch

__all__ = ["BoxCoder"]


class BoxCoder:
    """Decodes ``(dx, dy, dw, dh)`` deltas with per-coordinate weights and
    the ``bbox_xform_clip`` clamp on ``dw``/``dh``, always in f32."""

    def __init__(
        self,
        weights: Tuple[float, float, float, float],
        bbox_xform_clip: float = math.log(1000.0 / 16),
    ):
        self.weights = weights
        self.bbox_xform_clip = bbox_xform_clip

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
