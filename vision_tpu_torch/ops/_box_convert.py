"""Box format conversion math (counterpart of
``vision_tpu/ops/_box_convert.py``): the same expressions, in the same
order, on ``(..., K)`` tensors. Rotated formats use degrees,
counter-clockwise-positive angle."""

from __future__ import annotations

import torch


def _box_xywh_to_xyxy(boxes: torch.Tensor) -> torch.Tensor:
    x, y, w, h = boxes.split(1, dim=-1)
    return torch.cat([x, y, x + w, y + h], dim=-1)


def _box_xyxy_to_xywh(boxes: torch.Tensor) -> torch.Tensor:
    x1, y1, x2, y2 = boxes.split(1, dim=-1)
    return torch.cat([x1, y1, x2 - x1, y2 - y1], dim=-1)


def _box_cxcywh_to_xyxy(boxes: torch.Tensor) -> torch.Tensor:
    cx, cy, w, h = boxes.split(1, dim=-1)
    return torch.cat(
        [cx - 0.5 * w, cy - 0.5 * h, cx + 0.5 * w, cy + 0.5 * h], dim=-1
    )


def _box_xyxy_to_cxcywh(boxes: torch.Tensor) -> torch.Tensor:
    x1, y1, x2, y2 = boxes.split(1, dim=-1)
    return torch.cat([(x1 + x2) / 2, (y1 + y2) / 2, x2 - x1, y2 - y1], dim=-1)


def _box_xywhr_to_cxcywhr(boxes: torch.Tensor) -> torch.Tensor:
    x, y, w, h, r = boxes.split(1, dim=-1)
    r_rad = torch.deg2rad(r)
    cos, sin = torch.cos(r_rad), torch.sin(r_rad)
    cx = x + w / 2 * cos + h / 2 * sin
    cy = y - w / 2 * sin + h / 2 * cos
    return torch.cat([cx, cy, w, h, r], dim=-1)


def _box_cxcywhr_to_xywhr(boxes: torch.Tensor) -> torch.Tensor:
    cx, cy, w, h, r = boxes.split(1, dim=-1)
    r_rad = torch.deg2rad(r)
    cos, sin = torch.cos(r_rad), torch.sin(r_rad)
    x = cx - w / 2 * cos - h / 2 * sin
    y = cy + w / 2 * sin - h / 2 * cos
    return torch.cat([x, y, w, h, r], dim=-1)


def _box_xywhr_to_xyxyxyxy(boxes: torch.Tensor) -> torch.Tensor:
    x1, y1, w, h, r = boxes.split(1, dim=-1)
    r_rad = torch.deg2rad(r)
    cos, sin = torch.cos(r_rad), torch.sin(r_rad)
    x2 = x1 + w * cos
    y2 = y1 - w * sin
    x3 = x2 + h * sin
    y3 = y2 + h * cos
    x4 = x1 + h * sin
    y4 = y1 + h * cos
    return torch.cat([x1, y1, x2, y2, x3, y3, x4, y4], dim=-1)


def _box_xyxyxyxy_to_xywhr(boxes: torch.Tensor) -> torch.Tensor:
    x1, y1, x2, y2, x3, y3, x4, y4 = boxes.split(1, dim=-1)
    r = torch.rad2deg(torch.atan2(y1 - y2, x2 - x1))
    w = torch.sqrt((y2 - y1) ** 2 + (x2 - x1) ** 2)
    h = torch.sqrt((y3 - y2) ** 2 + (x3 - x2) ** 2)
    return torch.cat([x1, y1, w, h, r], dim=-1)
