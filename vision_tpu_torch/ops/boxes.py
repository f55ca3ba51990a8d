"""Box operations (counterpart of ``vision_tpu/ops/boxes.py``).

The same expressions as the JAX package, on tensors of any device. Where
the reference returns a dynamically sized index list,
``remove_small_boxes`` returns a boolean mask, as the JAX package does.
"""

from __future__ import annotations

import math
from typing import Tuple

import torch

from vision_tpu_torch.ops import _box_convert as _bc
from vision_tpu_torch.ops._box_iou_rotated import box_iou_rotated
from vision_tpu_torch.ops.nms import batched_nms, nms

__all__ = [
    "batched_nms",
    "box_area",
    "box_convert",
    "box_iou",
    "box_iou_rotated",
    "clip_boxes_to_image",
    "complete_box_iou",
    "distance_box_iou",
    "generalized_box_iou",
    "masks_to_boxes",
    "nms",
    "remove_small_boxes",
]

_FORMATS = ("xyxy", "xywh", "cxcywh", "xywhr", "cxcywhr", "xyxyxyxy")
_ROTATED = ("xywhr", "cxcywhr", "xyxyxyxy")


def _upcast(t: torch.Tensor) -> torch.Tensor:
    """Protect against overflow in products: floats below 32 bits to f32,
    8- and 16-bit integers to int32."""
    if t.is_floating_point():
        return t if t.dtype in (torch.float32, torch.float64) else t.float()
    return t.int() if t.dtype in (torch.int8, torch.int16) else t


def box_convert(boxes: torch.Tensor, in_fmt: str, out_fmt: str) -> torch.Tensor:
    """Convert boxes between xyxy, xywh and cxcywh, or between the rotated
    xywhr, cxcywhr and xyxyxyxy."""
    in_fmt, out_fmt = in_fmt.lower(), out_fmt.lower()
    if in_fmt not in _FORMATS or out_fmt not in _FORMATS:
        raise ValueError(f"unsupported format pair {in_fmt}->{out_fmt}")
    if in_fmt == out_fmt:
        return boxes
    if (in_fmt in _ROTATED) != (out_fmt in _ROTATED):
        raise ValueError(f"cannot convert between {in_fmt} and {out_fmt}")

    if in_fmt in _ROTATED:
        if in_fmt != "xywhr":
            boxes = {
                "cxcywhr": _bc._box_cxcywhr_to_xywhr,
                "xyxyxyxy": _bc._box_xyxyxyxy_to_xywhr,
            }[in_fmt](boxes)
        if out_fmt == "xywhr":
            return boxes
        return {
            "cxcywhr": _bc._box_xywhr_to_cxcywhr,
            "xyxyxyxy": _bc._box_xywhr_to_xyxyxyxy,
        }[out_fmt](boxes)

    if in_fmt != "xyxy":
        boxes = {
            "xywh": _bc._box_xywh_to_xyxy,
            "cxcywh": _bc._box_cxcywh_to_xyxy,
        }[in_fmt](boxes)
    if out_fmt == "xyxy":
        return boxes
    return {
        "xywh": _bc._box_xyxy_to_xywh,
        "cxcywh": _bc._box_xyxy_to_cxcywh,
    }[out_fmt](boxes)


def box_area(boxes: torch.Tensor, fmt: str = "xyxy") -> torch.Tensor:
    boxes = _upcast(boxes)
    if fmt in ("xywhr", "cxcywhr"):
        return boxes[..., 2] * boxes[..., 3]
    if fmt == "xyxyxyxy":
        b = box_convert(boxes, "xyxyxyxy", "xywhr")
        return b[..., 2] * b[..., 3]
    return (boxes[..., 2] - boxes[..., 0]) * (boxes[..., 3] - boxes[..., 1])


def _box_inter_union(boxes1, boxes2) -> Tuple[torch.Tensor, torch.Tensor]:
    area1 = box_area(boxes1)
    area2 = box_area(boxes2)
    lt = torch.maximum(boxes1[..., :, None, :2], boxes2[..., None, :, :2])
    rb = torch.minimum(boxes1[..., :, None, 2:], boxes2[..., None, :, 2:])
    wh = (rb - lt).clamp(min=0)
    inter = wh[..., 0] * wh[..., 1]
    union = area1[..., :, None] + area2[..., None, :] - inter
    return inter, union


def box_iou(boxes1: torch.Tensor, boxes2: torch.Tensor,
            fmt: str = "xyxy") -> torch.Tensor:
    """Pairwise IoU ``[N, M]``; rotated formats go through
    ``box_iou_rotated`` in cxcywhr."""
    if fmt in _ROTATED:
        b1 = box_convert(_upcast(boxes1), fmt, "cxcywhr")
        b2 = box_convert(_upcast(boxes2), fmt, "cxcywhr")
        return box_iou_rotated(b1, b2)
    boxes1, boxes2 = _upcast(boxes1), _upcast(boxes2)
    inter, union = _box_inter_union(boxes1, boxes2)
    return inter / union


def generalized_box_iou(boxes1: torch.Tensor,
                        boxes2: torch.Tensor) -> torch.Tensor:
    boxes1, boxes2 = _upcast(boxes1), _upcast(boxes2)
    inter, union = _box_inter_union(boxes1, boxes2)
    iou = inter / union
    lt = torch.minimum(boxes1[..., :, None, :2], boxes2[..., None, :, :2])
    rb = torch.maximum(boxes1[..., :, None, 2:], boxes2[..., None, :, 2:])
    wh = (rb - lt).clamp(min=0)
    area = wh[..., 0] * wh[..., 1]
    return iou - (area - union) / area


def _box_diou_iou(boxes1, boxes2, eps):
    inter, union = _box_inter_union(boxes1, boxes2)
    iou = inter / union
    lti = torch.minimum(boxes1[..., :, None, :2], boxes2[..., None, :, :2])
    rbi = torch.maximum(boxes1[..., :, None, 2:], boxes2[..., None, :, 2:])
    whi = (rbi - lti).clamp(min=0)
    diagonal = whi[..., 0] ** 2 + whi[..., 1] ** 2 + eps
    cx1 = (boxes1[..., :, None, 0] + boxes1[..., :, None, 2]) / 2
    cy1 = (boxes1[..., :, None, 1] + boxes1[..., :, None, 3]) / 2
    cx2 = (boxes2[..., None, :, 0] + boxes2[..., None, :, 2]) / 2
    cy2 = (boxes2[..., None, :, 1] + boxes2[..., None, :, 3]) / 2
    centers = (cx1 - cx2) ** 2 + (cy1 - cy2) ** 2
    return iou - centers / diagonal, iou


def complete_box_iou(boxes1: torch.Tensor, boxes2: torch.Tensor,
                     eps: float = 1e-7) -> torch.Tensor:
    boxes1, boxes2 = _upcast(boxes1), _upcast(boxes2)
    diou, iou = _box_diou_iou(boxes1, boxes2, eps)
    w_pred = boxes1[..., :, None, 2] - boxes1[..., :, None, 0]
    h_pred = boxes1[..., :, None, 3] - boxes1[..., :, None, 1]
    w_gt = boxes2[..., None, :, 2] - boxes2[..., None, :, 0]
    h_gt = boxes2[..., None, :, 3] - boxes2[..., None, :, 1]
    v = (4 / (math.pi ** 2)) * (
        torch.atan(w_gt / h_gt) - torch.atan(w_pred / h_pred)
    ) ** 2
    alpha = (v / (1 - iou + v + eps)).detach()
    return diou - alpha * v


def distance_box_iou(boxes1: torch.Tensor, boxes2: torch.Tensor,
                     eps: float = 1e-7) -> torch.Tensor:
    boxes1, boxes2 = _upcast(boxes1), _upcast(boxes2)
    diou, _ = _box_diou_iou(boxes1, boxes2, eps)
    return diou


def clip_boxes_to_image(boxes: torch.Tensor,
                        size: Tuple[int, int]) -> torch.Tensor:
    """Clamp xyxy boxes to ``[0, W] x [0, H]``; ``size`` is (H, W)."""
    h, w = size
    x = boxes[..., 0::2].clamp(0, w)
    y = boxes[..., 1::2].clamp(0, h)
    return torch.stack([x[..., 0], y[..., 0], x[..., 1], y[..., 1]],
                       dim=-1).to(boxes.dtype)


def remove_small_boxes(boxes: torch.Tensor, min_size: float) -> torch.Tensor:
    """Boolean mask of the xyxy boxes whose sides are both >= min_size."""
    ws = boxes[..., 2] - boxes[..., 0]
    hs = boxes[..., 3] - boxes[..., 1]
    return (ws >= min_size) & (hs >= min_size)


def masks_to_boxes(masks: torch.Tensor) -> torch.Tensor:
    """``[N, H, W]`` masks -> ``[N, 4]`` f32 xyxy boxes around their
    non-zero pixels; an empty mask gives zeros."""
    _, h, w = masks.shape
    dev = masks.device
    ys = torch.arange(h, dtype=torch.float32, device=dev)[None, :, None]
    xs = torch.arange(w, dtype=torch.float32, device=dev)[None, None, :]
    m = masks != 0
    big = torch.tensor(1e9, dtype=torch.float32, device=dev)
    x1 = torch.where(m, xs, big).amin(dim=(1, 2))
    y1 = torch.where(m, ys, big).amin(dim=(1, 2))
    x2 = torch.where(m, xs, -big).amax(dim=(1, 2))
    y2 = torch.where(m, ys, -big).amax(dim=(1, 2))
    boxes = torch.stack([x1, y1, x2, y2], dim=-1)
    return torch.where(m.any(dim=(1, 2))[:, None], boxes,
                       torch.zeros_like(boxes))
