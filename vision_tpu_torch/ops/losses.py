"""Detection losses (counterpart of ``vision_tpu/ops/losses.py``): the
sigmoid focal loss of RetinaNet and the GIoU, CIoU and DIoU losses over
paired boxes, each with the ``"none"``, ``"mean"`` or ``"sum"``
reduction."""

from __future__ import annotations

import torch

from vision_tpu_torch.ops.boxes import _upcast, complete_box_iou, distance_box_iou

__all__ = [
    "complete_box_iou_loss",
    "distance_box_iou_loss",
    "generalized_box_iou_loss",
    "sigmoid_focal_loss",
]


def _reduce(loss: torch.Tensor, reduction: str) -> torch.Tensor:
    if reduction == "none":
        return loss
    if reduction == "mean":
        return loss.mean()
    if reduction == "sum":
        return loss.sum()
    raise ValueError(f"invalid reduction {reduction!r}")


def sigmoid_focal_loss(
    inputs: torch.Tensor,
    targets: torch.Tensor,
    alpha: float = 0.25,
    gamma: float = 2.0,
    reduction: str = "none",
) -> torch.Tensor:
    """Focal loss of the logits ``inputs`` against the 0/1 ``targets``
    (same shape): the binary cross-entropy, in its stable form, weighted by
    ``(1 - p_t) ** gamma`` and, for ``alpha >= 0``, by ``alpha_t``. Types
    promote as in the JAX package: bf16 logits against f32 targets give an
    f32 loss."""
    p = torch.sigmoid(inputs)
    ce_loss = (inputs.clamp(min=0) - inputs * targets
               + torch.log1p(torch.exp(-inputs.abs())))
    p_t = p * targets + (1 - p) * (1 - targets)
    loss = ce_loss * (1 - p_t) ** gamma
    if alpha >= 0:
        alpha_t = alpha * targets + (1 - alpha) * (1 - targets)
        loss = alpha_t * loss
    return _reduce(loss, reduction)


def generalized_box_iou_loss(
    boxes1: torch.Tensor,
    boxes2: torch.Tensor,
    reduction: str = "none",
    eps: float = 1e-7,
) -> torch.Tensor:
    """``1 - GIoU`` of each pair of xyxy boxes ``[..., 4]``."""
    boxes1, boxes2 = _upcast(boxes1), _upcast(boxes2)
    x1, y1, x2, y2 = boxes1.unbind(-1)
    x1g, y1g, x2g, y2g = boxes2.unbind(-1)
    xkis1 = torch.maximum(x1, x1g)
    ykis1 = torch.maximum(y1, y1g)
    xkis2 = torch.minimum(x2, x2g)
    ykis2 = torch.minimum(y2, y2g)
    intsctk = (xkis2 - xkis1).clamp(min=0) * (ykis2 - ykis1).clamp(min=0)
    unionk = (x2 - x1) * (y2 - y1) + (x2g - x1g) * (y2g - y1g) - intsctk
    iouk = intsctk / (unionk + eps)
    area_c = ((torch.maximum(x2, x2g) - torch.minimum(x1, x1g))
              * (torch.maximum(y2, y2g) - torch.minimum(y1, y1g)))
    miouk = iouk - (area_c - unionk) / (area_c + eps)
    return _reduce(1 - miouk, reduction)


def _paired(fn, boxes1: torch.Tensor, boxes2: torch.Tensor, eps: float):
    """The pairwise ``fn`` on each pair of ``boxes1 [..., 4]`` and
    ``boxes2 [..., 4]``: the diagonal of the pair grid, as a batch of 1x1
    grids."""
    b1, b2 = _upcast(boxes1), _upcast(boxes2)
    out = fn(b1.reshape(-1, 1, 4), b2.reshape(-1, 1, 4), eps)
    return out.reshape(b1.shape[:-1])


def complete_box_iou_loss(
    boxes1: torch.Tensor,
    boxes2: torch.Tensor,
    reduction: str = "none",
    eps: float = 1e-7,
) -> torch.Tensor:
    """``1 - CIoU`` of each pair of xyxy boxes ``[..., 4]``."""
    return _reduce(1 - _paired(complete_box_iou, boxes1, boxes2, eps),
                   reduction)


def distance_box_iou_loss(
    boxes1: torch.Tensor,
    boxes2: torch.Tensor,
    reduction: str = "none",
    eps: float = 1e-7,
) -> torch.Tensor:
    """``1 - DIoU`` of each pair of xyxy boxes ``[..., 4]``."""
    return _reduce(1 - _paired(distance_box_iou, boxes1, boxes2, eps),
                   reduction)
