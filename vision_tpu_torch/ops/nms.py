"""Non-maximum suppression with fixed-size results (counterpart of
``vision_tpu/ops/nms.py``).

* :func:`nms_mask` — boolean keep mask over the input order, with the
  ``valid`` and ``presorted`` contract of the JAX package. It takes one
  ``[N]`` problem or a batch ``[B, N]`` of independent ones (the RPN's
  per-level NMS, which the JAX package vmaps).
* :func:`batched_nms_mask` — category-aware NMS by the coordinate-offset
  trick, offsets taken from the valid boxes only.
* :func:`nms` / :func:`batched_nms` — ``-1``-padded kept indices in
  descending score order.

The greedy pass over sorted boxes is :func:`nms_keep_sorted`: for tensors on
the card the bitmask kernel ``csrc/nms.cu``, or the row-serial kernel
``csrc/nms_rowscan.cu`` when the environment says
``VISION_TPU_NMS_KERNEL=rowscan`` (read at every call); for tensors on the
CPU the plain PyTorch version :func:`nms_keep_sorted_plain`. All three give
the same mask bit for bit.
"""

from __future__ import annotations

import os
from typing import Optional

import torch

from vision_tpu_torch import _kernels

__all__ = [
    "batched_nms",
    "batched_nms_mask",
    "nms",
    "nms_keep_sorted",
    "nms_keep_sorted_cuda",
    "nms_keep_sorted_plain",
    "nms_keep_sorted_rowscan_cuda",
    "nms_mask",
]


def _iou_matrix(boxes: torch.Tensor) -> torch.Tensor:
    """[..., N, 4] -> [..., N, N] IoU, 0 where the union is not positive."""
    area = (boxes[..., 2] - boxes[..., 0]) * (boxes[..., 3] - boxes[..., 1])
    lt = torch.maximum(boxes[..., :, None, :2], boxes[..., None, :, :2])
    rb = torch.minimum(boxes[..., :, None, 2:], boxes[..., None, :, 2:])
    wh = (rb - lt).clamp(min=0)
    inter = wh[..., 0] * wh[..., 1]
    union = area[..., :, None] + area[..., None, :] - inter
    return torch.where(union > 0, inter / union, torch.zeros_like(inter))


def nms_keep_sorted_plain(
    boxes: torch.Tensor, valid: torch.Tensor, iou_threshold: float
) -> torch.Tensor:
    """Plain PyTorch greedy NMS: ``boxes [B, N, 4]`` f32 in descending
    score order per row, ``valid [B, N]`` bool -> keep ``[B, N]`` bool.
    Row ``i`` suppresses a later row when their IoU is strictly above the
    threshold; invalid rows are never kept and never suppress."""
    n = boxes.shape[1]
    later = torch.ones(n, n, dtype=torch.bool, device=boxes.device).triu(1)
    sup = (_iou_matrix(boxes) > iou_threshold) & later  # [B, N, N]
    removed = ~valid
    for i in range(n):
        kept_i = ~removed[:, i]
        removed = removed | (sup[:, i, :] & kept_i[:, None])
    return ~removed


def _sorted_args(boxes: torch.Tensor, valid: torch.Tensor, who: str):
    """Check the kernels' shared contract; contiguous ``(boxes, valid)``."""
    if boxes.device.type != "cuda" or valid.device != boxes.device:
        raise ValueError(f"{who} takes CUDA tensors")
    if boxes.dtype != torch.float32 or boxes.dim() != 3 or boxes.shape[2] != 4:
        raise ValueError(f"boxes must be f32 [B, N, 4], got {boxes.dtype} "
                         f"{tuple(boxes.shape)}")
    if valid.dtype != torch.bool or valid.shape != boxes.shape[:2]:
        raise ValueError("valid must be bool [B, N]")
    return boxes.contiguous(), valid.contiguous()


@_kernels.counted
def nms_keep_sorted_cuda(
    boxes: torch.Tensor, valid: torch.Tensor, iou_threshold: float
) -> torch.Tensor:
    """The bitmask kernel of ``csrc/nms.cu`` (same contract as
    :func:`nms_keep_sorted_plain`). Two launches per call: the pairwise
    suppression mask, then the greedy scan."""
    boxes, valid = _sorted_args(boxes, valid, "nms_keep_sorted_cuda")
    if boxes.data_ptr() % 16:  # the kernel reads a box as one float4
        boxes = boxes.clone()
    b, n = valid.shape
    words = -(-n // 64)
    mask = torch.empty(b, n, words, dtype=torch.int64, device=boxes.device)
    keep = torch.empty(b, n, dtype=torch.bool, device=boxes.device)
    lib = _kernels.load("nms")
    _kernels.check(
        lib.vt_nms_keep(
            boxes.data_ptr(), valid.data_ptr(), mask.data_ptr(),
            keep.data_ptr(), b, n, float(iou_threshold),
            _kernels.stream_handle(boxes),
        ),
        "nms kernel",
    )
    return keep


@_kernels.counted
def nms_keep_sorted_rowscan_cuda(
    boxes: torch.Tensor, valid: torch.Tensor, iou_threshold: float
) -> torch.Tensor:
    """The row-serial kernel of ``csrc/nms_rowscan.cu`` (same contract and
    the same mask as :func:`nms_keep_sorted_plain`). One launch per call,
    one block per batch row, no scratch."""
    boxes, valid = _sorted_args(boxes, valid, "nms_keep_sorted_rowscan_cuda")
    if boxes.data_ptr() % 16:  # the kernel reads a box as one float4
        boxes = boxes.clone()
    b, n = valid.shape
    keep = torch.empty(b, n, dtype=torch.bool, device=boxes.device)
    lib = _kernels.load("nms_rowscan")
    _kernels.check(
        lib.vt_nms_rowscan(
            boxes.data_ptr(), valid.data_ptr(), keep.data_ptr(), b, n,
            float(iou_threshold), _kernels.stream_handle(boxes),
        ),
        "nms_rowscan kernel",
    )
    return keep


def nms_keep_sorted(
    boxes: torch.Tensor, valid: torch.Tensor, iou_threshold: float
) -> torch.Tensor:
    """Greedy NMS over score-sorted rows: a CUDA kernel for CUDA tensors
    (the bitmask one, or the row-serial one under
    ``VISION_TPU_NMS_KERNEL=rowscan``), the plain version for CPU tensors."""
    if boxes.device.type == "cpu":
        return nms_keep_sorted_plain(boxes, valid, iou_threshold)
    if os.environ.get("VISION_TPU_NMS_KERNEL", "bitmask") == "rowscan":
        return nms_keep_sorted_rowscan_cuda(boxes, valid, iou_threshold)
    return nms_keep_sorted_cuda(boxes, valid, iou_threshold)


def nms_mask(
    boxes: torch.Tensor,
    scores: torch.Tensor,
    iou_threshold: float,
    valid: Optional[torch.Tensor] = None,
    presorted: bool = False,
) -> torch.Tensor:
    """Greedy NMS keep mask aligned with the input order.

    ``boxes [N, 4]`` / ``scores [N]``, or a batch ``[B, N, 4]`` /
    ``[B, N]`` of independent problems. ``valid`` marks padding rows
    (False = never kept, never suppresses). ``presorted=True`` is the
    caller's promise that each row is already in descending score order
    with ties in index order (as :func:`~vision_tpu_torch.ops._topk.top_k`
    returns it), which skips the sort and the scatter back.
    """
    single = scores.dim() == 1
    if single:
        boxes, scores = boxes[None], scores[None]
        valid = valid[None] if valid is not None else None
    if scores.shape[-1] == 0:
        keep = torch.zeros(scores.shape, dtype=torch.bool, device=scores.device)
        return keep[0] if single else keep
    boxes = boxes.float()
    scores = scores.float()
    if valid is not None:
        scores = torch.where(valid, scores, torch.full_like(scores, -torch.inf))

    if presorted:
        vmask = scores > -torch.inf
        sboxes = torch.where(vmask[..., None], boxes, torch.zeros_like(boxes))
        keep = nms_keep_sorted(sboxes, vmask, iou_threshold) & vmask
    else:
        sscores, order = torch.sort(scores, dim=-1, descending=True, stable=True)
        vsorted = sscores > -torch.inf
        sboxes = torch.gather(boxes, 1, order[..., None].expand(-1, -1, 4))
        sboxes = torch.where(vsorted[..., None], sboxes, torch.zeros_like(sboxes))
        keep_sorted = nms_keep_sorted(sboxes, vsorted, iou_threshold) & vsorted
        keep = torch.zeros_like(keep_sorted).scatter_(1, order, keep_sorted)
    return keep[0] if single else keep


def _kept_indices(keep: torch.Tensor, scores: torch.Tensor) -> torch.Tensor:
    """Kept indices in descending score order, ``-1`` behind (length N)."""
    n = scores.shape[0]
    order = torch.sort(scores.float(), descending=True, stable=True).indices
    kept = order[keep[order]]
    out = torch.full((n,), -1, dtype=torch.int64, device=scores.device)
    out[: kept.shape[0]] = kept
    return out


def nms(
    boxes: torch.Tensor, scores: torch.Tensor, iou_threshold: float
) -> torch.Tensor:
    """Reference-shaped NMS: kept indices in descending score order,
    padded with ``-1`` to length N."""
    if boxes.shape[0] == 0:
        return torch.zeros(0, dtype=torch.int64, device=boxes.device)
    return _kept_indices(nms_mask(boxes, scores, iou_threshold), scores)


def batched_nms_mask(
    boxes: torch.Tensor,
    scores: torch.Tensor,
    idxs: torch.Tensor,
    iou_threshold: float,
    valid: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Category-aware keep mask: boxes of different ``idxs`` are moved to
    disjoint regions, by ``idxs * (max coordinate + 1)``, so they never
    overlap. The max is taken over valid boxes only, so padding rows with
    large coordinates cannot inflate it. Takes ``[N]`` or ``[B, N]``."""
    if scores.shape[-1] == 0:
        return torch.zeros(scores.shape, dtype=torch.bool, device=scores.device)
    boxes = boxes.float()
    if valid is not None:
        masked = torch.where(valid[..., None], boxes, torch.zeros_like(boxes))
    else:
        masked = boxes
    max_coord = masked.flatten(-2).amax(-1)  # [] or [B]
    offsets = idxs.float() * (max_coord[..., None] + 1.0)
    return nms_mask(boxes + offsets[..., None], scores, iou_threshold,
                    valid=valid)


def batched_nms(
    boxes: torch.Tensor,
    scores: torch.Tensor,
    idxs: torch.Tensor,
    iou_threshold: float,
) -> torch.Tensor:
    """Reference-shaped batched NMS: ``-1``-padded kept indices in
    descending score order."""
    if boxes.shape[0] == 0:
        return torch.zeros(0, dtype=torch.int64, device=boxes.device)
    keep = batched_nms_mask(boxes, scores, idxs, iou_threshold)
    return _kept_indices(keep, scores)
