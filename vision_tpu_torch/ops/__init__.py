"""Operators (counterpart of ``vision_tpu/ops``)."""

from vision_tpu_torch.ops._conv1x1_bn import matmul_stats
from vision_tpu_torch.ops.boxes import (
    box_area,
    box_convert,
    box_iou,
    box_iou_rotated,
    clip_boxes_to_image,
    complete_box_iou,
    distance_box_iou,
    generalized_box_iou,
    masks_to_boxes,
    remove_small_boxes,
)
from vision_tpu_torch.ops.misc import BatchNorm2d, FrozenBatchNorm2d
from vision_tpu_torch.ops.nms import batched_nms, batched_nms_mask, nms, nms_mask
from vision_tpu_torch.ops.poolers import MultiScaleRoIAlign
from vision_tpu_torch.ops.roi_align import roi_align

__all__ = [
    "BatchNorm2d",
    "FrozenBatchNorm2d",
    "MultiScaleRoIAlign",
    "batched_nms",
    "batched_nms_mask",
    "box_area",
    "box_convert",
    "box_iou",
    "box_iou_rotated",
    "clip_boxes_to_image",
    "complete_box_iou",
    "distance_box_iou",
    "generalized_box_iou",
    "masks_to_boxes",
    "matmul_stats",
    "nms",
    "nms_mask",
    "remove_small_boxes",
    "roi_align",
]
