"""Operators (counterpart of ``vision_tpu/ops``)."""

from vision_tpu_torch.ops._conv1x1_bn import matmul_stats
from vision_tpu_torch.ops.attention import (
    flash_attention,
    scaled_dot_product_attention,
)
from vision_tpu_torch.ops.deform_conv import DeformConv2d, deform_conv2d
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
from vision_tpu_torch.ops.losses import (
    complete_box_iou_loss,
    distance_box_iou_loss,
    generalized_box_iou_loss,
    sigmoid_focal_loss,
)
from vision_tpu_torch.ops.misc import BatchNorm2d, FrozenBatchNorm2d, GroupNorm
from vision_tpu_torch.ops.nms import batched_nms, batched_nms_mask, nms, nms_mask
from vision_tpu_torch.ops.poolers import MultiScaleRoIAlign
from vision_tpu_torch.ops.roi_align import roi_align

__all__ = [
    "BatchNorm2d",
    "DeformConv2d",
    "FrozenBatchNorm2d",
    "GroupNorm",
    "MultiScaleRoIAlign",
    "batched_nms",
    "batched_nms_mask",
    "box_area",
    "box_convert",
    "box_iou",
    "box_iou_rotated",
    "clip_boxes_to_image",
    "complete_box_iou",
    "complete_box_iou_loss",
    "deform_conv2d",
    "distance_box_iou",
    "distance_box_iou_loss",
    "flash_attention",
    "generalized_box_iou",
    "generalized_box_iou_loss",
    "masks_to_boxes",
    "matmul_stats",
    "nms",
    "nms_mask",
    "remove_small_boxes",
    "roi_align",
    "scaled_dot_product_attention",
    "sigmoid_focal_loss",
]
