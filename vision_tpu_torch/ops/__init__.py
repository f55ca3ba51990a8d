"""Operators (counterpart of ``vision_tpu/ops``). Every name of
``vision_tpu.ops.__all__`` but the quantised ``qnms`` and ``qroi_align``,
and the port's own (``BatchNorm2d``, ``GroupNorm``, ``flash_attention``,
``matmul_stats``, ``scaled_dot_product_attention``)."""

from vision_tpu_torch.ops._conv1x1_bn import matmul_stats
from vision_tpu_torch.ops._wrappers import (
    DropBlock2d,
    DropBlock3d,
    PSRoIAlign,
    PSRoIPool,
    RoIAlign,
    RoIPool,
    StochasticDepth,
)
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
from vision_tpu_torch.ops.drop_block import drop_block2d, drop_block3d
from vision_tpu_torch.ops.feature_pyramid_network import (
    FeaturePyramidNetwork,
    LastLevelMaxPool,
    LastLevelP6P7,
)
from vision_tpu_torch.ops.losses import (
    complete_box_iou_loss,
    distance_box_iou_loss,
    generalized_box_iou_loss,
    sigmoid_focal_loss,
)
from vision_tpu_torch.ops.misc import (
    MLP,
    BatchNorm2d,
    Conv2dNormActivation,
    Conv3dNormActivation,
    FrozenBatchNorm2d,
    GroupNorm,
    Permute,
    SqueezeExcitation,
)
from vision_tpu_torch.ops.nms import batched_nms, batched_nms_mask, nms, nms_mask
from vision_tpu_torch.ops.poolers import LevelMapper, MultiScaleRoIAlign
from vision_tpu_torch.ops.ps_roi_align import ps_roi_align
from vision_tpu_torch.ops.ps_roi_pool import ps_roi_pool
from vision_tpu_torch.ops.roi_align import roi_align
from vision_tpu_torch.ops.roi_pool import roi_pool
from vision_tpu_torch.ops.stochastic_depth import stochastic_depth

__all__ = [
    "MLP",
    "BatchNorm2d",
    "Conv2dNormActivation",
    "Conv3dNormActivation",
    "DeformConv2d",
    "DropBlock2d",
    "DropBlock3d",
    "FeaturePyramidNetwork",
    "FrozenBatchNorm2d",
    "GroupNorm",
    "LastLevelMaxPool",
    "LastLevelP6P7",
    "LevelMapper",
    "MultiScaleRoIAlign",
    "PSRoIAlign",
    "PSRoIPool",
    "Permute",
    "RoIAlign",
    "RoIPool",
    "SqueezeExcitation",
    "StochasticDepth",
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
    "drop_block2d",
    "drop_block3d",
    "flash_attention",
    "generalized_box_iou",
    "generalized_box_iou_loss",
    "masks_to_boxes",
    "matmul_stats",
    "nms",
    "nms_mask",
    "ps_roi_align",
    "ps_roi_pool",
    "remove_small_boxes",
    "roi_align",
    "roi_pool",
    "scaled_dot_product_attention",
    "sigmoid_focal_loss",
    "stochastic_depth",
]
