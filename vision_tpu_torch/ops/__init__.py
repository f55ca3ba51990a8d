"""Operators (counterpart of ``vision_tpu/ops``)."""

from vision_tpu_torch.ops._conv1x1_bn import matmul_stats
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
    "matmul_stats",
    "nms",
    "nms_mask",
    "roi_align",
]
