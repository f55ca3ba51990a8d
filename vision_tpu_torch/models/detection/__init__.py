"""Detection models (counterpart of ``vision_tpu/models/detection``)."""

from vision_tpu_torch.models.detection.faster_rcnn import (
    FasterRCNN,
    FasterRCNN_ResNet50_FPN_Weights,
    fasterrcnn_resnet50_fpn,
)
from vision_tpu_torch.models.detection.roi_heads import Detections

__all__ = [
    "Detections",
    "FasterRCNN",
    "FasterRCNN_ResNet50_FPN_Weights",
    "fasterrcnn_resnet50_fpn",
]
