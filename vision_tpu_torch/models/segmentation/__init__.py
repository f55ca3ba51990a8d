"""Semantic segmentation (counterpart of
``vision_tpu/models/segmentation``): FCN, DeepLabV3 and LR-ASPP."""

from vision_tpu_torch.models.segmentation.deeplabv3 import (
    ASPP,
    DeepLabHead,
    DeepLabV3,
    DeepLabV3_MobileNet_V3_Large_Weights,
    DeepLabV3_ResNet50_Weights,
    DeepLabV3_ResNet101_Weights,
    deeplabv3_mobilenet_v3_large,
    deeplabv3_resnet50,
    deeplabv3_resnet101,
)
from vision_tpu_torch.models.segmentation.fcn import (
    FCN,
    FCNHead,
    FCN_ResNet50_Weights,
    FCN_ResNet101_Weights,
    fcn_resnet50,
    fcn_resnet101,
)
from vision_tpu_torch.models.segmentation.lraspp import (
    LRASPP,
    LRASPP_MobileNet_V3_Large_Weights,
    lraspp_mobilenet_v3_large,
)

__all__ = [
    "ASPP",
    "DeepLabHead",
    "DeepLabV3",
    "DeepLabV3_MobileNet_V3_Large_Weights",
    "DeepLabV3_ResNet50_Weights",
    "DeepLabV3_ResNet101_Weights",
    "FCN",
    "FCNHead",
    "FCN_ResNet50_Weights",
    "FCN_ResNet101_Weights",
    "LRASPP",
    "LRASPP_MobileNet_V3_Large_Weights",
    "deeplabv3_mobilenet_v3_large",
    "deeplabv3_resnet50",
    "deeplabv3_resnet101",
    "fcn_resnet50",
    "fcn_resnet101",
    "lraspp_mobilenet_v3_large",
]
