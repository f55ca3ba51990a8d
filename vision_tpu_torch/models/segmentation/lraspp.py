"""LR-ASPP (counterpart of ``vision_tpu/models/segmentation/lraspp.py``):
lraspp_mobilenet_v3_large.

NCHW input; torchvision's names (``backbone.0`` .. ``backbone.16``,
``classifier.cbr.{0,1}``, ``classifier.scale.1``,
``classifier.low_classifier``, ``classifier.high_classifier``). The output
is ``{"out": [N, classes, H, W]}``; there is no auxiliary head.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import torch
from torch import nn

from vision_tpu_torch.models._api import WeightsEnum, register_model
from vision_tpu_torch.models._utils import Device, build
from vision_tpu_torch.models.segmentation._backbones import (
    DilatedMobileNetV3Trunk,
)
from vision_tpu_torch.models.segmentation._utils import (
    init_weights,
    seg_weights as _w,
    upsample,
)
from vision_tpu_torch.ops.misc import BatchNorm2d
from vision_tpu_torch.transforms.v2.functional._resample import resize_2d

__all__ = [
    "LRASPP",
    "LRASPPHead",
    "LRASPP_MobileNet_V3_Large_Weights",
    "lraspp_mobilenet_v3_large",
]


class LRASPPHead(nn.Module):
    """The high map through 1x1 conv, batch norm and ReLU, scaled by a
    sigmoid gate from its mean, upsampled to the low map; the two maps'
    1x1 classifiers summed."""

    def __init__(self, low_channels: int, high_channels: int,
                 num_classes: int, inter_channels: int = 128):
        super().__init__()
        self.cbr = nn.Sequential(
            nn.Conv2d(high_channels, inter_channels, 1, bias=False),
            BatchNorm2d(inter_channels), nn.ReLU())
        self.scale = nn.Sequential(
            nn.AdaptiveAvgPool2d(1),
            nn.Conv2d(high_channels, inter_channels, 1, bias=False),
            nn.Sigmoid())
        self.low_classifier = nn.Conv2d(low_channels, num_classes, 1)
        self.high_classifier = nn.Conv2d(inter_channels, num_classes, 1)

    def forward(self, low: torch.Tensor, high: torch.Tensor) -> torch.Tensor:
        x = self.cbr(high)
        _, conv, sigmoid = self.scale
        x = x * sigmoid(conv(high.mean((-2, -1), keepdim=True)))
        x = resize_2d(x, tuple(low.shape[-2:]), mode="bilinear",
                      antialias=False)
        return self.low_classifier(low) + self.high_classifier(x)


class LRASPP(nn.Module):
    def __init__(self, num_classes: int = 21):
        super().__init__()
        self.backbone = DilatedMobileNetV3Trunk()
        self.classifier = LRASPPHead(40, 960, num_classes)

    def forward(self, x: torch.Tensor,
                generator: Optional[torch.Generator] = None
                ) -> Dict[str, torch.Tensor]:
        feats = self.backbone(x)
        return upsample({"out": self.classifier(feats["low"], feats["out"])},
                        x.shape[-2:])


class LRASPP_MobileNet_V3_Large_Weights(WeightsEnum):
    COCO_WITH_VOC_LABELS_V1 = _w("lraspp_mobilenet_v3_large-d234d4ea.pth",
                                 57.9, 91.2, 3221538, 2.086)
    DEFAULT = COCO_WITH_VOC_LABELS_V1


@register_model()
def lraspp_mobilenet_v3_large(
        *, weights: Optional[LRASPP_MobileNet_V3_Large_Weights] = None,
        device: Device = None, seed: int = 0, **kwargs: Any) -> LRASPP:
    weights = LRASPP_MobileNet_V3_Large_Weights.verify(weights)
    return build(lambda: LRASPP(**kwargs), init_weights, weights, device, seed)
