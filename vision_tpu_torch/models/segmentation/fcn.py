"""FCN (counterpart of ``vision_tpu/models/segmentation/fcn.py``):
fcn_resnet50, fcn_resnet101.

NCHW input; torchvision's names (``backbone.*``, ``classifier.{0,1,4}``,
``aux_classifier.{0,1,4}``). The auxiliary head is always built, as the
JAX model builds it (torchvision builds it only with weights). The
output is ``{"out": [N, classes, H, W], "aux": ...}`` at the input's size.
Dropout (0.1 in each head) draws from ``forward(x, generator=g)`` in
training mode; ``head_dropout=0.0`` builds the heads without it.
"""

from __future__ import annotations

from typing import Any, Optional, Sequence

import torch
from torch import nn

from vision_tpu_torch.models._api import WeightsEnum, register_model
from vision_tpu_torch.models._utils import Device, build
from vision_tpu_torch.models.segmentation._backbones import DilatedResNetTrunk
from vision_tpu_torch.models.segmentation._utils import (
    SimpleSegmentationModel,
    init_weights,
    seg_weights as _w,
)
from vision_tpu_torch.ops import misc
from vision_tpu_torch.ops.misc import BatchNorm2d

__all__ = [
    "FCN",
    "FCNHead",
    "FCN_ResNet50_Weights",
    "FCN_ResNet101_Weights",
    "fcn_resnet50",
    "fcn_resnet101",
]


class FCNHead(nn.Sequential):
    """3x3 convolution to a quarter of the channels, batch norm, ReLU,
    dropout, 1x1 convolution to the classes."""

    def __init__(self, in_channels: int, channels: int,
                 dropout: float = 0.1):
        inter = in_channels // 4
        super().__init__(
            nn.Conv2d(in_channels, inter, 3, padding=1, bias=False),
            BatchNorm2d(inter), nn.ReLU(), nn.Dropout(dropout),
            nn.Conv2d(inter, channels, 1))

    def forward(self, x: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        conv, bn, relu, drop, out = self
        x = relu(bn(conv(x)))
        return out(misc.dropout(x, drop.p, self.training, generator))


class FCN(SimpleSegmentationModel):
    """The dilated ResNet trunk, ``FCNHead`` on layer4 (``classifier``)
    and on layer3 (``aux_classifier``), each upsampled to the input."""

    def __init__(self, layers: Sequence[int] = (3, 4, 6, 3),
                 num_classes: int = 21, head_dropout: float = 0.1):
        super().__init__()
        self.backbone = DilatedResNetTrunk(layers)
        self.classifier = FCNHead(2048, num_classes, head_dropout)
        self.aux_classifier = FCNHead(1024, num_classes, head_dropout)


class FCN_ResNet50_Weights(WeightsEnum):
    COCO_WITH_VOC_LABELS_V1 = _w("fcn_resnet50_coco-1167a1af.pth", 60.5, 91.4,
                                 35322218, 152.717)
    DEFAULT = COCO_WITH_VOC_LABELS_V1


class FCN_ResNet101_Weights(WeightsEnum):
    COCO_WITH_VOC_LABELS_V1 = _w("fcn_resnet101_coco-7ecb50ca.pth", 63.7,
                                 91.9, 54314346, 232.738)
    DEFAULT = COCO_WITH_VOC_LABELS_V1


def _fcn(layers, weights, device: Device, seed: int, **kwargs: Any) -> FCN:
    return build(lambda: FCN(layers, **kwargs), init_weights, weights, device,
                 seed)


@register_model()
def fcn_resnet50(*, weights: Optional[FCN_ResNet50_Weights] = None,
                 device: Device = None, seed: int = 0, **kwargs: Any) -> FCN:
    return _fcn((3, 4, 6, 3), FCN_ResNet50_Weights.verify(weights), device,
                seed, **kwargs)


@register_model()
def fcn_resnet101(*, weights: Optional[FCN_ResNet101_Weights] = None,
                  device: Device = None, seed: int = 0, **kwargs: Any) -> FCN:
    return _fcn((3, 4, 23, 3), FCN_ResNet101_Weights.verify(weights), device,
                seed, **kwargs)
