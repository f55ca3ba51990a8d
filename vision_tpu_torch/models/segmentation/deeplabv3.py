"""DeepLabV3 (counterpart of
``vision_tpu/models/segmentation/deeplabv3.py``): deeplabv3_resnet50,
deeplabv3_resnet101, deeplabv3_mobilenet_v3_large.

NCHW input; torchvision's names (``backbone.*``,
``classifier.0.convs.{i}``, ``classifier.0.project.{0,1}``,
``classifier.{1,2,4}``, ``aux_classifier.*``). The auxiliary ``FCNHead`` is
always built, as in the JAX model. ASPP: a 1x1 branch, three atrous 3x3
branches, and the image-pooling branch (the mean over the map, 1x1
convolution, batch norm, ReLU, broadcast back over the map), concatenated,
projected, and dropped out (0.5). In training the pooling branch's batch
norm normalises over the batch alone; at batch 1 its variance is 0 and it
gives its bias, as flax does (``torch.nn.BatchNorm2d`` raises). Dropout
draws from ``forward(x, generator=g)``; ``aspp_dropout=0.0`` and
``head_dropout=0.0`` build the model without it.
"""

from __future__ import annotations

from typing import Any, Optional, Sequence

import torch
from torch import nn

from vision_tpu_torch.models._api import WeightsEnum, register_model
from vision_tpu_torch.models._utils import Device, build
from vision_tpu_torch.models.segmentation._backbones import (
    DilatedMobileNetV3Trunk,
    DilatedResNetTrunk,
)
from vision_tpu_torch.models.segmentation._utils import (
    SimpleSegmentationModel,
    init_weights,
    seg_weights as _w,
)
from vision_tpu_torch.models.segmentation.fcn import FCNHead
from vision_tpu_torch.ops import misc
from vision_tpu_torch.ops.misc import BatchNorm2d

__all__ = [
    "ASPP",
    "DeepLabHead",
    "DeepLabV3",
    "DeepLabV3_MobileNet_V3_Large_Weights",
    "DeepLabV3_ResNet50_Weights",
    "DeepLabV3_ResNet101_Weights",
    "deeplabv3_mobilenet_v3_large",
    "deeplabv3_resnet50",
    "deeplabv3_resnet101",
]


def _cbr(cin: int, cout: int, kernel: int = 1, dilation: int = 1) -> list:
    return [nn.Conv2d(cin, cout, kernel, padding=dilation * (kernel // 2),
                      dilation=dilation, bias=False),
            BatchNorm2d(cout), nn.ReLU()]


class ASPP(nn.Module):
    def __init__(self, in_channels: int, atrous_rates: Sequence[int] = (12, 24, 36),
                 out_channels: int = 256, dropout: float = 0.5):
        super().__init__()
        convs = [nn.Sequential(*_cbr(in_channels, out_channels))]
        convs += [nn.Sequential(*_cbr(in_channels, out_channels, 3, rate))
                  for rate in atrous_rates]
        convs.append(nn.Sequential(nn.AdaptiveAvgPool2d(1),
                                   *_cbr(in_channels, out_channels)))
        self.convs = nn.ModuleList(convs)
        n = len(convs)
        self.project = nn.Sequential(*_cbr(n * out_channels, out_channels),
                                     nn.Dropout(dropout))

    def forward(self, x: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        res = [branch(x) for branch in self.convs[:-1]]
        _, conv, bn, relu = self.convs[-1]
        pooled = relu(bn(conv(x.mean((-2, -1), keepdim=True))))
        res.append(pooled.expand(-1, -1, *x.shape[-2:]))
        conv, bn, relu, drop = self.project
        out = relu(bn(conv(torch.cat(res, 1))))
        return misc.dropout(out, drop.p, self.training, generator)


class DeepLabHead(nn.Sequential):
    """ASPP, a 3x3 convolution, batch norm, ReLU, 1x1 to the classes."""

    def __init__(self, in_channels: int, num_classes: int,
                 atrous_rates: Sequence[int] = (12, 24, 36),
                 dropout: float = 0.5):
        super().__init__(ASPP(in_channels, atrous_rates, dropout=dropout),
                         *_cbr(256, 256, 3), nn.Conv2d(256, num_classes, 1))

    def forward(self, x: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        aspp, conv, bn, relu, out = self
        return out(relu(bn(conv(aspp(x, generator)))))


class DeepLabV3(SimpleSegmentationModel):
    """The dilated trunk (``"resnet"``: ResNet-50/101 by ``layers``;
    ``"mobilenet"``: MobileNetV3-Large), ``DeepLabHead`` on its ``out``
    map, ``FCNHead`` on its ``aux`` map, each upsampled to the input."""

    def __init__(self, backbone_type: str = "resnet",
                 layers: Sequence[int] = (3, 4, 6, 3), num_classes: int = 21,
                 aspp_dropout: float = 0.5, head_dropout: float = 0.1):
        super().__init__()
        if backbone_type == "resnet":
            self.backbone = DilatedResNetTrunk(layers)
            out_ch, aux_ch = 2048, 1024
        elif backbone_type == "mobilenet":
            self.backbone = DilatedMobileNetV3Trunk()
            out_ch, aux_ch = 960, 40
        else:
            raise ValueError(f"backbone_type {backbone_type!r}")
        self.classifier = DeepLabHead(out_ch, num_classes,
                                      dropout=aspp_dropout)
        self.aux_classifier = FCNHead(aux_ch, num_classes, head_dropout)


class DeepLabV3_ResNet50_Weights(WeightsEnum):
    COCO_WITH_VOC_LABELS_V1 = _w("deeplabv3_resnet50_coco-cd0a2569.pth", 66.4,
                                 92.4, 42004074, 178.722)
    DEFAULT = COCO_WITH_VOC_LABELS_V1


class DeepLabV3_ResNet101_Weights(WeightsEnum):
    COCO_WITH_VOC_LABELS_V1 = _w("deeplabv3_resnet101_coco-586e9e4e.pth",
                                 67.4, 92.4, 60996202, 258.743)
    DEFAULT = COCO_WITH_VOC_LABELS_V1


class DeepLabV3_MobileNet_V3_Large_Weights(WeightsEnum):
    COCO_WITH_VOC_LABELS_V1 = _w("deeplabv3_mobilenet_v3_large-fc3c493d.pth",
                                 60.3, 91.2, 11029328, 10.452)
    DEFAULT = COCO_WITH_VOC_LABELS_V1


def _deeplab(weights, device: Device, seed: int, **kwargs: Any) -> DeepLabV3:
    return build(lambda: DeepLabV3(**kwargs), init_weights, weights, device,
                 seed)


@register_model()
def deeplabv3_resnet50(*, weights: Optional[DeepLabV3_ResNet50_Weights] = None,
                       device: Device = None, seed: int = 0,
                       **kwargs: Any) -> DeepLabV3:
    return _deeplab(DeepLabV3_ResNet50_Weights.verify(weights), device, seed,
                    layers=(3, 4, 6, 3), **kwargs)


@register_model()
def deeplabv3_resnet101(
        *, weights: Optional[DeepLabV3_ResNet101_Weights] = None,
        device: Device = None, seed: int = 0, **kwargs: Any) -> DeepLabV3:
    return _deeplab(DeepLabV3_ResNet101_Weights.verify(weights), device, seed,
                    layers=(3, 4, 23, 3), **kwargs)


@register_model()
def deeplabv3_mobilenet_v3_large(
        *, weights: Optional[DeepLabV3_MobileNet_V3_Large_Weights] = None,
        device: Device = None, seed: int = 0, **kwargs: Any) -> DeepLabV3:
    return _deeplab(DeepLabV3_MobileNet_V3_Large_Weights.verify(weights),
                    device, seed, backbone_type="mobilenet", **kwargs)
