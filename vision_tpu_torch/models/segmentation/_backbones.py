"""Segmentation trunks (counterpart of
``vision_tpu/models/segmentation/_backbones.py``): the dilated ResNet body
and the dilated MobileNetV3-Large feature list, under torchvision's
``backbone.*`` names (``IntermediateLayerGetter``'s: ``backbone.conv1``,
``backbone.layer1`` ..., or ``backbone.0`` .. ``backbone.16``). Input
NCHW; each returns a dict of its feature maps."""

from __future__ import annotations

from typing import Dict, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from vision_tpu_torch.models.mobilenetv3 import (
    InvertedResidual,
    _cna,
    _large_setting,
)
from vision_tpu_torch.models.resnet import Bottleneck, ResNet

__all__ = ["DilatedMobileNetV3Trunk", "DilatedResNetTrunk"]


class DilatedResNetTrunk(ResNet):
    """ResNet-50/101's body with layer3 and layer4 dilated instead of
    strided (``replace_stride_with_dilation=(False, True, True)``: output
    stride 8) and no ``fc``; returns ``{"aux": layer3, "out": layer4}``."""

    def __init__(self, layers: Sequence[int]):
        super().__init__(Bottleneck, layers,
                         replace_stride_with_dilation=(False, True, True))
        del self.fc

    def forward(self, x: torch.Tensor) -> Dict[str, torch.Tensor]:
        x = F.max_pool2d(F.relu(self.bn1(self.conv1(x))), 3, 2, 1)
        x = self.layer3(self.layer2(self.layer1(x)))
        return {"aux": x, "out": self.layer4(x)}


class DilatedMobileNetV3Trunk(nn.Sequential):
    """MobileNetV3-Large's features with the last stage dilated (output
    stride 16), children ``0`` .. ``16``; returns ``{"low": ..., "aux":
    ...}`` from block 4 (40 channels, stride 8; the JAX trunk feeds both
    the LR-ASPP low branch and the auxiliary head from it) and ``"out"``
    from the last convolution (960 channels)."""

    def __init__(self):
        setting, _ = _large_setting(dilated=True)
        layers = [_cna(3, setting[0].input_channels, 3, 2)]
        layers += [InvertedResidual(c) for c in setting]
        layers.append(_cna(setting[-1].out_channels,
                           6 * setting[-1].out_channels, 1))
        super().__init__(*layers)

    def forward(self, x: torch.Tensor) -> Dict[str, torch.Tensor]:
        feats: Dict[str, torch.Tensor] = {}
        for i, layer in enumerate(self):
            x = layer(x)
            if i == 4:
                feats["low"] = feats["aux"] = x
        feats["out"] = x
        return feats
