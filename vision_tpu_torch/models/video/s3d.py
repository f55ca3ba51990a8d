"""S3D (counterpart of ``vision_tpu/models/video/s3d.py``): s3d.

Input ``[N, C, T, H, W]``; torchvision's names (``features.{i}``: the
separable stem ``features.0.{0,1}.{0,1}``, ``features.2``, ``features.3``,
the inception blocks ``features.{5,6,8..12,14,15}.branch{0..3}``;
``classifier.1``). Batch norm eps 1e-3, torch momentum 0.001. The max
pools pad with -inf, as flax's do; the head is the global mean, dropout
(drawn from ``forward(x, generator=g)`` in training) and a 1x1x1
convolution, averaged over the map.
"""

from __future__ import annotations

import functools
from typing import Any, Dict, List, Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from vision_tpu_torch.models._api import WeightsEnum, register_model
from vision_tpu_torch.models._utils import Device, build, default_, init_norms
from vision_tpu_torch.models.video._utils import video_weights
from vision_tpu_torch.ops.misc import (
    BatchNorm3d,
    Conv3dNormActivation,
    dropout as _dropout,
)

__all__ = ["S3D", "S3D_Weights", "s3d"]

_BN = functools.partial(BatchNorm3d, eps=1e-3, momentum=0.001)


def _cna3d(cin: int, cout: int, kernel, stride=(1, 1, 1)) -> nn.Module:
    return Conv3dNormActivation(cin, cout, kernel, stride, norm_layer=_BN)


def _sep_conv(cin: int, cout: int, k: int, s: int) -> nn.Sequential:
    return nn.Sequential(_cna3d(cin, cout, (1, k, k), (1, s, s)),
                         _cna3d(cout, cout, (k, 1, 1), (s, 1, 1)))


class _MaxPool3d(nn.Module):
    def __init__(self, kernel, stride, padding):
        super().__init__()
        self.kernel, self.stride, self.padding = kernel, stride, padding

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.max_pool3d(x, self.kernel, self.stride, self.padding)


class SepInceptionBlock3D(nn.Module):
    def __init__(self, cin: int, b0_out: int, b1_mid: int, b1_out: int,
                 b2_mid: int, b2_out: int, b3_out: int):
        super().__init__()
        self.branch0 = _cna3d(cin, b0_out, (1, 1, 1))
        self.branch1 = nn.Sequential(_cna3d(cin, b1_mid, (1, 1, 1)),
                                     _sep_conv(b1_mid, b1_out, 3, 1))
        self.branch2 = nn.Sequential(_cna3d(cin, b2_mid, (1, 1, 1)),
                                     _sep_conv(b2_mid, b2_out, 3, 1))
        self.branch3 = nn.Sequential(_MaxPool3d(3, 1, 1),
                                     _cna3d(cin, b3_out, (1, 1, 1)))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return torch.cat([self.branch0(x), self.branch1(x), self.branch2(x),
                          self.branch3(x)], 1)


_BLOCKS: Sequence = (
    (64, 96, 128, 16, 32, 32), (128, 128, 192, 32, 96, 64), "M2",
    (192, 96, 208, 16, 48, 64), (160, 112, 224, 24, 64, 64),
    (128, 128, 256, 24, 64, 64), (112, 144, 288, 32, 64, 64),
    (256, 160, 320, 32, 128, 128), "M3", (256, 160, 320, 32, 128, 128),
    (384, 192, 384, 48, 128, 128))


class S3D(nn.Module):
    """``forward(x, return_features=True)`` also returns the stem's output
    (``stem``) and each later feature's (``features.{i}``)."""

    def __init__(self, num_classes: int = 400, dropout: float = 0.2):
        super().__init__()
        layers: List[nn.Module] = [
            _sep_conv(3, 64, 7, 2), _MaxPool3d((1, 3, 3), (1, 2, 2), (0, 1, 1)),
            _cna3d(64, 64, (1, 1, 1)), _sep_conv(64, 192, 3, 1),
            _MaxPool3d((1, 3, 3), (1, 2, 2), (0, 1, 1))]
        cin = 192
        for b in _BLOCKS:
            if b == "M2":
                layers.append(_MaxPool3d(3, 2, 1))
            elif b == "M3":
                layers.append(_MaxPool3d(2, 2, 0))
            else:
                layers.append(SepInceptionBlock3D(cin, *b))
                cin = b[0] + b[2] + b[4] + b[5]
        self.features = nn.Sequential(*layers)
        self.dropout = dropout
        self.classifier = nn.Sequential(nn.Dropout(dropout),
                                        nn.Conv3d(cin, num_classes, 1))

    def forward(self, x: torch.Tensor, return_features: bool = False,
                generator: Optional[torch.Generator] = None):
        features: Dict[str, torch.Tensor] = {}
        for i, layer in enumerate(self.features):
            x = layer(x)
            if i == 4:
                features["stem"] = x
            elif i > 4:
                features[f"features.{i}"] = x
        x = x.mean((-3, -2, -1), keepdim=True)
        x = _dropout(x, self.dropout, self.training, generator)
        logits = self.classifier[1](x).mean((-3, -2, -1))
        if return_features:
            return logits, features
        return logits


@torch.no_grad()
def init_weights(model: nn.Module, generator: torch.Generator) -> None:
    """PyTorch's default for every convolution (torchvision's S3D sets no
    other); norms identity."""
    init_norms(model)
    for m in model.modules():
        if isinstance(m, nn.Conv3d):
            default_(m, generator)


class S3D_Weights(WeightsEnum):
    KINETICS400_V1 = video_weights("s3d-d76dad2f.pth", 68.368, 88.050,
                                   8320048, 17.979)
    DEFAULT = KINETICS400_V1


@register_model()
def s3d(*, weights: Optional[S3D_Weights] = None, device: Device = None,
        seed: int = 0, **kwargs: Any) -> S3D:
    weights = S3D_Weights.verify(weights)
    return build(lambda: S3D(**kwargs), init_weights, weights, device, seed)
