"""MobileNetV2 (counterpart of ``vision_tpu/models/mobilenetv2.py``).

NCHW input; torchvision's module and state-dict names
(``features.{i}.conv.{j}``, ``classifier.1``). ReLU6 activations; the
classifier's dropout draws from ``forward(x, generator=g)`` in training
mode.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional

import torch
from torch import nn

from vision_tpu_torch.models._api import WeightsEnum, register_model
from vision_tpu_torch.models._utils import (
    Device,
    _make_divisible,
    build,
    cls_weights as _w,
    fan_out_init,
    normal_linear,
)
from vision_tpu_torch.ops.misc import (
    BatchNorm2d,
    Conv2dNormActivation,
    dropout as _dropout,
)

__all__ = ["MobileNetV2", "MobileNet_V2_Weights",
           "mobilenet_v2"]


def _cna(cin: int, cout: int, kernel: int = 3, stride: int = 1,
         groups: int = 1) -> Conv2dNormActivation:
    return Conv2dNormActivation(cin, cout, kernel, stride, groups=groups,
                                activation_layer=nn.ReLU6, inplace=None)


class InvertedResidual(nn.Module):
    """Expansion 1x1 (unless ``expand_ratio`` is 1), depthwise 3x3, linear
    projection; the residual where the shape is kept."""

    def __init__(self, inp: int, oup: int, stride: int, expand_ratio: int):
        super().__init__()
        hidden = int(round(inp * expand_ratio))
        self.use_res = stride == 1 and inp == oup
        layers: List[nn.Module] = []
        if expand_ratio != 1:
            layers.append(_cna(inp, hidden, 1))
        layers += [_cna(hidden, hidden, 3, stride, groups=hidden),
                   nn.Conv2d(hidden, oup, 1, bias=False), BatchNorm2d(oup)]
        self.conv = nn.Sequential(*layers)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x + self.conv(x) if self.use_res else self.conv(x)


_SETTING = [  # t, c, n, s
    [1, 16, 1, 1], [6, 24, 2, 2], [6, 32, 3, 2], [6, 64, 4, 2],
    [6, 96, 3, 1], [6, 160, 3, 2], [6, 320, 1, 1],
]


class MobileNetV2(nn.Module):
    """torchvision's ``MobileNetV2``. ``forward(x, return_features=True)``
    also returns every ``features.{i}``'s output."""

    def __init__(self, num_classes: int = 1000, width_mult: float = 1.0,
                 round_nearest: int = 8, dropout: float = 0.2):
        super().__init__()
        self.dropout = dropout
        cin = _make_divisible(32 * width_mult, round_nearest)
        last = _make_divisible(1280 * max(1.0, width_mult), round_nearest)
        layers: List[nn.Module] = [_cna(3, cin, stride=2)]
        for t, c, n, s in _SETTING:
            cout = _make_divisible(c * width_mult, round_nearest)
            for i in range(n):
                layers.append(InvertedResidual(cin, cout, s if i == 0 else 1, t))
                cin = cout
        layers.append(_cna(cin, last, 1))
        self.features = nn.Sequential(*layers)
        self.classifier = nn.Sequential(nn.Dropout(dropout),
                                        nn.Linear(last, num_classes))

    def forward(self, x: torch.Tensor, return_features: bool = False,
                generator: Optional[torch.Generator] = None):
        features: Dict[str, torch.Tensor] = {}
        for i, layer in enumerate(self.features):
            x = layer(x)
            features[f"features.{i}"] = x
        x = _dropout(x.mean((2, 3)), self.dropout, self.training, generator)
        logits = self.classifier[1](x)
        if return_features:
            return logits, features
        return logits


@torch.no_grad()
def init_weights(model: nn.Module, generator: torch.Generator) -> None:
    """torchvision's: convs He-normal over the fan out, zero bias; Linears
    normal of std 0.01, zero bias; norms identity."""
    fan_out_init(model, generator, normal_linear(0.01))


class MobileNet_V2_Weights(WeightsEnum):
    IMAGENET1K_V1 = _w("mobilenet_v2-b0353104.pth", 71.878, 90.286, 3504872,
                       0.301)
    IMAGENET1K_V2 = _w("mobilenet_v2-7ebf99e0.pth", 72.154, 90.822, 3504872,
                       0.301, resize=232)
    DEFAULT = IMAGENET1K_V2


@register_model()
def mobilenet_v2(*, weights: Optional[MobileNet_V2_Weights] = None,
                 device: Device = None, seed: int = 0,
                 **kwargs: Any) -> MobileNetV2:
    weights = MobileNet_V2_Weights.verify(weights)
    return build(lambda: MobileNetV2(**kwargs), init_weights, weights, device,
                 seed)
