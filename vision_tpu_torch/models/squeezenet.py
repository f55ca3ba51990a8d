"""SqueezeNet 1.0 and 1.1 (counterpart of
``vision_tpu/models/squeezenet.py``).

NCHW input; torchvision's module and state-dict names (``features.{i}``,
``.squeeze``, ``.expand1x1``, ``.expand3x3``, ``classifier.1``). The max
pools keep partial windows (``ceil_mode=True``). The classifier's dropout
draws from ``forward(x, generator=g)`` in training mode.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import torch
import torch.nn.functional as F
from torch import nn

from vision_tpu_torch.models._api import WeightsEnum, register_model
from vision_tpu_torch.models._utils import (
    Device,
    build,
    cls_weights as _w,
    normal_,
    uniform_,
)
from vision_tpu_torch.ops.misc import dropout as _dropout

__all__ = ["SqueezeNet", "SqueezeNet1_0_Weights",
           "SqueezeNet1_1_Weights", "squeezenet1_0", "squeezenet1_1"]


class Fire(nn.Module):
    def __init__(self, inplanes: int, squeeze: int, expand1x1: int,
                 expand3x3: int):
        super().__init__()
        self.squeeze = nn.Conv2d(inplanes, squeeze, 1)
        self.expand1x1 = nn.Conv2d(squeeze, expand1x1, 1)
        self.expand3x3 = nn.Conv2d(squeeze, expand3x3, 3, padding=1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = F.relu(self.squeeze(x))
        return torch.cat([F.relu(self.expand1x1(x)),
                          F.relu(self.expand3x3(x))], 1)


def _pool() -> nn.MaxPool2d:
    return nn.MaxPool2d(3, 2, ceil_mode=True)


class SqueezeNet(nn.Module):
    """torchvision's ``SqueezeNet``. ``forward(x, return_features=True)``
    also returns the outputs of the Fire modules the JAX model names
    (1.0: ``features.10``, ``features.12``; 1.1: ``features.7``,
    ``features.12``)."""

    def __init__(self, version: str = "1_0", num_classes: int = 1000,
                 dropout: float = 0.5):
        super().__init__()
        self.dropout = dropout
        if version == "1_0":
            layers = [nn.Conv2d(3, 96, 7, 2), nn.ReLU(), _pool(),
                      Fire(96, 16, 64, 64), Fire(128, 16, 64, 64),
                      Fire(128, 32, 128, 128), _pool(),
                      Fire(256, 32, 128, 128), Fire(256, 48, 192, 192),
                      Fire(384, 48, 192, 192), Fire(384, 64, 256, 256), _pool(),
                      Fire(512, 64, 256, 256)]
            self.feature_names = ("features.10", "features.12")
        elif version == "1_1":
            layers = [nn.Conv2d(3, 64, 3, 2), nn.ReLU(), _pool(),
                      Fire(64, 16, 64, 64), Fire(128, 16, 64, 64), _pool(),
                      Fire(128, 32, 128, 128), Fire(256, 32, 128, 128), _pool(),
                      Fire(256, 48, 192, 192), Fire(384, 48, 192, 192),
                      Fire(384, 64, 256, 256), Fire(512, 64, 256, 256)]
            self.feature_names = ("features.7", "features.12")
        else:
            raise ValueError(f"unsupported SqueezeNet version {version}")
        self.features = nn.Sequential(*layers)
        self.classifier = nn.Sequential(nn.Dropout(dropout),
                                        nn.Conv2d(512, num_classes, 1),
                                        nn.ReLU(), nn.AdaptiveAvgPool2d(1))

    def forward(self, x: torch.Tensor, return_features: bool = False,
                generator: Optional[torch.Generator] = None):
        features: Dict[str, torch.Tensor] = {}
        for i, layer in enumerate(self.features):
            x = layer(x)
            if f"features.{i}" in self.feature_names:
                features[f"features.{i}"] = x
        x = _dropout(x, self.dropout, self.training, generator)
        logits = F.relu(self.classifier[1](x)).mean((2, 3))
        if return_features:
            return logits, features
        return logits


@torch.no_grad()
def init_weights(model: SqueezeNet, generator: torch.Generator) -> None:
    """torchvision's: the final convolution normal of std 0.01, the others
    ``kaiming_uniform_`` (bound sqrt(6 / fan in)); zero biases."""
    final = model.classifier[1]
    for m in model.modules():
        if isinstance(m, nn.Conv2d):
            if m is final:
                normal_(m.weight, 0.01, generator)
            else:
                uniform_(m.weight, (6.0 / m.weight[0].numel()) ** 0.5, generator)
            m.bias.zero_()


class SqueezeNet1_0_Weights(WeightsEnum):
    IMAGENET1K_V1 = _w("squeezenet1_0-b66bff10.pth", 58.092, 80.42, 1248424,
                       0.819)
    DEFAULT = IMAGENET1K_V1


class SqueezeNet1_1_Weights(WeightsEnum):
    IMAGENET1K_V1 = _w("squeezenet1_1-b8a52dc0.pth", 58.178, 80.624, 1235496,
                       0.349)
    DEFAULT = IMAGENET1K_V1


@register_model()
def squeezenet1_0(*, weights: Optional[SqueezeNet1_0_Weights] = None,
                  device: Device = None, seed: int = 0,
                  **kwargs: Any) -> SqueezeNet:
    weights = SqueezeNet1_0_Weights.verify(weights)
    return build(lambda: SqueezeNet("1_0", **kwargs), init_weights, weights,
                 device, seed)


@register_model()
def squeezenet1_1(*, weights: Optional[SqueezeNet1_1_Weights] = None,
                  device: Device = None, seed: int = 0,
                  **kwargs: Any) -> SqueezeNet:
    weights = SqueezeNet1_1_Weights.verify(weights)
    return build(lambda: SqueezeNet("1_1", **kwargs), init_weights, weights,
                 device, seed)
