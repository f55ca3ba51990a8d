"""DenseNet 121/161/169/201 (counterpart of
``vision_tpu/models/densenet.py``).

NCHW input; torchvision's module and state-dict names
(``features.conv0``, ``features.denseblock{i}.denselayer{j}.{norm1,conv1,
norm2,conv2}``, ``features.transition{i}.{norm,conv}``, ``features.norm5``,
``classifier``). A dense layer's dropout (``drop_rate``, 0 by default)
draws from ``forward(x, generator=g)`` in training mode.
"""

from __future__ import annotations

import math
import re
from collections import OrderedDict
from typing import Any, Dict, Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from vision_tpu_torch.models._api import WeightsEnum, register_model
from vision_tpu_torch.models._utils import (
    Device,
    build,
    cls_weights as _w,
    init_norms,
    normal_,
    uniform_,
)
from vision_tpu_torch.ops.misc import BatchNorm2d, dropout as _dropout

__all__ = [
    "DenseNet",
    "DenseNet121_Weights",
    "DenseNet161_Weights",
    "DenseNet169_Weights",
    "DenseNet201_Weights",
    "densenet121",
    "densenet161",
    "densenet169",
    "densenet201",
]


class _DenseLayer(nn.Module):
    """BN, ReLU, 1x1 conv, BN, ReLU, 3x3 conv: ``growth_rate`` new
    channels."""

    def __init__(self, cin: int, growth_rate: int, bn_size: int,
                 drop_rate: float):
        super().__init__()
        self.drop_rate = drop_rate
        self.norm1 = BatchNorm2d(cin)
        self.conv1 = nn.Conv2d(cin, bn_size * growth_rate, 1, bias=False)
        self.norm2 = BatchNorm2d(bn_size * growth_rate)
        self.conv2 = nn.Conv2d(bn_size * growth_rate, growth_rate, 3,
                               padding=1, bias=False)

    def forward(self, x: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        out = self.conv1(F.relu(self.norm1(x)))
        out = self.conv2(F.relu(self.norm2(out)))
        return _dropout(out, self.drop_rate, self.training, generator)


class _Transition(nn.Sequential):
    def __init__(self, cin: int, cout: int):
        super().__init__(OrderedDict(
            norm=BatchNorm2d(cin), relu=nn.ReLU(),
            conv=nn.Conv2d(cin, cout, 1, bias=False),
            pool=nn.AvgPool2d(2, 2)))


class DenseNet(nn.Module):
    """torchvision's ``DenseNet``. ``forward(x, return_features=True)``
    also returns each dense block's output (``features.denseblock{i}``) and
    the last norm's after its ReLU (``features.norm5``)."""

    def __init__(self, growth_rate: int = 32,
                 block_config: Sequence[int] = (6, 12, 24, 16),
                 num_init_features: int = 64, bn_size: int = 4,
                 drop_rate: float = 0.0, num_classes: int = 1000):
        super().__init__()
        layers: Dict[str, nn.Module] = OrderedDict(
            conv0=nn.Conv2d(3, num_init_features, 7, 2, 3, bias=False),
            norm0=BatchNorm2d(num_init_features), relu0=nn.ReLU(),
            pool0=nn.MaxPool2d(3, 2, 1))
        c = num_init_features
        for i, n in enumerate(block_config, 1):
            layers[f"denseblock{i}"] = nn.ModuleDict(
                (f"denselayer{j + 1}",
                 _DenseLayer(c + j * growth_rate, growth_rate, bn_size,
                             drop_rate)) for j in range(n))
            c += n * growth_rate
            if i != len(block_config):
                layers[f"transition{i}"] = _Transition(c, c // 2)
                c //= 2
        layers["norm5"] = BatchNorm2d(c)
        self.features = nn.Sequential(layers)
        self.classifier = nn.Linear(c, num_classes)

    def forward(self, x: torch.Tensor, return_features: bool = False,
                generator: Optional[torch.Generator] = None):
        features: Dict[str, torch.Tensor] = {}
        for name, layer in self.features.named_children():
            if isinstance(layer, nn.ModuleDict):
                for dense in layer.values():
                    x = torch.cat([x, dense(x, generator)], 1)
                features[f"features.{name}"] = x
            else:
                x = layer(x)
        x = F.relu(x)
        features["features.norm5"] = x
        logits = self.classifier(x.mean((2, 3)))
        if return_features:
            return logits, features
        return logits


@torch.no_grad()
def init_weights(model: nn.Module, generator: torch.Generator) -> None:
    """torchvision's: convs He-normal over the fan in; norms identity; the
    Linear PyTorch's default weight and zero bias."""
    init_norms(model)
    for m in model.modules():
        if isinstance(m, nn.Conv2d):
            normal_(m.weight, math.sqrt(2.0 / m.weight[0].numel()), generator)
        elif isinstance(m, nn.Linear):
            uniform_(m.weight, 1.0 / math.sqrt(m.in_features), generator)
            m.bias.zero_()


def _checkpoint_hook(state: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """Old checkpoints name a dense layer's children ``norm.1``,
    ``conv.2`` ...; torchvision's loader renames them ``norm1``,
    ``conv2``."""
    pat = re.compile(r"^(.*denselayer\d+\.(?:norm|relu|conv))\.((?:[12])\..*)$")
    out = {}
    for k, v in state.items():
        m = pat.match(k)
        out[m.group(1) + m.group(2) if m else k] = v
    return out


class DenseNet121_Weights(WeightsEnum):
    IMAGENET1K_V1 = _w("densenet121-a639ec97.pth", 74.434, 91.972, 7978856,
                       2.834)
    DEFAULT = IMAGENET1K_V1


class DenseNet161_Weights(WeightsEnum):
    IMAGENET1K_V1 = _w("densenet161-8d451a50.pth", 77.138, 93.56, 28681000,
                       7.728)
    DEFAULT = IMAGENET1K_V1


class DenseNet169_Weights(WeightsEnum):
    IMAGENET1K_V1 = _w("densenet169-b2777c0a.pth", 75.6, 92.806, 14149480,
                       3.36)
    DEFAULT = IMAGENET1K_V1


class DenseNet201_Weights(WeightsEnum):
    IMAGENET1K_V1 = _w("densenet201-c1103571.pth", 76.896, 93.37, 20013928,
                       4.291)
    DEFAULT = IMAGENET1K_V1


def _densenet(growth: int, config, init_features: int, weights_enum, weights,
              device: Device, seed: int, **kwargs: Any) -> DenseNet:
    weights = weights_enum.verify(weights)
    return build(lambda: DenseNet(growth, config, init_features, **kwargs),
                 init_weights, weights, device, seed, _checkpoint_hook)


@register_model()
def densenet121(*, weights: Optional[DenseNet121_Weights] = None,
                device: Device = None, seed: int = 0, **kwargs: Any):
    return _densenet(32, (6, 12, 24, 16), 64, DenseNet121_Weights, weights,
                     device, seed, **kwargs)


@register_model()
def densenet161(*, weights: Optional[DenseNet161_Weights] = None,
                device: Device = None, seed: int = 0, **kwargs: Any):
    return _densenet(48, (6, 12, 36, 24), 96, DenseNet161_Weights, weights,
                     device, seed, **kwargs)


@register_model()
def densenet169(*, weights: Optional[DenseNet169_Weights] = None,
                device: Device = None, seed: int = 0, **kwargs: Any):
    return _densenet(32, (6, 12, 32, 32), 64, DenseNet169_Weights, weights,
                     device, seed, **kwargs)


@register_model()
def densenet201(*, weights: Optional[DenseNet201_Weights] = None,
                device: Device = None, seed: int = 0, **kwargs: Any):
    return _densenet(32, (6, 12, 48, 32), 64, DenseNet201_Weights, weights,
                     device, seed, **kwargs)
