"""MNASNet 0.5/0.75/1.0/1.3 (counterpart of
``vision_tpu/models/mnasnet.py``).

NCHW input; torchvision's module and state-dict names (``layers.{i}``,
``layers.{8..13}.{j}.layers.{k}``, ``classifier.1``). Batch norm momentum
0.0003 (torch's convention; flax's 0.9997). The classifier's dropout draws
from ``forward(x, generator=g)`` in training mode.
"""

from __future__ import annotations

import functools
import math
from typing import Any, Dict, List, Optional

import torch
from torch import nn

from vision_tpu_torch.models._api import WeightsEnum, register_model
from vision_tpu_torch.models._utils import (
    Device,
    build,
    cls_weights as _w,
    fan_out_init,
    uniform_,
)
from vision_tpu_torch.ops.misc import BatchNorm2d, dropout as _dropout

__all__ = [
    "MNASNet",
    "MNASNet0_5_Weights",
    "MNASNet0_75_Weights",
    "MNASNet1_0_Weights",
    "MNASNet1_3_Weights",
    "mnasnet0_5",
    "mnasnet0_75",
    "mnasnet1_0",
    "mnasnet1_3",
]

_BN = functools.partial(BatchNorm2d, momentum=0.0003)


def _round_to_multiple_of(val: float, divisor: int,
                          round_up_bias: float = 0.9) -> int:
    new_val = max(divisor, int(val + divisor / 2) // divisor * divisor)
    return new_val if new_val >= round_up_bias * val else new_val + divisor


def _get_depths(alpha: float) -> List[int]:
    return [_round_to_multiple_of(d * alpha, 8)
            for d in (32, 16, 24, 40, 80, 96, 192, 320)]


class _InvertedResidual(nn.Module):
    def __init__(self, in_ch: int, out_ch: int, kernel: int, stride: int,
                 expansion: int):
        super().__init__()
        mid = in_ch * expansion
        self.apply_residual = in_ch == out_ch and stride == 1
        self.layers = nn.Sequential(
            nn.Conv2d(in_ch, mid, 1, bias=False), _BN(mid), nn.ReLU(),
            nn.Conv2d(mid, mid, kernel, stride, kernel // 2, groups=mid,
                      bias=False), _BN(mid), nn.ReLU(),
            nn.Conv2d(mid, out_ch, 1, bias=False), _BN(out_ch))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.layers(x) + x if self.apply_residual else self.layers(x)


def _stack(in_ch, out_ch, kernel, stride, expansion, repeats) -> nn.Sequential:
    return nn.Sequential(
        _InvertedResidual(in_ch, out_ch, kernel, stride, expansion),
        *(_InvertedResidual(out_ch, out_ch, kernel, 1, expansion)
          for _ in range(1, repeats)))


class MNASNet(nn.Module):
    """torchvision's ``MNASNet``. ``forward(x, return_features=True)`` also
    returns each stack's output (``layers.8`` .. ``layers.13``) and the
    last convolution's after its ReLU (``layers.15``)."""

    def __init__(self, alpha: float, num_classes: int = 1000,
                 dropout: float = 0.2):
        super().__init__()
        self.dropout = dropout
        d = _get_depths(alpha)
        self.layers = nn.Sequential(
            nn.Conv2d(3, d[0], 3, 2, 1, bias=False), _BN(d[0]), nn.ReLU(),
            nn.Conv2d(d[0], d[0], 3, 1, 1, groups=d[0], bias=False), _BN(d[0]),
            nn.ReLU(),
            nn.Conv2d(d[0], d[1], 1, bias=False), _BN(d[1]),
            _stack(d[1], d[2], 3, 2, 3, 3), _stack(d[2], d[3], 5, 2, 3, 3),
            _stack(d[3], d[4], 5, 2, 6, 3), _stack(d[4], d[5], 3, 1, 6, 2),
            _stack(d[5], d[6], 5, 2, 6, 4), _stack(d[6], d[7], 3, 1, 6, 1),
            nn.Conv2d(d[7], 1280, 1, bias=False), _BN(1280), nn.ReLU())
        self.classifier = nn.Sequential(nn.Dropout(dropout),
                                        nn.Linear(1280, num_classes))

    def forward(self, x: torch.Tensor, return_features: bool = False,
                generator: Optional[torch.Generator] = None):
        features: Dict[str, torch.Tensor] = {}
        for i, layer in enumerate(self.layers):
            x = layer(x)
            if 8 <= i <= 13:
                features[f"layers.{i}"] = x
        features["layers.15"] = x
        x = _dropout(x.mean((2, 3)), self.dropout, self.training, generator)
        logits = self.classifier[1](x)
        if return_features:
            return logits, features
        return logits


@torch.no_grad()
def init_weights(model: nn.Module, generator: torch.Generator) -> None:
    """torchvision's: convs He-normal over the fan out; the Linear
    ``kaiming_uniform_(mode="fan_out", nonlinearity="sigmoid")`` (bound
    sqrt(3 / out features)), zero bias; norms identity."""
    def linear(m: nn.Linear, g: torch.Generator) -> None:
        uniform_(m.weight, math.sqrt(3.0 / m.out_features), g)
        m.bias.zero_()

    fan_out_init(model, generator, linear)


class MNASNet0_5_Weights(WeightsEnum):
    IMAGENET1K_V1 = _w("mnasnet0.5_top1_67.823-3ffadce67e.pth", 67.734, 87.49,
                       2218512, 0.104)
    DEFAULT = IMAGENET1K_V1


class MNASNet0_75_Weights(WeightsEnum):
    IMAGENET1K_V1 = _w("mnasnet0_75-7090bc5f.pth", 71.18, 90.496, 3170208,
                       0.215, resize=232)
    DEFAULT = IMAGENET1K_V1


class MNASNet1_0_Weights(WeightsEnum):
    IMAGENET1K_V1 = _w("mnasnet1.0_top1_73.512-f206786ef8.pth", 73.456, 91.51,
                       4383312, 0.314)
    DEFAULT = IMAGENET1K_V1


class MNASNet1_3_Weights(WeightsEnum):
    IMAGENET1K_V1 = _w("mnasnet1_3-a4c69d6f.pth", 76.506, 93.522, 6282256,
                       0.526, resize=232)
    DEFAULT = IMAGENET1K_V1


def _mnasnet(alpha: float, weights_enum, weights, device: Device, seed: int,
             **kwargs: Any) -> MNASNet:
    weights = weights_enum.verify(weights)
    return build(lambda: MNASNet(alpha, **kwargs), init_weights, weights,
                 device, seed)


@register_model()
def mnasnet0_5(*, weights: Optional[MNASNet0_5_Weights] = None,
               device: Device = None, seed: int = 0, **kwargs: Any) -> MNASNet:
    return _mnasnet(0.5, MNASNet0_5_Weights, weights, device, seed, **kwargs)


@register_model()
def mnasnet0_75(*, weights: Optional[MNASNet0_75_Weights] = None,
                device: Device = None, seed: int = 0, **kwargs: Any) -> MNASNet:
    return _mnasnet(0.75, MNASNet0_75_Weights, weights, device, seed, **kwargs)


@register_model()
def mnasnet1_0(*, weights: Optional[MNASNet1_0_Weights] = None,
               device: Device = None, seed: int = 0, **kwargs: Any) -> MNASNet:
    return _mnasnet(1.0, MNASNet1_0_Weights, weights, device, seed, **kwargs)


@register_model()
def mnasnet1_3(*, weights: Optional[MNASNet1_3_Weights] = None,
               device: Device = None, seed: int = 0, **kwargs: Any) -> MNASNet:
    return _mnasnet(1.3, MNASNet1_3_Weights, weights, device, seed, **kwargs)
