"""MobileNetV3 large and small (counterpart of
``vision_tpu/models/mobilenetv3.py``).

NCHW input; torchvision's module and state-dict names
(``features.{i}.block.{j}``, ``classifier.{0,3}``). Hardswish or ReLU
blocks, the squeeze-excitation with a hardsigmoid scale. Batch norm as the
JAX reference configures it (eps 1e-5, torch momentum 0.1), not
torchvision's (1e-3, 0.01). The classifier's dropout draws from
``forward(x, generator=g)`` in training mode.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Any, Dict, List, Optional, Sequence, Tuple

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
    Conv2dNormActivation,
    SqueezeExcitation,
    dropout as _dropout,
)

__all__ = [
    "MobileNetV3",
    "MobileNet_V3_Large_Weights",
    "MobileNet_V3_Small_Weights",
    "mobilenet_v3_large",
    "mobilenet_v3_small",
]


@dataclasses.dataclass(frozen=True)
class IRConf:
    """One block: input channels, kernel, expanded and output channels,
    squeeze-excitation, hardswish (else ReLU), stride, dilation."""

    input_channels: int
    kernel: int
    expanded_channels: int
    out_channels: int
    use_se: bool
    use_hs: bool
    stride: int
    dilation: int

    @staticmethod
    def adjust(ch: float, width_mult: float) -> int:
        return _make_divisible(ch * width_mult, 8)


def _conf(i, k, e, o, se, act, s, d, width_mult=1.0) -> IRConf:
    a = functools.partial(IRConf.adjust, width_mult=width_mult)
    return IRConf(a(i), k, a(e), a(o), se, act == "HS", s, d)


def _cna(cin: int, cout: int, kernel: int = 3, stride: int = 1,
         groups: int = 1, act=nn.Hardswish,
         dilation: int = 1) -> Conv2dNormActivation:
    return Conv2dNormActivation(cin, cout, kernel, stride, groups=groups,
                                activation_layer=act, dilation=dilation,
                                inplace=None)


class InvertedResidual(nn.Module):
    def __init__(self, cnf: IRConf):
        super().__init__()
        self.use_res = cnf.stride == 1 and cnf.input_channels == cnf.out_channels
        act = nn.Hardswish if cnf.use_hs else nn.ReLU
        e = cnf.expanded_channels
        layers: List[nn.Module] = []
        if e != cnf.input_channels:
            layers.append(_cna(cnf.input_channels, e, 1, act=act))
        layers.append(_cna(e, e, cnf.kernel,
                           1 if cnf.dilation > 1 else cnf.stride, groups=e,
                           act=act, dilation=cnf.dilation))
        if cnf.use_se:
            layers.append(SqueezeExcitation(e, _make_divisible(e // 4, 8),
                                            scale_activation=nn.Hardsigmoid))
        layers.append(_cna(e, cnf.out_channels, 1, act=None))
        self.block = nn.Sequential(*layers)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x + self.block(x) if self.use_res else self.block(x)


class MobileNetV3(nn.Module):
    """torchvision's ``MobileNetV3``. ``forward(x, return_features=True)``
    also returns each block's and the last convolution's output under
    ``features.{i}``."""

    def __init__(self, setting: Sequence[IRConf], last_channel: int,
                 num_classes: int = 1000, dropout: float = 0.2):
        super().__init__()
        self.dropout = dropout
        layers: List[nn.Module] = [_cna(3, setting[0].input_channels, 3, 2)]
        layers += [InvertedResidual(c) for c in setting]
        lastconv = 6 * setting[-1].out_channels
        layers.append(_cna(setting[-1].out_channels, lastconv, 1))
        self.features = nn.Sequential(*layers)
        self.classifier = nn.Sequential(
            nn.Linear(lastconv, last_channel), nn.Hardswish(),
            nn.Dropout(dropout), nn.Linear(last_channel, num_classes))

    def forward(self, x: torch.Tensor, return_features: bool = False,
                generator: Optional[torch.Generator] = None):
        features: Dict[str, torch.Tensor] = {}
        for i, layer in enumerate(self.features):
            x = layer(x)
            if i:
                features[f"features.{i}"] = x
        fc1, act, _, fc2 = self.classifier
        x = act(fc1(x.mean((2, 3))))
        logits = fc2(_dropout(x, self.dropout, self.training, generator))
        if return_features:
            return logits, features
        return logits


@torch.no_grad()
def init_weights(model: nn.Module, generator: torch.Generator) -> None:
    """torchvision's: convs He-normal over the fan out, zero bias; Linears
    normal of std 0.01, zero bias; norms identity."""
    fan_out_init(model, generator, normal_linear(0.01))


def _large_setting(width_mult=1.0, reduced_tail=False, dilated=False
                   ) -> Tuple[List[IRConf], int]:
    rd = 2 if reduced_tail else 1
    d = 2 if dilated else 1
    c = functools.partial(_conf, width_mult=width_mult)
    setting = [
        c(16, 3, 16, 16, False, "RE", 1, 1),
        c(16, 3, 64, 24, False, "RE", 2, 1),
        c(24, 3, 72, 24, False, "RE", 1, 1),
        c(24, 5, 72, 40, True, "RE", 2, 1),
        c(40, 5, 120, 40, True, "RE", 1, 1),
        c(40, 5, 120, 40, True, "RE", 1, 1),
        c(40, 3, 240, 80, False, "HS", 2, 1),
        c(80, 3, 200, 80, False, "HS", 1, 1),
        c(80, 3, 184, 80, False, "HS", 1, 1),
        c(80, 3, 184, 80, False, "HS", 1, 1),
        c(80, 3, 480, 112, True, "HS", 1, 1),
        c(112, 3, 672, 112, True, "HS", 1, 1),
        c(112, 5, 672, 160 // rd, True, "HS", 2, d),
        c(160 // rd, 5, 960 // rd, 160 // rd, True, "HS", 1, d),
        c(160 // rd, 5, 960 // rd, 160 // rd, True, "HS", 1, d),
    ]
    return setting, IRConf.adjust(1280 // rd, width_mult)


def _small_setting(width_mult=1.0, reduced_tail=False, dilated=False
                   ) -> Tuple[List[IRConf], int]:
    rd = 2 if reduced_tail else 1
    d = 2 if dilated else 1
    c = functools.partial(_conf, width_mult=width_mult)
    setting = [
        c(16, 3, 16, 16, True, "RE", 2, 1),
        c(16, 3, 72, 24, False, "RE", 2, 1),
        c(24, 3, 88, 24, False, "RE", 1, 1),
        c(24, 5, 96, 40, True, "HS", 2, 1),
        c(40, 5, 240, 40, True, "HS", 1, 1),
        c(40, 5, 240, 40, True, "HS", 1, 1),
        c(40, 5, 120, 48, True, "HS", 1, 1),
        c(48, 5, 144, 48, True, "HS", 1, 1),
        c(48, 5, 288, 96 // rd, True, "HS", 2, d),
        c(96 // rd, 5, 576 // rd, 96 // rd, True, "HS", 1, d),
        c(96 // rd, 5, 576 // rd, 96 // rd, True, "HS", 1, d),
    ]
    return setting, IRConf.adjust(1024 // rd, width_mult)


class MobileNet_V3_Large_Weights(WeightsEnum):
    IMAGENET1K_V1 = _w("mobilenet_v3_large-8738ca79.pth", 74.042, 91.34,
                       5483032, 0.217)
    IMAGENET1K_V2 = _w("mobilenet_v3_large-5c1a4163.pth", 75.274, 92.566,
                       5483032, 0.217, resize=232)
    DEFAULT = IMAGENET1K_V2


class MobileNet_V3_Small_Weights(WeightsEnum):
    IMAGENET1K_V1 = _w("mobilenet_v3_small-047dcff4.pth", 67.668, 87.402,
                       2542856, 0.057)
    DEFAULT = IMAGENET1K_V1


@register_model()
def mobilenet_v3_large(*, weights: Optional[MobileNet_V3_Large_Weights] = None,
                       device: Device = None, seed: int = 0,
                       **kwargs: Any) -> MobileNetV3:
    weights = MobileNet_V3_Large_Weights.verify(weights)
    setting, last = _large_setting()
    return build(lambda: MobileNetV3(setting, last, **kwargs), init_weights,
                 weights, device, seed)


@register_model()
def mobilenet_v3_small(*, weights: Optional[MobileNet_V3_Small_Weights] = None,
                       device: Device = None, seed: int = 0,
                       **kwargs: Any) -> MobileNetV3:
    weights = MobileNet_V3_Small_Weights.verify(weights)
    setting, last = _small_setting()
    return build(lambda: MobileNetV3(setting, last, **kwargs), init_weights,
                 weights, device, seed)
