"""ShuffleNetV2 x0.5/1.0/1.5/2.0 (counterpart of
``vision_tpu/models/shufflenetv2.py``).

NCHW input; torchvision's module and state-dict names (``conv1.{0,1}``,
``stage{2,3,4}.{j}.branch{1,2}.{k}``, ``conv5.{0,1}``, ``fc``).
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from vision_tpu_torch.models._api import WeightsEnum, register_model
from vision_tpu_torch.models._utils import (
    Device,
    build,
    cls_weights as _w,
    default_,
    init_norms,
)
from vision_tpu_torch.ops.misc import BatchNorm2d

__all__ = [
    "ShuffleNetV2",
    "ShuffleNet_V2_X0_5_Weights",
    "ShuffleNet_V2_X1_0_Weights",
    "ShuffleNet_V2_X1_5_Weights",
    "ShuffleNet_V2_X2_0_Weights",
    "shufflenet_v2_x0_5",
    "shufflenet_v2_x1_0",
    "shufflenet_v2_x1_5",
    "shufflenet_v2_x2_0",
]


def channel_shuffle(x: torch.Tensor, groups: int) -> torch.Tensor:
    b, c, h, w = x.shape
    x = x.view(b, groups, c // groups, h, w).transpose(1, 2)
    return x.reshape(b, c, h, w)


def _dw(c: int, stride: int) -> nn.Conv2d:
    return nn.Conv2d(c, c, 3, stride, 1, groups=c, bias=False)


class InvertedResidual(nn.Module):
    def __init__(self, inp: int, oup: int, stride: int):
        super().__init__()
        self.stride = stride
        bf = oup // 2
        if stride > 1:
            self.branch1 = nn.Sequential(
                _dw(inp, stride), BatchNorm2d(inp),
                nn.Conv2d(inp, bf, 1, bias=False), BatchNorm2d(bf), nn.ReLU())
        else:
            self.branch1 = nn.Sequential()
        self.branch2 = nn.Sequential(
            nn.Conv2d(inp if stride > 1 else bf, bf, 1, bias=False),
            BatchNorm2d(bf), nn.ReLU(), _dw(bf, stride), BatchNorm2d(bf),
            nn.Conv2d(bf, bf, 1, bias=False), BatchNorm2d(bf), nn.ReLU())

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.stride == 1:
            x1, x2 = x.chunk(2, dim=1)
            out = torch.cat([x1, self.branch2(x2)], dim=1)
        else:
            out = torch.cat([self.branch1(x), self.branch2(x)], dim=1)
        return channel_shuffle(out, 2)


class ShuffleNetV2(nn.Module):
    """torchvision's ``ShuffleNetV2``. ``forward(x, return_features=True)``
    also returns each stage's output (``stage{2,3,4}``) and ``conv5``'s."""

    def __init__(self, stages_repeats: Sequence[int],
                 stages_out_channels: Sequence[int], num_classes: int = 1000):
        super().__init__()
        out_c = stages_out_channels
        self.conv1 = nn.Sequential(nn.Conv2d(3, out_c[0], 3, 2, 1, bias=False),
                                   BatchNorm2d(out_c[0]), nn.ReLU())
        cin = out_c[0]
        for i, (repeats, cout) in enumerate(zip(stages_repeats, out_c[1:]), 2):
            setattr(self, f"stage{i}", nn.Sequential(
                InvertedResidual(cin, cout, 2),
                *(InvertedResidual(cout, cout, 1) for _ in range(repeats - 1))))
            cin = cout
        self.conv5 = nn.Sequential(nn.Conv2d(cin, out_c[-1], 1, bias=False),
                                   BatchNorm2d(out_c[-1]), nn.ReLU())
        self.fc = nn.Linear(out_c[-1], num_classes)

    def forward(self, x: torch.Tensor, return_features: bool = False,
                generator: Optional[torch.Generator] = None):
        x = F.max_pool2d(self.conv1(x), 3, 2, 1)
        features: Dict[str, torch.Tensor] = {}
        for name in ("stage2", "stage3", "stage4", "conv5"):
            x = getattr(self, name)(x)
            features[name] = x
        logits = self.fc(x.mean((2, 3)))
        if return_features:
            return logits, features
        return logits


@torch.no_grad()
def init_weights(model: nn.Module, generator: torch.Generator) -> None:
    """PyTorch's default initialisation (torchvision sets none of its own):
    convs and the Linear uniform in +-1/sqrt(fan in); norms identity."""
    init_norms(model)
    for m in model.modules():
        if isinstance(m, (nn.Conv2d, nn.Linear)):
            default_(m, generator)


class ShuffleNet_V2_X0_5_Weights(WeightsEnum):
    IMAGENET1K_V1 = _w("shufflenetv2_x0.5-f707e7126e.pth", 60.552, 81.746,
                       1366792, 0.04)
    DEFAULT = IMAGENET1K_V1


class ShuffleNet_V2_X1_0_Weights(WeightsEnum):
    IMAGENET1K_V1 = _w("shufflenetv2_x1-5666bf0f80.pth", 69.362, 88.316,
                       2278604, 0.145)
    DEFAULT = IMAGENET1K_V1


class ShuffleNet_V2_X1_5_Weights(WeightsEnum):
    IMAGENET1K_V1 = _w("shufflenetv2_x1_5-3c479a10.pth", 72.996, 91.086,
                       3503624, 0.296)
    DEFAULT = IMAGENET1K_V1


class ShuffleNet_V2_X2_0_Weights(WeightsEnum):
    IMAGENET1K_V1 = _w("shufflenetv2_x2_0-8be3c8ee.pth", 76.23, 93.006,
                       7393996, 0.583)
    DEFAULT = IMAGENET1K_V1


def _shufflenet(repeats, channels, weights_enum, weights, device: Device,
                seed: int, **kwargs: Any) -> ShuffleNetV2:
    weights = weights_enum.verify(weights)
    return build(lambda: ShuffleNetV2(repeats, channels, **kwargs),
                 init_weights, weights, device, seed)


@register_model()
def shufflenet_v2_x0_5(*, weights: Optional[ShuffleNet_V2_X0_5_Weights] = None,
                       device: Device = None, seed: int = 0, **kwargs: Any):
    return _shufflenet([4, 8, 4], [24, 48, 96, 192, 1024],
                       ShuffleNet_V2_X0_5_Weights, weights, device, seed,
                       **kwargs)


@register_model()
def shufflenet_v2_x1_0(*, weights: Optional[ShuffleNet_V2_X1_0_Weights] = None,
                       device: Device = None, seed: int = 0, **kwargs: Any):
    return _shufflenet([4, 8, 4], [24, 116, 232, 464, 1024],
                       ShuffleNet_V2_X1_0_Weights, weights, device, seed,
                       **kwargs)


@register_model()
def shufflenet_v2_x1_5(*, weights: Optional[ShuffleNet_V2_X1_5_Weights] = None,
                       device: Device = None, seed: int = 0, **kwargs: Any):
    return _shufflenet([4, 8, 4], [24, 176, 352, 704, 1024],
                       ShuffleNet_V2_X1_5_Weights, weights, device, seed,
                       **kwargs)


@register_model()
def shufflenet_v2_x2_0(*, weights: Optional[ShuffleNet_V2_X2_0_Weights] = None,
                       device: Device = None, seed: int = 0, **kwargs: Any):
    return _shufflenet([4, 8, 4], [24, 244, 488, 976, 2048],
                       ShuffleNet_V2_X2_0_Weights, weights, device, seed,
                       **kwargs)
