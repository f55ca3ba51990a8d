"""RegNet X and Y (counterpart of ``vision_tpu/models/regnet.py``):
regnet_x/y 400mf .. 32gf and regnet_y_128gf.

NCHW input; torchvision's module and state-dict names (``stem.{0,1}``,
``trunk_output.block{i}.block{i}-{j}.f.{a,b,se,c}``, ``.proj``, ``fc``).
Each block is the grouped bottleneck (1x1, grouped 3x3, the Y models'
squeeze-excitation, 1x1) beside a projection where the shape changes.
"""

from __future__ import annotations

import math
from collections import OrderedDict
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
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
from vision_tpu_torch.ops.misc import Conv2dNormActivation, SqueezeExcitation

__all__ = [
    "RegNet",
    "regnet_y_400mf", "regnet_y_800mf", "regnet_y_1_6gf", "regnet_y_3_2gf",
    "regnet_y_8gf", "regnet_y_16gf", "regnet_y_32gf", "regnet_y_128gf",
    "regnet_x_400mf", "regnet_x_800mf", "regnet_x_1_6gf", "regnet_x_3_2gf",
    "regnet_x_8gf", "regnet_x_16gf", "regnet_x_32gf",
    "RegNet_Y_400MF_Weights", "RegNet_Y_800MF_Weights",
    "RegNet_Y_1_6GF_Weights", "RegNet_Y_3_2GF_Weights", "RegNet_Y_8GF_Weights",
    "RegNet_Y_16GF_Weights", "RegNet_Y_32GF_Weights", "RegNet_Y_128GF_Weights",
    "RegNet_X_400MF_Weights", "RegNet_X_800MF_Weights",
    "RegNet_X_1_6GF_Weights", "RegNet_X_3_2GF_Weights", "RegNet_X_8GF_Weights",
    "RegNet_X_16GF_Weights", "RegNet_X_32GF_Weights",
]

# a stage: width, stride, depth, group width, bottleneck multiplier
StageParams = Tuple[int, int, int, int, float]


def block_params(depth: int, w_0: float, w_a: float, w_m: float,
                 group_width: int, se_ratio: Optional[float] = None,
                 bottleneck_multiplier: float = 1.0
                 ) -> Tuple[List[StageParams], Optional[float]]:
    """The stages of a RegNet design space point (torchvision's
    ``BlockParams.from_init_params``)."""
    widths_cont = np.arange(depth) * w_a + w_0
    block_capacity = np.round(np.log(widths_cont / w_0) / math.log(w_m))
    block_widths = (np.round(np.divide(w_0 * np.power(w_m, block_capacity), 8))
                    * 8).astype(int).tolist()
    num_stages = len(set(block_widths))
    splits = [w != wp or r != rp for w, wp, r, rp in zip(
        block_widths + [0], [0] + block_widths, block_widths + [0],
        [0] + block_widths)]
    stage_widths = [w for w, t in zip(block_widths, splits[:-1]) if t]
    stage_depths = np.diff([d for d, t in enumerate(splits) if t]).astype(
        int).tolist()
    bms = [bottleneck_multiplier] * num_stages
    widths = [int(w * b) for w, b in zip(stage_widths, bms)]
    gws = [min(group_width, w_bot) for w_bot in widths]
    ws_bot = [_make_divisible(w_bot, g) for w_bot, g in zip(widths, gws)]
    stage_widths = [int(w_bot / b) for w_bot, b in zip(ws_bot, bms)]
    return (list(zip(stage_widths, [2] * num_stages, stage_depths, gws, bms)),
            se_ratio)


def _cna(cin: int, cout: int, kernel: int, stride: int = 1, groups: int = 1,
         act: bool = True) -> Conv2dNormActivation:
    return Conv2dNormActivation(cin, cout, kernel, stride, groups=groups,
                                activation_layer=nn.ReLU if act else None,
                                inplace=None)


class ResBottleneckBlock(nn.Module):
    def __init__(self, width_in: int, width_out: int, stride: int,
                 group_width: int, bottleneck_multiplier: float,
                 se_ratio: Optional[float]):
        super().__init__()
        w_b = int(round(width_out * bottleneck_multiplier))
        layers: Dict[str, nn.Module] = OrderedDict(
            a=_cna(width_in, w_b, 1),
            b=_cna(w_b, w_b, 3, stride, groups=w_b // group_width))
        if se_ratio:
            layers["se"] = SqueezeExcitation(w_b, int(round(se_ratio * width_in)))
        layers["c"] = _cna(w_b, width_out, 1, act=False)
        self.f = nn.Sequential(layers)
        self.proj = (_cna(width_in, width_out, 1, stride, act=False)
                     if width_in != width_out or stride != 1 else None)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        identity = x if self.proj is None else self.proj(x)
        return F.relu(identity + self.f(x))


class RegNet(nn.Module):
    """torchvision's ``RegNet``. ``forward(x, return_features=True)`` also
    returns the stem's output (``stem``) and each stage's
    (``trunk_output.block{i}``)."""

    def __init__(self, stage_params: Sequence[StageParams],
                 se_ratio: Optional[float], stem_width: int = 32,
                 num_classes: int = 1000):
        super().__init__()
        self.stem = _cna(3, stem_width, 3, 2)
        stages: Dict[str, nn.Module] = OrderedDict()
        current = stem_width
        for i, (width, stride, depth, gw, bm) in enumerate(stage_params, 1):
            stages[f"block{i}"] = nn.Sequential(OrderedDict(
                (f"block{i}-{j}", ResBottleneckBlock(
                    current if j == 0 else width, width, stride if j == 0 else 1,
                    gw, bm, se_ratio)) for j in range(depth)))
            current = width
        self.trunk_output = nn.Sequential(stages)
        self.fc = nn.Linear(current, num_classes)

    def forward(self, x: torch.Tensor, return_features: bool = False,
                generator: Optional[torch.Generator] = None):
        x = self.stem(x)
        features: Dict[str, torch.Tensor] = {"stem": x}
        for name, stage in self.trunk_output.named_children():
            x = stage(x)
            features[f"trunk_output.{name}"] = x
        logits = self.fc(x.mean((2, 3)))
        if return_features:
            return logits, features
        return logits


@torch.no_grad()
def init_weights(model: nn.Module, generator: torch.Generator) -> None:
    """torchvision's: convs normal of std sqrt(2 / fan out), norms
    identity, the Linear normal of std 0.01 with zero bias."""
    fan_out_init(model, generator, normal_linear(0.01))


class RegNet_Y_400MF_Weights(WeightsEnum):
    IMAGENET1K_V1 = _w("regnet_y_400mf-c65dace8.pth", 74.046, 91.716, 4344144,
                       0.402)
    IMAGENET1K_V2 = _w("regnet_y_400mf-e6988f5f.pth", 75.804, 92.742, 4344144,
                       0.402, resize=232)
    DEFAULT = IMAGENET1K_V2


class RegNet_Y_800MF_Weights(WeightsEnum):
    IMAGENET1K_V1 = _w("regnet_y_800mf-1b27b58c.pth", 76.42, 93.136, 6432512,
                       0.834)
    IMAGENET1K_V2 = _w("regnet_y_800mf-58fc7688.pth", 78.828, 94.502, 6432512,
                       0.834, resize=232)
    DEFAULT = IMAGENET1K_V2


class RegNet_Y_1_6GF_Weights(WeightsEnum):
    IMAGENET1K_V1 = _w("regnet_y_1_6gf-b11a554e.pth", 77.95, 93.966, 11202430,
                       1.612)
    IMAGENET1K_V2 = _w("regnet_y_1_6gf-0d7bc02a.pth", 80.876, 95.444, 11202430,
                       1.612, resize=232)
    DEFAULT = IMAGENET1K_V2


class RegNet_Y_3_2GF_Weights(WeightsEnum):
    IMAGENET1K_V1 = _w("regnet_y_3_2gf-b5a9779c.pth", 78.948, 94.576, 19436338,
                       3.176)
    IMAGENET1K_V2 = _w("regnet_y_3_2gf-9180c971.pth", 81.982, 95.972, 19436338,
                       3.176, resize=232)
    DEFAULT = IMAGENET1K_V2


class RegNet_Y_8GF_Weights(WeightsEnum):
    IMAGENET1K_V1 = _w("regnet_y_8gf-d0d0e4a8.pth", 80.032, 95.048, 39381472,
                       8.473)
    IMAGENET1K_V2 = _w("regnet_y_8gf-dc2b1b54.pth", 82.828, 96.33, 39381472,
                       8.473, resize=232)
    DEFAULT = IMAGENET1K_V2


class RegNet_Y_16GF_Weights(WeightsEnum):
    IMAGENET1K_V1 = _w("regnet_y_16gf-9e6ed7dd.pth", 80.424, 95.24, 83590140,
                       15.912)
    IMAGENET1K_V2 = _w("regnet_y_16gf-3e4a00f9.pth", 82.886, 96.328, 83590140,
                       15.912, resize=232)
    IMAGENET1K_SWAG_E2E_V1 = _w("regnet_y_16gf_swag-43afe44d.pth", 86.012,
                                98.054, 83590140, 46.735, crop=384, resize=384,
                                interp="bicubic")
    IMAGENET1K_SWAG_LINEAR_V1 = _w("regnet_y_16gf_lc_swag-f3ec0043.pth",
                                   83.976, 97.244, 83590140, 15.912,
                                   resize=224, interp="bicubic")
    DEFAULT = IMAGENET1K_V2


class RegNet_Y_32GF_Weights(WeightsEnum):
    IMAGENET1K_V1 = _w("regnet_y_32gf-4dee3f7a.pth", 80.878, 95.34, 145046770,
                       32.28)
    IMAGENET1K_V2 = _w("regnet_y_32gf-8db6d4b5.pth", 83.368, 96.498, 145046770,
                       32.28, resize=232)
    IMAGENET1K_SWAG_E2E_V1 = _w("regnet_y_32gf_swag-04fdfa75.pth", 86.838,
                                98.362, 145046770, 94.826, crop=384,
                                resize=384, interp="bicubic")
    IMAGENET1K_SWAG_LINEAR_V1 = _w("regnet_y_32gf_lc_swag-e1583746.pth",
                                   84.622, 97.48, 145046770, 32.28, resize=224,
                                   interp="bicubic")
    DEFAULT = IMAGENET1K_V2


class RegNet_Y_128GF_Weights(WeightsEnum):
    IMAGENET1K_SWAG_E2E_V1 = _w("regnet_y_128gf_swag-c8ce3e52.pth", 88.228,
                                98.682, 644812894, 374.57, crop=384,
                                resize=384, interp="bicubic")
    IMAGENET1K_SWAG_LINEAR_V1 = _w("regnet_y_128gf_lc_swag-cbe8ce12.pth",
                                   86.068, 97.844, 644812894, 127.518,
                                   resize=224, interp="bicubic")
    DEFAULT = IMAGENET1K_SWAG_E2E_V1


class RegNet_X_400MF_Weights(WeightsEnum):
    IMAGENET1K_V1 = _w("regnet_x_400mf-adf1edd5.pth", 72.834, 90.95, 5495976,
                       0.414)
    IMAGENET1K_V2 = _w("regnet_x_400mf-62229a5f.pth", 74.864, 92.322, 5495976,
                       0.414, resize=232)
    DEFAULT = IMAGENET1K_V2


class RegNet_X_800MF_Weights(WeightsEnum):
    IMAGENET1K_V1 = _w("regnet_x_800mf-ad17e45c.pth", 75.212, 92.348, 7259656,
                       0.8)
    IMAGENET1K_V2 = _w("regnet_x_800mf-94a99ebd.pth", 77.522, 93.826, 7259656,
                       0.8, resize=232)
    DEFAULT = IMAGENET1K_V2


class RegNet_X_1_6GF_Weights(WeightsEnum):
    IMAGENET1K_V1 = _w("regnet_x_1_6gf-e3633e7f.pth", 77.04, 93.44, 9190136,
                       1.603)
    IMAGENET1K_V2 = _w("regnet_x_1_6gf-a12f2b72.pth", 79.668, 94.922, 9190136,
                       1.603, resize=232)
    DEFAULT = IMAGENET1K_V2


class RegNet_X_3_2GF_Weights(WeightsEnum):
    IMAGENET1K_V1 = _w("regnet_x_3_2gf-f342aeae.pth", 78.364, 93.992, 15296552,
                       3.177)
    IMAGENET1K_V2 = _w("regnet_x_3_2gf-7071aa85.pth", 81.196, 95.43, 15296552,
                       3.177, resize=232)
    DEFAULT = IMAGENET1K_V2


class RegNet_X_8GF_Weights(WeightsEnum):
    IMAGENET1K_V1 = _w("regnet_x_8gf-03ceed89.pth", 79.344, 94.686, 39572648,
                       7.995)
    IMAGENET1K_V2 = _w("regnet_x_8gf-2b70d774.pth", 81.682, 95.678, 39572648,
                       7.995, resize=232)
    DEFAULT = IMAGENET1K_V2


class RegNet_X_16GF_Weights(WeightsEnum):
    IMAGENET1K_V1 = _w("regnet_x_16gf-2007eb11.pth", 80.058, 94.944, 54278536,
                       15.941)
    IMAGENET1K_V2 = _w("regnet_x_16gf-ba3796d7.pth", 82.716, 96.196, 54278536,
                       15.941, resize=232)
    DEFAULT = IMAGENET1K_V2


class RegNet_X_32GF_Weights(WeightsEnum):
    IMAGENET1K_V1 = _w("regnet_x_32gf-9d47f8d0.pth", 80.622, 95.248, 107811560,
                       31.736)
    IMAGENET1K_V2 = _w("regnet_x_32gf-6eb8fdc6.pth", 83.014, 96.288, 107811560,
                       31.736, resize=232)
    DEFAULT = IMAGENET1K_V2


def _regnet(params, weights_enum, weights, device: Device, seed: int,
            **kwargs: Any) -> RegNet:
    weights = weights_enum.verify(weights)
    stage_params, se_ratio = params
    return build(lambda: RegNet(stage_params, se_ratio, **kwargs),
                 init_weights, weights, device, seed)


def _builder(name: str, weights_enum, *params):
    def builder(*, weights=None, device: Device = None, seed: int = 0,
                **kwargs: Any) -> RegNet:
        return _regnet(block_params(*params), weights_enum, weights, device,
                       seed, **kwargs)

    builder.__name__ = builder.__qualname__ = name
    builder.__annotations__["weights"] = f"Optional[{weights_enum.__name__}]"
    builder.__doc__ = f"``{name}``: ``block_params{params}``."
    return register_model(name)(builder)


regnet_y_400mf = _builder("regnet_y_400mf", RegNet_Y_400MF_Weights,
                          16, 48, 27.89, 2.09, 8, 0.25)
regnet_y_800mf = _builder("regnet_y_800mf", RegNet_Y_800MF_Weights,
                          14, 56, 38.84, 2.4, 16, 0.25)
regnet_y_1_6gf = _builder("regnet_y_1_6gf", RegNet_Y_1_6GF_Weights,
                          27, 48, 20.71, 2.65, 24, 0.25)
regnet_y_3_2gf = _builder("regnet_y_3_2gf", RegNet_Y_3_2GF_Weights,
                          21, 80, 42.63, 2.66, 24, 0.25)
regnet_y_8gf = _builder("regnet_y_8gf", RegNet_Y_8GF_Weights,
                        17, 192, 76.82, 2.19, 56, 0.25)
regnet_y_16gf = _builder("regnet_y_16gf", RegNet_Y_16GF_Weights,
                         18, 200, 106.23, 2.48, 112, 0.25)
regnet_y_32gf = _builder("regnet_y_32gf", RegNet_Y_32GF_Weights,
                         20, 232, 115.89, 2.53, 232, 0.25)
regnet_y_128gf = _builder("regnet_y_128gf", RegNet_Y_128GF_Weights,
                          27, 456, 160.83, 2.52, 264, 0.25)
regnet_x_400mf = _builder("regnet_x_400mf", RegNet_X_400MF_Weights,
                          22, 24, 24.48, 2.54, 16)
regnet_x_800mf = _builder("regnet_x_800mf", RegNet_X_800MF_Weights,
                          16, 56, 35.73, 2.28, 16)
regnet_x_1_6gf = _builder("regnet_x_1_6gf", RegNet_X_1_6GF_Weights,
                          18, 80, 34.01, 2.25, 24)
regnet_x_3_2gf = _builder("regnet_x_3_2gf", RegNet_X_3_2GF_Weights,
                          25, 88, 26.31, 2.25, 48)
regnet_x_8gf = _builder("regnet_x_8gf", RegNet_X_8GF_Weights,
                        23, 80, 49.56, 2.88, 120)
regnet_x_16gf = _builder("regnet_x_16gf", RegNet_X_16GF_Weights,
                         22, 216, 55.59, 2.1, 128)
regnet_x_32gf = _builder("regnet_x_32gf", RegNet_X_32GF_Weights,
                         23, 320, 69.86, 2.0, 168)
