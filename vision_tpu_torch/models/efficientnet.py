"""EfficientNet B0-B7 and V2 S/M/L (counterpart of
``vision_tpu/models/efficientnet.py``).

NCHW input; module and state-dict names are torchvision's
(``features.{stage}.{j}.block.{i}.0.weight``, ``classifier.1``), so its
checkpoints load as they are. Batch norm is the port's flax-following
``BatchNorm2d``: eps 1e-5 and torch momentum 0.1 for B0-B4, 1e-3 and 0.01
for B5-B7, 1e-3 and 0.1 for V2. Stochastic depth (``"row"``, probability
``p * block_id / total_blocks``) and the classifier's dropout draw from
``forward(x, generator=g)`` in training mode.
"""

from __future__ import annotations

import copy
import dataclasses
import functools
import math
from typing import Any, Dict, List, Optional, Sequence

import torch
from torch import nn

from vision_tpu_torch.models._api import WeightsEnum, register_model
from vision_tpu_torch.models._utils import (
    Device,
    _make_divisible,
    build,
    cls_weights as _w,
    fan_out_init,
    uniform_,
)
from vision_tpu_torch.ops.misc import (
    BatchNorm2d,
    Conv2dNormActivation,
    SqueezeExcitation,
    dropout as _dropout,
)
from vision_tpu_torch.ops.stochastic_depth import stochastic_depth

__all__ = [
    "EfficientNet",
    "EfficientNet_B0_Weights",
    "EfficientNet_B1_Weights",
    "EfficientNet_B2_Weights",
    "EfficientNet_B3_Weights",
    "EfficientNet_B4_Weights",
    "EfficientNet_B5_Weights",
    "EfficientNet_B6_Weights",
    "EfficientNet_B7_Weights",
    "EfficientNet_V2_S_Weights",
    "EfficientNet_V2_M_Weights",
    "EfficientNet_V2_L_Weights",
    "efficientnet_b0",
    "efficientnet_b1",
    "efficientnet_b2",
    "efficientnet_b3",
    "efficientnet_b4",
    "efficientnet_b5",
    "efficientnet_b6",
    "efficientnet_b7",
    "efficientnet_v2_s",
    "efficientnet_v2_m",
    "efficientnet_v2_l",
]


@dataclasses.dataclass
class BlockConf:
    """One stage: expansion ratio, kernel, stride of its first block,
    input and output channels, blocks, and whether they are FusedMBConv."""

    expand_ratio: float
    kernel: int
    stride: int
    input_channels: int
    out_channels: int
    num_layers: int
    fused: bool = False

    @staticmethod
    def adjust_channels(ch: float, width_mult: float) -> int:
        return _make_divisible(ch * width_mult, 8)


def mbconf(e, k, s, i, o, n, width_mult=1.0, depth_mult=1.0) -> BlockConf:
    return BlockConf(e, k, s, BlockConf.adjust_channels(i, width_mult),
                     BlockConf.adjust_channels(o, width_mult),
                     int(math.ceil(n * depth_mult)))


def fusedconf(e, k, s, i, o, n) -> BlockConf:
    return BlockConf(e, k, s, i, o, n, fused=True)


def _cna(cin: int, cout: int, kernel: int, stride: int = 1, groups: int = 1,
         act: bool = True, norm=BatchNorm2d) -> Conv2dNormActivation:
    return Conv2dNormActivation(cin, cout, kernel, stride, groups=groups,
                                norm_layer=norm,
                                activation_layer=nn.SiLU if act else None,
                                inplace=None)


class MBConv(nn.Module):
    """Expansion 1x1 (skipped when it would keep the width), depthwise,
    squeeze-excitation (squeeze ``max(1, in // 4)``), projection 1x1; the
    residual where the shape is kept, through stochastic depth."""

    def __init__(self, cnf: BlockConf, sd_prob: float, norm):
        super().__init__()
        self.use_res = cnf.stride == 1 and cnf.input_channels == cnf.out_channels
        self.sd_prob = sd_prob
        expanded = BlockConf.adjust_channels(cnf.input_channels, cnf.expand_ratio)
        layers: List[nn.Module] = []
        if expanded != cnf.input_channels:
            layers.append(_cna(cnf.input_channels, expanded, 1, norm=norm))
        layers.append(_cna(expanded, expanded, cnf.kernel, cnf.stride,
                           groups=expanded, norm=norm))
        layers.append(SqueezeExcitation(
            expanded, max(1, cnf.input_channels // 4), activation=nn.SiLU))
        layers.append(_cna(expanded, cnf.out_channels, 1, act=False, norm=norm))
        self.block = nn.Sequential(*layers)

    def forward(self, x: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        out = self.block(x)
        if self.use_res:
            out = stochastic_depth(out, self.sd_prob, "row", self.training,
                                   generator=generator) + x
        return out


class FusedMBConv(MBConv):
    """A full kxk convolution in place of expansion and depthwise (then a
    1x1 projection, unless the width is kept); no squeeze-excitation."""

    def __init__(self, cnf: BlockConf, sd_prob: float, norm):
        nn.Module.__init__(self)
        self.use_res = cnf.stride == 1 and cnf.input_channels == cnf.out_channels
        self.sd_prob = sd_prob
        expanded = BlockConf.adjust_channels(cnf.input_channels, cnf.expand_ratio)
        if expanded != cnf.input_channels:
            layers = [_cna(cnf.input_channels, expanded, cnf.kernel,
                           cnf.stride, norm=norm),
                      _cna(expanded, cnf.out_channels, 1, act=False, norm=norm)]
        else:
            layers = [_cna(cnf.input_channels, cnf.out_channels, cnf.kernel,
                           cnf.stride, norm=norm)]
        self.block = nn.Sequential(*layers)


class EfficientNet(nn.Module):
    """torchvision's ``EfficientNet``. ``forward(x, return_features=True)``
    also returns the stem's, every stage's and the last convolution's
    output under ``features.{i}``."""

    def __init__(self, setting: Sequence[BlockConf], dropout: float,
                 stochastic_depth_prob: float = 0.2, num_classes: int = 1000,
                 last_channel: Optional[int] = None, bn_eps: float = 1e-5,
                 bn_momentum: float = 0.1):
        super().__init__()
        norm = functools.partial(BatchNorm2d, eps=bn_eps, momentum=bn_momentum)
        self.dropout = dropout
        stages: List[nn.Module] = [_cna(3, setting[0].input_channels, 3, 2,
                                        norm=norm)]
        total = sum(c.num_layers for c in setting)
        block_id = 0
        for cnf in setting:
            blocks = []
            for j in range(cnf.num_layers):
                bc = copy.copy(cnf)
                if j > 0:
                    bc.input_channels, bc.stride = bc.out_channels, 1
                sd = stochastic_depth_prob * block_id / total
                blocks.append((FusedMBConv if bc.fused else MBConv)(bc, sd, norm))
                block_id += 1
            stages.append(nn.Sequential(*blocks))
        last_in = setting[-1].out_channels
        stages.append(_cna(last_in, last_channel or 4 * last_in, 1, norm=norm))
        self.features = nn.Sequential(*stages)
        self.classifier = nn.Sequential(
            nn.Dropout(dropout), nn.Linear(last_channel or 4 * last_in,
                                           num_classes))

    def forward(self, x: torch.Tensor, return_features: bool = False,
                generator: Optional[torch.Generator] = None):
        features: Dict[str, torch.Tensor] = {}
        for i, stage in enumerate(self.features):
            if isinstance(stage, Conv2dNormActivation):
                x = stage(x)
            else:
                for block in stage:
                    x = block(x, generator)
            features[f"features.{i}"] = x
        x = _dropout(x.mean((2, 3)), self.dropout, self.training, generator)
        logits = self.classifier[1](x)
        if return_features:
            return logits, features
        return logits


@torch.no_grad()
def init_weights(model: nn.Module, generator: torch.Generator) -> None:
    """torchvision's: convs He-normal over the fan out, zero bias; Linear
    uniform in +-1/sqrt(out features), zero bias; norms identity."""
    def linear(m: nn.Linear, g: torch.Generator) -> None:
        uniform_(m.weight, 1.0 / math.sqrt(m.out_features), g)
        m.bias.zero_()

    fan_out_init(model, generator, linear)


def _b_setting(width_mult: float, depth_mult: float) -> List[BlockConf]:
    c = functools.partial(mbconf, width_mult=width_mult, depth_mult=depth_mult)
    return [c(1, 3, 1, 32, 16, 1), c(6, 3, 2, 16, 24, 2), c(6, 5, 2, 24, 40, 2),
            c(6, 3, 2, 40, 80, 3), c(6, 5, 1, 80, 112, 3),
            c(6, 5, 2, 112, 192, 4), c(6, 3, 1, 192, 320, 1)]


_V2_SETTINGS = {
    "s": [fusedconf(1, 3, 1, 24, 24, 2), fusedconf(4, 3, 2, 24, 48, 4),
          fusedconf(4, 3, 2, 48, 64, 4), mbconf(4, 3, 2, 64, 128, 6),
          mbconf(6, 3, 1, 128, 160, 9), mbconf(6, 3, 2, 160, 256, 15)],
    "m": [fusedconf(1, 3, 1, 24, 24, 3), fusedconf(4, 3, 2, 24, 48, 5),
          fusedconf(4, 3, 2, 48, 80, 5), mbconf(4, 3, 2, 80, 160, 7),
          mbconf(6, 3, 1, 160, 176, 14), mbconf(6, 3, 2, 176, 304, 18),
          mbconf(6, 3, 1, 304, 512, 5)],
    "l": [fusedconf(1, 3, 1, 32, 32, 4), fusedconf(4, 3, 2, 32, 64, 7),
          fusedconf(4, 3, 2, 64, 96, 7), mbconf(4, 3, 2, 96, 192, 10),
          mbconf(6, 3, 1, 192, 224, 19), mbconf(6, 3, 2, 224, 384, 25),
          mbconf(6, 3, 1, 384, 640, 7)],
}


class EfficientNet_B0_Weights(WeightsEnum):
    IMAGENET1K_V1 = _w("efficientnet_b0_rwightman-7f5810bc.pth", 77.692,
                       93.532, 5288548, 0.386, interp="bicubic")
    DEFAULT = IMAGENET1K_V1


class EfficientNet_B1_Weights(WeightsEnum):
    IMAGENET1K_V1 = _w("efficientnet_b1_rwightman-bac287d4.pth", 78.642,
                       94.186, 7794184, 0.687, crop=240, interp="bicubic")
    IMAGENET1K_V2 = _w("efficientnet_b1-c27df63c.pth", 79.838, 94.934, 7794184,
                       0.687, crop=240, resize=255)
    DEFAULT = IMAGENET1K_V2


class EfficientNet_B2_Weights(WeightsEnum):
    IMAGENET1K_V1 = _w("efficientnet_b2_rwightman-c35c1473.pth", 80.608, 95.31,
                       9109994, 1.088, crop=288, resize=288, interp="bicubic")
    DEFAULT = IMAGENET1K_V1


class EfficientNet_B3_Weights(WeightsEnum):
    IMAGENET1K_V1 = _w("efficientnet_b3_rwightman-b3899882.pth", 82.008,
                       96.054, 12233232, 1.827, crop=300, resize=320,
                       interp="bicubic")
    DEFAULT = IMAGENET1K_V1


class EfficientNet_B4_Weights(WeightsEnum):
    IMAGENET1K_V1 = _w("efficientnet_b4_rwightman-23ab8bcd.pth", 83.384,
                       96.594, 19341616, 4.394, crop=380, resize=384,
                       interp="bicubic")
    DEFAULT = IMAGENET1K_V1


class EfficientNet_B5_Weights(WeightsEnum):
    IMAGENET1K_V1 = _w("efficientnet_b5_lukemelas-1a07897c.pth", 83.444,
                       96.628, 30389784, 10.266, crop=456, resize=456,
                       interp="bicubic")
    DEFAULT = IMAGENET1K_V1


class EfficientNet_B6_Weights(WeightsEnum):
    IMAGENET1K_V1 = _w("efficientnet_b6_lukemelas-24a108a5.pth", 84.008,
                       96.916, 43040704, 19.068, crop=528, resize=528,
                       interp="bicubic")
    DEFAULT = IMAGENET1K_V1


class EfficientNet_B7_Weights(WeightsEnum):
    IMAGENET1K_V1 = _w("efficientnet_b7_lukemelas-c5b4e57e.pth", 84.122,
                       96.908, 66347960, 37.746, crop=600, resize=600,
                       interp="bicubic")
    DEFAULT = IMAGENET1K_V1


class EfficientNet_V2_S_Weights(WeightsEnum):
    IMAGENET1K_V1 = _w("efficientnet_v2_s-dd5fe13b.pth", 84.228, 96.878,
                       21458488, 8.366, crop=384, resize=384)
    DEFAULT = IMAGENET1K_V1


class EfficientNet_V2_M_Weights(WeightsEnum):
    IMAGENET1K_V1 = _w("efficientnet_v2_m-dc08266a.pth", 85.112, 97.156,
                       54139356, 24.582, crop=480, resize=480)
    DEFAULT = IMAGENET1K_V1


class EfficientNet_V2_L_Weights(WeightsEnum):
    IMAGENET1K_V1 = _w("efficientnet_v2_l-59c71312.pth", 85.808, 97.788,
                       118515272, 56.08, crop=480, resize=480,
                       interp="bicubic")
    DEFAULT = IMAGENET1K_V1


def _build_b(width_mult: float, depth_mult: float, drop: float,
             weights_enum, weights, device: Device, seed: int,
             bn_eps: float = 1e-5, bn_momentum: float = 0.1,
             **kwargs: Any) -> EfficientNet:
    weights = weights_enum.verify(weights)
    dropout = kwargs.pop("dropout", drop)
    return build(lambda: EfficientNet(
        _b_setting(width_mult, depth_mult), dropout, bn_eps=bn_eps,
        bn_momentum=bn_momentum, **kwargs), init_weights, weights, device, seed)


def _build_v2(size: str, drop: float, weights_enum, weights,
              device: Device, seed: int, **kwargs: Any) -> EfficientNet:
    weights = weights_enum.verify(weights)
    dropout = kwargs.pop("dropout", drop)
    return build(lambda: EfficientNet(
        _V2_SETTINGS[size], dropout, last_channel=1280, bn_eps=1e-3,
        **kwargs), init_weights, weights, device, seed)


@register_model()
def efficientnet_b0(*, weights: Optional[EfficientNet_B0_Weights] = None,
                    device: Device = None, seed: int = 0, **kwargs: Any):
    return _build_b(1.0, 1.0, 0.2, EfficientNet_B0_Weights, weights, device,
                    seed, **kwargs)


@register_model()
def efficientnet_b1(*, weights: Optional[EfficientNet_B1_Weights] = None,
                    device: Device = None, seed: int = 0, **kwargs: Any):
    return _build_b(1.0, 1.1, 0.2, EfficientNet_B1_Weights, weights, device,
                    seed, **kwargs)


@register_model()
def efficientnet_b2(*, weights: Optional[EfficientNet_B2_Weights] = None,
                    device: Device = None, seed: int = 0, **kwargs: Any):
    return _build_b(1.1, 1.2, 0.3, EfficientNet_B2_Weights, weights, device,
                    seed, **kwargs)


@register_model()
def efficientnet_b3(*, weights: Optional[EfficientNet_B3_Weights] = None,
                    device: Device = None, seed: int = 0, **kwargs: Any):
    return _build_b(1.2, 1.4, 0.3, EfficientNet_B3_Weights, weights, device,
                    seed, **kwargs)


@register_model()
def efficientnet_b4(*, weights: Optional[EfficientNet_B4_Weights] = None,
                    device: Device = None, seed: int = 0, **kwargs: Any):
    return _build_b(1.4, 1.8, 0.4, EfficientNet_B4_Weights, weights, device,
                    seed, **kwargs)


@register_model()
def efficientnet_b5(*, weights: Optional[EfficientNet_B5_Weights] = None,
                    device: Device = None, seed: int = 0, **kwargs: Any):
    return _build_b(1.6, 2.2, 0.4, EfficientNet_B5_Weights, weights, device,
                    seed, bn_eps=1e-3, bn_momentum=0.01, **kwargs)


@register_model()
def efficientnet_b6(*, weights: Optional[EfficientNet_B6_Weights] = None,
                    device: Device = None, seed: int = 0, **kwargs: Any):
    return _build_b(1.8, 2.6, 0.5, EfficientNet_B6_Weights, weights, device,
                    seed, bn_eps=1e-3, bn_momentum=0.01, **kwargs)


@register_model()
def efficientnet_b7(*, weights: Optional[EfficientNet_B7_Weights] = None,
                    device: Device = None, seed: int = 0, **kwargs: Any):
    return _build_b(2.0, 3.1, 0.5, EfficientNet_B7_Weights, weights, device,
                    seed, bn_eps=1e-3, bn_momentum=0.01, **kwargs)


@register_model()
def efficientnet_v2_s(*, weights: Optional[EfficientNet_V2_S_Weights] = None,
                      device: Device = None, seed: int = 0, **kwargs: Any):
    return _build_v2("s", 0.2, EfficientNet_V2_S_Weights, weights, device,
                     seed, **kwargs)


@register_model()
def efficientnet_v2_m(*, weights: Optional[EfficientNet_V2_M_Weights] = None,
                      device: Device = None, seed: int = 0, **kwargs: Any):
    return _build_v2("m", 0.3, EfficientNet_V2_M_Weights, weights, device,
                     seed, **kwargs)


@register_model()
def efficientnet_v2_l(*, weights: Optional[EfficientNet_V2_L_Weights] = None,
                      device: Device = None, seed: int = 0, **kwargs: Any):
    return _build_v2("l", 0.4, EfficientNet_V2_L_Weights, weights, device,
                     seed, **kwargs)
