"""ConvNeXt tiny/small/base/large (counterpart of
``vision_tpu/models/convnext.py``).

NCHW input; module and state-dict names are torchvision's
(``features.{i}.{j}.block.{0,2,3,5}``, ``features.{i}.{j}.layer_scale`` of
shape ``(dim, 1, 1)``, ``classifier.{0,2}``), so its checkpoints load as
they are. A block is the 7x7 depthwise convolution, then channels-last
LayerNorm (eps 1e-6), Linear 4x, exact GELU, Linear, the layer scale and
stochastic depth (``"row"``, probability ``p * block_id / max(total - 1,
1)``), which draws from ``forward(x, generator=g)`` in training mode.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from vision_tpu_torch.models._api import WeightsEnum, register_model
from vision_tpu_torch.models._utils import (
    Device,
    build,
    cls_weights as _w,
    init_norms,
    trunc_normal_,
)
from vision_tpu_torch.ops.misc import Permute
from vision_tpu_torch.ops.stochastic_depth import stochastic_depth

__all__ = [
    "ConvNeXt",
    "ConvNeXt_Tiny_Weights",
    "ConvNeXt_Small_Weights",
    "ConvNeXt_Base_Weights",
    "ConvNeXt_Large_Weights",
    "convnext_tiny",
    "convnext_small",
    "convnext_base",
    "convnext_large",
]


class LayerNorm2d(nn.LayerNorm):
    """LayerNorm over the channels of NCHW input."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.permute(0, 2, 3, 1)
        x = F.layer_norm(x, self.normalized_shape, self.weight, self.bias,
                         self.eps)
        return x.permute(0, 3, 1, 2)


@dataclasses.dataclass(frozen=True)
class CNBlockConfig:
    input_channels: int
    out_channels: Optional[int]
    num_layers: int


class CNBlock(nn.Module):
    def __init__(self, dim: int, layer_scale: float, sd_prob: float):
        super().__init__()
        self.sd_prob = sd_prob
        self.layer_scale_value = layer_scale
        self.block = nn.Sequential(
            nn.Conv2d(dim, dim, 7, padding=3, groups=dim),
            Permute([0, 2, 3, 1]),
            nn.LayerNorm(dim, eps=1e-6),
            nn.Linear(dim, 4 * dim),
            nn.GELU(),
            nn.Linear(4 * dim, dim),
            Permute([0, 3, 1, 2]),
        )
        self.layer_scale = nn.Parameter(torch.full((dim, 1, 1), layer_scale))

    def forward(self, x: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        out = self.layer_scale * self.block(x)
        return x + stochastic_depth(out, self.sd_prob, "row", self.training,
                                    generator=generator)


class ConvNeXt(nn.Module):
    """torchvision's ``ConvNeXt``. ``forward(x, return_features=True)`` also
    returns each stage's output (before its downsampling) under
    ``features.{i}``."""

    def __init__(self, block_setting: Sequence[CNBlockConfig],
                 stochastic_depth_prob: float = 0.0, layer_scale: float = 1e-6,
                 num_classes: int = 1000):
        super().__init__()
        first = block_setting[0].input_channels
        layers: List[nn.Module] = [nn.Sequential(
            nn.Conv2d(3, first, 4, 4), LayerNorm2d(first, eps=1e-6))]
        total = sum(c.num_layers for c in block_setting)
        block_id = 0
        for cnf in block_setting:
            stage = []
            for _ in range(cnf.num_layers):
                sd = stochastic_depth_prob * block_id / max(total - 1.0, 1.0)
                stage.append(CNBlock(cnf.input_channels, layer_scale, sd))
                block_id += 1
            layers.append(nn.Sequential(*stage))
            if cnf.out_channels is not None:
                layers.append(nn.Sequential(
                    LayerNorm2d(cnf.input_channels, eps=1e-6),
                    nn.Conv2d(cnf.input_channels, cnf.out_channels, 2, 2)))
        self.features = nn.Sequential(*layers)
        last = block_setting[-1].out_channels or block_setting[-1].input_channels
        self.classifier = nn.Sequential(LayerNorm2d(last, eps=1e-6),
                                        nn.Flatten(1),
                                        nn.Linear(last, num_classes))

    def forward(self, x: torch.Tensor, return_features: bool = False,
                generator: Optional[torch.Generator] = None):
        features: Dict[str, torch.Tensor] = {}
        for i, layer in enumerate(self.features):
            if isinstance(layer[0], CNBlock):
                for block in layer:
                    x = block(x, generator)
                features[f"features.{i}"] = x
            else:
                x = layer(x)
        logits = self.classifier(x.mean((2, 3), keepdim=True))
        if return_features:
            return logits, features
        return logits


@torch.no_grad()
def init_weights(model: nn.Module, generator: torch.Generator) -> None:
    """torchvision's: convs and Linears truncated normal of std 0.02, zero
    bias; norms identity; the layer scale at its configured value."""
    init_norms(model)
    for m in model.modules():
        if isinstance(m, (nn.Conv2d, nn.Linear)):
            trunc_normal_(m.weight, 0.02, generator)
            m.bias.zero_()
        elif isinstance(m, CNBlock):
            m.layer_scale.fill_(m.layer_scale_value)


class ConvNeXt_Tiny_Weights(WeightsEnum):
    IMAGENET1K_V1 = _w("convnext_tiny-983f1562.pth", 82.52, 96.146, 28589128,
                       4.456, resize=236)
    DEFAULT = IMAGENET1K_V1


class ConvNeXt_Small_Weights(WeightsEnum):
    IMAGENET1K_V1 = _w("convnext_small-0c510722.pth", 83.616, 96.65, 50223688,
                       8.684, resize=230)
    DEFAULT = IMAGENET1K_V1


class ConvNeXt_Base_Weights(WeightsEnum):
    IMAGENET1K_V1 = _w("convnext_base-6075fbad.pth", 84.062, 96.87, 88591464,
                       15.355, resize=232)
    DEFAULT = IMAGENET1K_V1


class ConvNeXt_Large_Weights(WeightsEnum):
    IMAGENET1K_V1 = _w("convnext_large-ea097f82.pth", 84.414, 96.976,
                       197767336, 34.361, resize=232)
    DEFAULT = IMAGENET1K_V1


def _convnext(setting, sd_prob: float, weights_enum, weights, device: Device,
              seed: int, **kwargs: Any) -> ConvNeXt:
    weights = weights_enum.verify(weights)
    sd_prob = kwargs.pop("stochastic_depth_prob", sd_prob)
    return build(lambda: ConvNeXt(setting, sd_prob, **kwargs), init_weights,
                 weights, device, seed)


def _setting(dims, depths) -> List[CNBlockConfig]:
    outs = list(dims[1:]) + [None]
    return [CNBlockConfig(d, o, n) for d, o, n in zip(dims, outs, depths)]


@register_model()
def convnext_tiny(*, weights: Optional[ConvNeXt_Tiny_Weights] = None,
                  device: Device = None, seed: int = 0, **kwargs: Any):
    return _convnext(_setting((96, 192, 384, 768), (3, 3, 9, 3)), 0.1,
                     ConvNeXt_Tiny_Weights, weights, device, seed, **kwargs)


@register_model()
def convnext_small(*, weights: Optional[ConvNeXt_Small_Weights] = None,
                   device: Device = None, seed: int = 0, **kwargs: Any):
    return _convnext(_setting((96, 192, 384, 768), (3, 3, 27, 3)), 0.4,
                     ConvNeXt_Small_Weights, weights, device, seed, **kwargs)


@register_model()
def convnext_base(*, weights: Optional[ConvNeXt_Base_Weights] = None,
                  device: Device = None, seed: int = 0, **kwargs: Any):
    return _convnext(_setting((128, 256, 512, 1024), (3, 3, 27, 3)), 0.5,
                     ConvNeXt_Base_Weights, weights, device, seed, **kwargs)


@register_model()
def convnext_large(*, weights: Optional[ConvNeXt_Large_Weights] = None,
                   device: Device = None, seed: int = 0, **kwargs: Any):
    return _convnext(_setting((192, 384, 768, 1536), (3, 3, 27, 3)), 0.5,
                     ConvNeXt_Large_Weights, weights, device, seed, **kwargs)
