"""VGG 11/13/16/19, with and without batch norm (counterpart of
``vision_tpu/models/vgg.py``).

NCHW input; torchvision's module and state-dict names (``features.{i}``,
``classifier.{0,3,6}``). The pooled 7x7 map is flattened in CHW order, as
torchvision's is; the JAX model flattens HWC, and ``load_jax_variables``
reorders ``classifier.0``'s input columns (``jax_hwc_inputs``). The
dropouts draw from ``forward(x, generator=g)`` in training mode.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Union

import torch
import torch.nn.functional as F
from torch import nn

from vision_tpu_torch.models._api import WeightsEnum, register_model
from vision_tpu_torch.models._utils import (
    Device,
    build,
    cls_weights as _w,
    fan_out_init,
    normal_linear,
)
from vision_tpu_torch.ops.misc import BatchNorm2d, dropout as _dropout

__all__ = [
    "VGG",
    "VGG11_Weights",
    "VGG11_BN_Weights",
    "VGG13_Weights",
    "VGG13_BN_Weights",
    "VGG16_Weights",
    "VGG16_BN_Weights",
    "VGG19_Weights",
    "VGG19_BN_Weights",
    "vgg11",
    "vgg11_bn",
    "vgg13",
    "vgg13_bn",
    "vgg16",
    "vgg16_bn",
    "vgg19",
    "vgg19_bn",
]

CFGS: Dict[str, List[Union[int, str]]] = {
    "A": [64, "M", 128, "M", 256, 256, "M", 512, 512, "M", 512, 512, "M"],
    "B": [64, 64, "M", 128, 128, "M", 256, 256, "M", 512, 512, "M", 512, 512,
          "M"],
    "D": [64, 64, "M", 128, 128, "M", 256, 256, 256, "M", 512, 512, 512, "M",
          512, 512, 512, "M"],
    "E": [64, 64, "M", 128, 128, "M", 256, 256, 256, 256, "M", 512, 512, 512,
          512, "M", 512, 512, 512, 512, "M"],
}


class VGG(nn.Module):
    """torchvision's ``VGG``. ``forward(x, return_features=True)`` also
    returns each max pool's output under ``features.{i}``."""

    def __init__(self, cfg: str, batch_norm: bool = False,
                 num_classes: int = 1000, dropout: float = 0.5):
        super().__init__()
        self.dropout = dropout
        layers: List[nn.Module] = []
        cin = 3
        for v in CFGS[cfg]:
            if v == "M":
                layers.append(nn.MaxPool2d(2, 2))
                continue
            layers.append(nn.Conv2d(cin, v, 3, padding=1))
            if batch_norm:
                layers.append(BatchNorm2d(v))
            layers.append(nn.ReLU())
            cin = v
        self.features = nn.Sequential(*layers)
        self.avgpool = nn.AdaptiveAvgPool2d((7, 7))
        self.classifier = nn.Sequential(
            nn.Linear(512 * 7 * 7, 4096), nn.ReLU(), nn.Dropout(dropout),
            nn.Linear(4096, 4096), nn.ReLU(), nn.Dropout(dropout),
            nn.Linear(4096, num_classes))
        self.classifier.jax_hwc_inputs = {"0": (7, 7)}

    def forward(self, x: torch.Tensor, return_features: bool = False,
                generator: Optional[torch.Generator] = None):
        features: Dict[str, torch.Tensor] = {}
        for i, layer in enumerate(self.features):
            x = layer(x)
            if isinstance(layer, nn.MaxPool2d):
                features[f"features.{i}"] = x
        x = self.avgpool(x).flatten(1)
        p, train = self.dropout, self.training
        fc1, fc2, fc3 = self.classifier[0], self.classifier[3], self.classifier[6]
        x = _dropout(F.relu(fc1(x)), p, train, generator)
        x = _dropout(F.relu(fc2(x)), p, train, generator)
        logits = fc3(x)
        if return_features:
            return logits, features
        return logits


@torch.no_grad()
def init_weights(model: nn.Module, generator: torch.Generator) -> None:
    """torchvision's: convs He-normal over the fan out, zero bias; Linears
    normal of std 0.01, zero bias; norms identity."""
    fan_out_init(model, generator, normal_linear(0.01))


class VGG11_Weights(WeightsEnum):
    IMAGENET1K_V1 = _w("vgg11-8a719046.pth", 69.02, 88.628, 132863336, 7.609)
    DEFAULT = IMAGENET1K_V1


class VGG11_BN_Weights(WeightsEnum):
    IMAGENET1K_V1 = _w("vgg11_bn-6002323d.pth", 70.37, 89.81, 132868840, 7.609)
    DEFAULT = IMAGENET1K_V1


class VGG13_Weights(WeightsEnum):
    IMAGENET1K_V1 = _w("vgg13-19584684.pth", 69.928, 89.246, 133047848, 11.308)
    DEFAULT = IMAGENET1K_V1


class VGG13_BN_Weights(WeightsEnum):
    IMAGENET1K_V1 = _w("vgg13_bn-abd245e5.pth", 71.586, 90.374, 133053736,
                       11.308)
    DEFAULT = IMAGENET1K_V1


class VGG16_Weights(WeightsEnum):
    IMAGENET1K_V1 = _w("vgg16-397923af.pth", 71.592, 90.382, 138357544, 15.47)
    DEFAULT = IMAGENET1K_V1


class VGG16_BN_Weights(WeightsEnum):
    IMAGENET1K_V1 = _w("vgg16_bn-6c64b313.pth", 73.36, 91.516, 138365992,
                       15.47)
    DEFAULT = IMAGENET1K_V1


class VGG19_Weights(WeightsEnum):
    IMAGENET1K_V1 = _w("vgg19-dcbb9e9d.pth", 72.376, 90.876, 143667240, 19.632)
    DEFAULT = IMAGENET1K_V1


class VGG19_BN_Weights(WeightsEnum):
    IMAGENET1K_V1 = _w("vgg19_bn-c79401a0.pth", 74.218, 91.842, 143678248,
                       19.632)
    DEFAULT = IMAGENET1K_V1


def _vgg(cfg: str, batch_norm: bool, weights_enum, weights, device: Device,
         seed: int, **kwargs: Any) -> VGG:
    weights = weights_enum.verify(weights)
    return build(lambda: VGG(cfg, batch_norm, **kwargs), init_weights, weights,
                 device, seed)


@register_model()
def vgg11(*, weights: Optional[VGG11_Weights] = None, device: Device = None,
          seed: int = 0, **kwargs: Any) -> VGG:
    return _vgg("A", False, VGG11_Weights, weights, device, seed, **kwargs)


@register_model()
def vgg11_bn(*, weights: Optional[VGG11_BN_Weights] = None,
             device: Device = None, seed: int = 0, **kwargs: Any) -> VGG:
    return _vgg("A", True, VGG11_BN_Weights, weights, device, seed, **kwargs)


@register_model()
def vgg13(*, weights: Optional[VGG13_Weights] = None, device: Device = None,
          seed: int = 0, **kwargs: Any) -> VGG:
    return _vgg("B", False, VGG13_Weights, weights, device, seed, **kwargs)


@register_model()
def vgg13_bn(*, weights: Optional[VGG13_BN_Weights] = None,
             device: Device = None, seed: int = 0, **kwargs: Any) -> VGG:
    return _vgg("B", True, VGG13_BN_Weights, weights, device, seed, **kwargs)


@register_model()
def vgg16(*, weights: Optional[VGG16_Weights] = None, device: Device = None,
          seed: int = 0, **kwargs: Any) -> VGG:
    return _vgg("D", False, VGG16_Weights, weights, device, seed, **kwargs)


@register_model()
def vgg16_bn(*, weights: Optional[VGG16_BN_Weights] = None,
             device: Device = None, seed: int = 0, **kwargs: Any) -> VGG:
    return _vgg("D", True, VGG16_BN_Weights, weights, device, seed, **kwargs)


@register_model()
def vgg19(*, weights: Optional[VGG19_Weights] = None, device: Device = None,
          seed: int = 0, **kwargs: Any) -> VGG:
    return _vgg("E", False, VGG19_Weights, weights, device, seed, **kwargs)


@register_model()
def vgg19_bn(*, weights: Optional[VGG19_BN_Weights] = None,
             device: Device = None, seed: int = 0, **kwargs: Any) -> VGG:
    return _vgg("E", True, VGG19_BN_Weights, weights, device, seed, **kwargs)
