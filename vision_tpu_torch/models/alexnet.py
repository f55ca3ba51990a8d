"""AlexNet (counterpart of ``vision_tpu/models/alexnet.py``).

NCHW input; torchvision's module and state-dict names (``features.{i}``,
``classifier.{1,4,6}``). The pooled 6x6 map is flattened in CHW order, as
torchvision's is; the JAX model flattens HWC, and ``load_jax_variables``
reorders ``classifier.1``'s input columns (``jax_hwc_inputs``). The
dropouts draw from ``forward(x, generator=g)`` in training mode.
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
    default_,
)
from vision_tpu_torch.ops.misc import dropout as _dropout

__all__ = ["AlexNet", "AlexNet_Weights", "alexnet"]


class AlexNet(nn.Module):
    """torchvision's ``AlexNet``. ``forward(x, return_features=True)`` also
    returns the three max pools' outputs (``features.{2,5,12}``)."""

    def __init__(self, num_classes: int = 1000, dropout: float = 0.5):
        super().__init__()
        self.dropout = dropout
        self.features = nn.Sequential(
            nn.Conv2d(3, 64, 11, 4, 2), nn.ReLU(), nn.MaxPool2d(3, 2),
            nn.Conv2d(64, 192, 5, padding=2), nn.ReLU(), nn.MaxPool2d(3, 2),
            nn.Conv2d(192, 384, 3, padding=1), nn.ReLU(),
            nn.Conv2d(384, 256, 3, padding=1), nn.ReLU(),
            nn.Conv2d(256, 256, 3, padding=1), nn.ReLU(), nn.MaxPool2d(3, 2))
        self.avgpool = nn.AdaptiveAvgPool2d((6, 6))
        self.classifier = nn.Sequential(
            nn.Dropout(dropout), nn.Linear(256 * 6 * 6, 4096), nn.ReLU(),
            nn.Dropout(dropout), nn.Linear(4096, 4096), nn.ReLU(),
            nn.Linear(4096, num_classes))
        self.classifier.jax_hwc_inputs = {"1": (6, 6)}

    def forward(self, x: torch.Tensor, return_features: bool = False,
                generator: Optional[torch.Generator] = None):
        features: Dict[str, torch.Tensor] = {}
        for i, layer in enumerate(self.features):
            x = layer(x)
            if isinstance(layer, nn.MaxPool2d):
                features[f"features.{i}"] = x
        x = self.avgpool(x).flatten(1)
        p, train = self.dropout, self.training
        fc1, fc2, fc3 = self.classifier[1], self.classifier[4], self.classifier[6]
        x = F.relu(fc1(_dropout(x, p, train, generator)))
        x = F.relu(fc2(_dropout(x, p, train, generator)))
        logits = fc3(x)
        if return_features:
            return logits, features
        return logits


@torch.no_grad()
def init_weights(model: nn.Module, generator: torch.Generator) -> None:
    """PyTorch's default initialisation (torchvision sets none of its
    own)."""
    for m in model.modules():
        if isinstance(m, (nn.Conv2d, nn.Linear)):
            default_(m, generator)


class AlexNet_Weights(WeightsEnum):
    IMAGENET1K_V1 = _w("alexnet-owt-7be5be79.pth", 56.522, 79.066, 61100840,
                       0.714)
    DEFAULT = IMAGENET1K_V1


@register_model()
def alexnet(*, weights: Optional[AlexNet_Weights] = None, device: Device = None,
            seed: int = 0, **kwargs: Any) -> AlexNet:
    weights = AlexNet_Weights.verify(weights)
    return build(lambda: AlexNet(**kwargs), init_weights, weights, device, seed)
