"""Inception v3 (counterpart of ``vision_tpu/models/inception.py``).

NCHW input (299x299 at its eval size); torchvision's module and
state-dict names (``Conv2d_1a_3x3`` .. ``Mixed_7c``, ``AuxLogits``,
``fc``). Batch norm eps 1e-3. With weights, ``transform_input`` is on by
default. The auxiliary head (``aux_logits``, on by default) runs in
training mode only, where the model returns ``InceptionOutputs``. The
dropout draws from ``forward(x, generator=g)`` in training mode.
"""

from __future__ import annotations

from typing import Any, Dict, NamedTuple, Optional

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
    trunc_normal_,
)
from vision_tpu_torch.models.googlenet import BasicConv2d, transform_input
from vision_tpu_torch.ops.misc import dropout as _dropout

__all__ = ["Inception3", "InceptionOutputs", "Inception_V3_Weights",
           "inception_v3"]


class InceptionOutputs(NamedTuple):
    logits: torch.Tensor
    aux_logits: Optional[torch.Tensor]


def _avg(x: torch.Tensor) -> torch.Tensor:
    return F.avg_pool2d(x, 3, 1, 1)


class InceptionA(nn.Module):
    def __init__(self, cin: int, pool_features: int):
        super().__init__()
        self.branch1x1 = BasicConv2d(cin, 64, kernel_size=1)
        self.branch5x5_1 = BasicConv2d(cin, 48, kernel_size=1)
        self.branch5x5_2 = BasicConv2d(48, 64, kernel_size=5, padding=2)
        self.branch3x3dbl_1 = BasicConv2d(cin, 64, kernel_size=1)
        self.branch3x3dbl_2 = BasicConv2d(64, 96, kernel_size=3, padding=1)
        self.branch3x3dbl_3 = BasicConv2d(96, 96, kernel_size=3, padding=1)
        self.branch_pool = BasicConv2d(cin, pool_features, kernel_size=1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b5 = self.branch5x5_2(self.branch5x5_1(x))
        b3 = self.branch3x3dbl_3(self.branch3x3dbl_2(self.branch3x3dbl_1(x)))
        return torch.cat([self.branch1x1(x), b5, b3,
                          self.branch_pool(_avg(x))], 1)


class InceptionB(nn.Module):
    def __init__(self, cin: int):
        super().__init__()
        self.branch3x3 = BasicConv2d(cin, 384, kernel_size=3, stride=2)
        self.branch3x3dbl_1 = BasicConv2d(cin, 64, kernel_size=1)
        self.branch3x3dbl_2 = BasicConv2d(64, 96, kernel_size=3, padding=1)
        self.branch3x3dbl_3 = BasicConv2d(96, 96, kernel_size=3, stride=2)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        bd = self.branch3x3dbl_3(self.branch3x3dbl_2(self.branch3x3dbl_1(x)))
        return torch.cat([self.branch3x3(x), bd, F.max_pool2d(x, 3, 2)], 1)


class InceptionC(nn.Module):
    def __init__(self, cin: int, channels_7x7: int):
        super().__init__()
        c7 = channels_7x7
        self.branch1x1 = BasicConv2d(cin, 192, kernel_size=1)
        self.branch7x7_1 = BasicConv2d(cin, c7, kernel_size=1)
        self.branch7x7_2 = BasicConv2d(c7, c7, kernel_size=(1, 7), padding=(0, 3))
        self.branch7x7_3 = BasicConv2d(c7, 192, kernel_size=(7, 1), padding=(3, 0))
        self.branch7x7dbl_1 = BasicConv2d(cin, c7, kernel_size=1)
        self.branch7x7dbl_2 = BasicConv2d(c7, c7, kernel_size=(7, 1), padding=(3, 0))
        self.branch7x7dbl_3 = BasicConv2d(c7, c7, kernel_size=(1, 7), padding=(0, 3))
        self.branch7x7dbl_4 = BasicConv2d(c7, c7, kernel_size=(7, 1), padding=(3, 0))
        self.branch7x7dbl_5 = BasicConv2d(c7, 192, kernel_size=(1, 7), padding=(0, 3))
        self.branch_pool = BasicConv2d(cin, 192, kernel_size=1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b7 = self.branch7x7_3(self.branch7x7_2(self.branch7x7_1(x)))
        bd = self.branch7x7dbl_1(x)
        for conv in (self.branch7x7dbl_2, self.branch7x7dbl_3,
                     self.branch7x7dbl_4, self.branch7x7dbl_5):
            bd = conv(bd)
        return torch.cat([self.branch1x1(x), b7, bd,
                          self.branch_pool(_avg(x))], 1)


class InceptionD(nn.Module):
    def __init__(self, cin: int):
        super().__init__()
        self.branch3x3_1 = BasicConv2d(cin, 192, kernel_size=1)
        self.branch3x3_2 = BasicConv2d(192, 320, kernel_size=3, stride=2)
        self.branch7x7x3_1 = BasicConv2d(cin, 192, kernel_size=1)
        self.branch7x7x3_2 = BasicConv2d(192, 192, kernel_size=(1, 7), padding=(0, 3))
        self.branch7x7x3_3 = BasicConv2d(192, 192, kernel_size=(7, 1), padding=(3, 0))
        self.branch7x7x3_4 = BasicConv2d(192, 192, kernel_size=3, stride=2)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b3 = self.branch3x3_2(self.branch3x3_1(x))
        b7 = self.branch7x7x3_1(x)
        for conv in (self.branch7x7x3_2, self.branch7x7x3_3, self.branch7x7x3_4):
            b7 = conv(b7)
        return torch.cat([b3, b7, F.max_pool2d(x, 3, 2)], 1)


class InceptionE(nn.Module):
    def __init__(self, cin: int):
        super().__init__()
        self.branch1x1 = BasicConv2d(cin, 320, kernel_size=1)
        self.branch3x3_1 = BasicConv2d(cin, 384, kernel_size=1)
        self.branch3x3_2a = BasicConv2d(384, 384, kernel_size=(1, 3), padding=(0, 1))
        self.branch3x3_2b = BasicConv2d(384, 384, kernel_size=(3, 1), padding=(1, 0))
        self.branch3x3dbl_1 = BasicConv2d(cin, 448, kernel_size=1)
        self.branch3x3dbl_2 = BasicConv2d(448, 384, kernel_size=3, padding=1)
        self.branch3x3dbl_3a = BasicConv2d(384, 384, kernel_size=(1, 3), padding=(0, 1))
        self.branch3x3dbl_3b = BasicConv2d(384, 384, kernel_size=(3, 1), padding=(1, 0))
        self.branch_pool = BasicConv2d(cin, 192, kernel_size=1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b3 = self.branch3x3_1(x)
        b3 = torch.cat([self.branch3x3_2a(b3), self.branch3x3_2b(b3)], 1)
        bd = self.branch3x3dbl_2(self.branch3x3dbl_1(x))
        bd = torch.cat([self.branch3x3dbl_3a(bd), self.branch3x3dbl_3b(bd)], 1)
        return torch.cat([self.branch1x1(x), b3, bd,
                          self.branch_pool(_avg(x))], 1)


class InceptionAux(nn.Module):
    def __init__(self, cin: int, num_classes: int):
        super().__init__()
        self.conv0 = BasicConv2d(cin, 128, kernel_size=1)
        self.conv1 = BasicConv2d(128, 768, kernel_size=5)
        self.fc = nn.Linear(768, num_classes)
        self.conv1.stddev = 0.01
        self.fc.stddev = 0.001

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.conv1(self.conv0(F.avg_pool2d(x, 5, 3)))
        return self.fc(x.mean((2, 3)))


class Inception3(nn.Module):
    """torchvision's ``Inception3``. ``forward(x, return_features=True)``
    also returns ``Mixed_5d``'s, ``Mixed_6e``'s and ``Mixed_7c``'s
    outputs."""

    def __init__(self, num_classes: int = 1000, aux_logits: bool = True,
                 transform_input: bool = False, dropout: float = 0.5):
        super().__init__()
        self.aux_logits = aux_logits
        self.transform_input = transform_input
        self.dropout = dropout
        self.Conv2d_1a_3x3 = BasicConv2d(3, 32, kernel_size=3, stride=2)
        self.Conv2d_2a_3x3 = BasicConv2d(32, 32, kernel_size=3)
        self.Conv2d_2b_3x3 = BasicConv2d(32, 64, kernel_size=3, padding=1)
        self.Conv2d_3b_1x1 = BasicConv2d(64, 80, kernel_size=1)
        self.Conv2d_4a_3x3 = BasicConv2d(80, 192, kernel_size=3)
        self.Mixed_5b = InceptionA(192, 32)
        self.Mixed_5c = InceptionA(256, 64)
        self.Mixed_5d = InceptionA(288, 64)
        self.Mixed_6a = InceptionB(288)
        self.Mixed_6b = InceptionC(768, 128)
        self.Mixed_6c = InceptionC(768, 160)
        self.Mixed_6d = InceptionC(768, 160)
        self.Mixed_6e = InceptionC(768, 192)
        self.AuxLogits = InceptionAux(768, num_classes) if aux_logits else None
        self.Mixed_7a = InceptionD(768)
        self.Mixed_7b = InceptionE(1280)
        self.Mixed_7c = InceptionE(2048)
        self.fc = nn.Linear(2048, num_classes)

    def forward(self, x: torch.Tensor, return_features: bool = False,
                generator: Optional[torch.Generator] = None):
        if self.transform_input:
            x = transform_input(x)
        x = self.Conv2d_2b_3x3(self.Conv2d_2a_3x3(self.Conv2d_1a_3x3(x)))
        x = self.Conv2d_4a_3x3(self.Conv2d_3b_1x1(F.max_pool2d(x, 3, 2)))
        x = F.max_pool2d(x, 3, 2)
        x = self.Mixed_5d(self.Mixed_5c(self.Mixed_5b(x)))
        features: Dict[str, torch.Tensor] = {"Mixed_5d": x}
        x = self.Mixed_6a(x)
        for block in (self.Mixed_6b, self.Mixed_6c, self.Mixed_6d, self.Mixed_6e):
            x = block(x)
        features["Mixed_6e"] = x
        aux = self.aux_logits and self.training
        aux_out = self.AuxLogits(x) if aux else None
        x = self.Mixed_7c(self.Mixed_7b(self.Mixed_7a(x)))
        features["Mixed_7c"] = x
        x = _dropout(x.mean((2, 3)), self.dropout, self.training, generator)
        logits = self.fc(x)
        if aux:
            return InceptionOutputs(logits, aux_out)
        if return_features:
            return logits, features
        return logits


@torch.no_grad()
def init_weights(model: nn.Module, generator: torch.Generator) -> None:
    """torchvision's: conv and Linear weights truncated normal (cut at
    +-2) of std 0.1, or the module's ``stddev``; Linear biases PyTorch's
    default; norms identity."""
    init_norms(model)
    for m in model.modules():
        if isinstance(m, nn.Linear):
            default_(m, generator)
        if isinstance(m, (nn.Conv2d, nn.Linear)):
            trunc_normal_(m.weight, getattr(m, "stddev", 0.1), generator)


class Inception_V3_Weights(WeightsEnum):
    IMAGENET1K_V1 = _w("inception_v3_google-0cc3c7bd.pth", 77.294, 93.45,
                       27161264, 5.713, crop=299, resize=342)
    DEFAULT = IMAGENET1K_V1


@register_model()
def inception_v3(*, weights: Optional[Inception_V3_Weights] = None,
                 device: Device = None, seed: int = 0,
                 **kwargs: Any) -> Inception3:
    weights = Inception_V3_Weights.verify(weights)
    if weights is not None:
        kwargs.setdefault("transform_input", True)
    return build(lambda: Inception3(**kwargs), init_weights, weights, device,
                 seed)
