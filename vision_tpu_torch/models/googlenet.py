"""GoogLeNet (counterpart of ``vision_tpu/models/googlenet.py``).

NCHW input; torchvision's module and state-dict names (``conv{1,2,3}``,
``inception{3a..5b}.branch{1..4}``, ``aux{1,2}.{conv,fc1,fc2}``, ``fc``).
Batch norm eps 1e-3; the max pools keep partial windows (``ceil_mode``);
branch 3 is a 3x3 convolution, torchvision's known quirk. With weights,
``transform_input`` is on by default. The auxiliary heads
(``aux_logits=True``; off by default, as the JAX builder has it) pool
their 4x4 input in CHW order, where the JAX heads flatten HWC:
``load_jax_variables`` reorders ``aux{1,2}.fc1``'s input columns
(``jax_hwc_inputs``). In training mode with them the model returns
``GoogLeNetOutputs``. The dropouts draw from ``forward(x, generator=g)``
in training mode.
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
from vision_tpu_torch.ops.misc import BatchNorm2d, dropout as _dropout

__all__ = ["GoogLeNet", "GoogLeNetOutputs", "GoogLeNet_Weights", "googlenet"]


class GoogLeNetOutputs(NamedTuple):
    logits: torch.Tensor
    aux_logits2: Optional[torch.Tensor]
    aux_logits1: Optional[torch.Tensor]


def transform_input(x: torch.Tensor) -> torch.Tensor:
    """ImageNet-normalised NCHW input re-normalised to mean 0.5, std 0.5
    (the layout of the Inception checkpoints)."""
    mean = x.new_tensor([0.485, 0.456, 0.406])
    std = x.new_tensor([0.229, 0.224, 0.225])
    scale = (std / 0.5)[None, :, None, None]
    return x * scale + ((mean - 0.5) / 0.5)[None, :, None, None]


class BasicConv2d(nn.Module):
    """Bias-free convolution, batch norm (eps 1e-3), ReLU."""

    def __init__(self, cin: int, cout: int, **kwargs: Any):
        super().__init__()
        self.conv = nn.Conv2d(cin, cout, bias=False, **kwargs)
        self.bn = BatchNorm2d(cout, eps=0.001)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.relu(self.bn(self.conv(x)))


class Inception(nn.Module):
    def __init__(self, cin: int, ch1x1: int, ch3x3red: int, ch3x3: int,
                 ch5x5red: int, ch5x5: int, pool_proj: int):
        super().__init__()
        self.branch1 = BasicConv2d(cin, ch1x1, kernel_size=1)
        self.branch2 = nn.Sequential(
            BasicConv2d(cin, ch3x3red, kernel_size=1),
            BasicConv2d(ch3x3red, ch3x3, kernel_size=3, padding=1))
        self.branch3 = nn.Sequential(
            BasicConv2d(cin, ch5x5red, kernel_size=1),
            BasicConv2d(ch5x5red, ch5x5, kernel_size=3, padding=1))
        self.branch4 = nn.Sequential(
            nn.MaxPool2d(3, 1, 1, ceil_mode=True),
            BasicConv2d(cin, pool_proj, kernel_size=1))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return torch.cat([self.branch1(x), self.branch2(x), self.branch3(x),
                          self.branch4(x)], 1)


class InceptionAux(nn.Module):
    def __init__(self, cin: int, num_classes: int, dropout: float = 0.7):
        super().__init__()
        self.dropout = dropout
        self.conv = BasicConv2d(cin, 128, kernel_size=1)
        self.fc1 = nn.Linear(2048, 1024)
        self.fc2 = nn.Linear(1024, num_classes)
        self.jax_hwc_inputs = {"fc1": (4, 4)}

    def forward(self, x: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        x = self.conv(F.adaptive_avg_pool2d(x, (4, 4))).flatten(1)
        x = _dropout(F.relu(self.fc1(x)), self.dropout, self.training,
                     generator)
        return self.fc2(x)


class GoogLeNet(nn.Module):
    """torchvision's ``GoogLeNet``. ``forward(x, return_features=True)``
    also returns ``inception3b``'s, ``inception4e``'s and
    ``inception5b``'s outputs."""

    def __init__(self, num_classes: int = 1000, aux_logits: bool = False,
                 transform_input: bool = False, dropout: float = 0.2,
                 dropout_aux: float = 0.7):
        super().__init__()
        self.aux_logits = aux_logits
        self.transform_input = transform_input
        self.dropout = dropout
        self.conv1 = BasicConv2d(3, 64, kernel_size=7, stride=2, padding=3)
        self.maxpool1 = nn.MaxPool2d(3, 2, ceil_mode=True)
        self.conv2 = BasicConv2d(64, 64, kernel_size=1)
        self.conv3 = BasicConv2d(64, 192, kernel_size=3, padding=1)
        self.maxpool2 = nn.MaxPool2d(3, 2, ceil_mode=True)
        self.inception3a = Inception(192, 64, 96, 128, 16, 32, 32)
        self.inception3b = Inception(256, 128, 128, 192, 32, 96, 64)
        self.maxpool3 = nn.MaxPool2d(3, 2, ceil_mode=True)
        self.inception4a = Inception(480, 192, 96, 208, 16, 48, 64)
        self.inception4b = Inception(512, 160, 112, 224, 24, 64, 64)
        self.inception4c = Inception(512, 128, 128, 256, 24, 64, 64)
        self.inception4d = Inception(512, 112, 144, 288, 32, 64, 64)
        self.inception4e = Inception(528, 256, 160, 320, 32, 128, 128)
        self.maxpool4 = nn.MaxPool2d(2, 2, ceil_mode=True)
        self.inception5a = Inception(832, 256, 160, 320, 32, 128, 128)
        self.inception5b = Inception(832, 384, 192, 384, 48, 128, 128)
        if aux_logits:
            self.aux1 = InceptionAux(512, num_classes, dropout_aux)
            self.aux2 = InceptionAux(528, num_classes, dropout_aux)
        else:
            self.aux1 = self.aux2 = None
        self.fc = nn.Linear(1024, num_classes)

    def forward(self, x: torch.Tensor, return_features: bool = False,
                generator: Optional[torch.Generator] = None):
        if self.transform_input:
            x = transform_input(x)
        x = self.maxpool1(self.conv1(x))
        x = self.maxpool2(self.conv3(self.conv2(x)))
        x = self.inception3b(self.inception3a(x))
        features: Dict[str, torch.Tensor] = {"inception3b": x}
        x = self.inception4a(self.maxpool3(x))
        aux = self.aux_logits and self.training
        aux1 = self.aux1(x, generator) if aux else None
        x = self.inception4d(self.inception4c(self.inception4b(x)))
        aux2 = self.aux2(x, generator) if aux else None
        x = self.inception4e(x)
        features["inception4e"] = x
        x = self.inception5b(self.inception5a(self.maxpool4(x)))
        features["inception5b"] = x
        x = _dropout(x.mean((2, 3)), self.dropout, self.training, generator)
        logits = self.fc(x)
        if aux:
            return GoogLeNetOutputs(logits, aux2, aux1)
        if return_features:
            return logits, features
        return logits


@torch.no_grad()
def init_weights(model: nn.Module, generator: torch.Generator) -> None:
    """torchvision's: conv and Linear weights truncated normal of std 0.01
    (cut at +-2), Linear biases PyTorch's default; norms identity."""
    init_norms(model)
    for m in model.modules():
        if isinstance(m, nn.Linear):
            default_(m, generator)
        if isinstance(m, (nn.Conv2d, nn.Linear)):
            trunc_normal_(m.weight, 0.01, generator)


def _checkpoint_hook(state: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """The published checkpoint carries the auxiliary heads; a model built
    without them drops them, as torchvision's builder does."""
    return {k: v for k, v in state.items()
            if not k.startswith(("aux1.", "aux2."))}


class GoogLeNet_Weights(WeightsEnum):
    IMAGENET1K_V1 = _w("googlenet-1378be20.pth", 69.778, 89.53, 6624904, 1.498)
    DEFAULT = IMAGENET1K_V1


@register_model()
def googlenet(*, weights: Optional[GoogLeNet_Weights] = None,
              device: Device = None, seed: int = 0, **kwargs: Any) -> GoogLeNet:
    weights = GoogLeNet_Weights.verify(weights)
    if weights is not None:
        kwargs.setdefault("transform_input", True)
    hook = None if kwargs.get("aux_logits") else _checkpoint_hook
    return build(lambda: GoogLeNet(**kwargs), init_weights, weights, device,
                 seed, hook)
