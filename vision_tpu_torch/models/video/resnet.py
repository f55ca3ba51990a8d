"""Video ResNets (counterpart of ``vision_tpu/models/video/resnet.py``):
r3d_18 (3-D convolutions), mc3_18 (3-D, then spatial-only), r2plus1d_18
((2+1)-D: a spatial then a temporal convolution).

Input ``[N, C, T, H, W]``; torchvision's names (``stem.{0,1,3,4}``,
``layer{i}.{j}.conv{1,2}.{0,1}``, (2+1)-D ``conv{1,2}.0.{0,1,3}``,
``downsample.{0,1}``, ``fc``). Batch norm is
:class:`vision_tpu_torch.ops.misc.BatchNorm3d` (flax's arithmetic, eps
1e-5, torch momentum 0.1).
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from vision_tpu_torch.models._api import WeightsEnum, register_model
from vision_tpu_torch.models._utils import (
    Device,
    build,
    fan_out_normal_,
    init_norms,
    normal_,
)
from vision_tpu_torch.models.video._utils import video_weights
from vision_tpu_torch.ops.misc import BatchNorm3d

__all__ = [
    "MC3_18_Weights",
    "R2Plus1D_18_Weights",
    "R3D_18_Weights",
    "VideoResNet",
    "mc3_18",
    "r2plus1d_18",
    "r3d_18",
]


def _conv3d(cin: int, cout: int, kernel, stride) -> nn.Conv3d:
    return nn.Conv3d(cin, cout, kernel, stride,
                     tuple((k - 1) // 2 for k in kernel), bias=False)


def _midplanes(inp: int, planes: int) -> int:
    return (inp * planes * 3 * 3 * 3) // (inp * 3 * 3 + 3 * planes)


def _conv(kind: str, cin: int, cout: int, mid: int, stride: int) -> nn.Module:
    if kind == "3d":
        return _conv3d(cin, cout, (3, 3, 3), (stride,) * 3)
    if kind == "no_temporal":
        return _conv3d(cin, cout, (1, 3, 3), (1, stride, stride))
    return nn.Sequential(  # (2+1)-D
        _conv3d(cin, mid, (1, 3, 3), (1, stride, stride)), BatchNorm3d(mid),
        nn.ReLU(), _conv3d(mid, cout, (3, 1, 1), (stride, 1, 1)))


class BasicBlock(nn.Module):
    """Two convolutions of ``kind`` with batch norm; a 1x1x1 downsample
    where the shape changes. The (2+1)-D convolutions' middle width comes
    from the block's (inplanes, planes), for both."""

    def __init__(self, kind: str, inplanes: int, planes: int, stride: int = 1,
                 downsample: bool = False):
        super().__init__()
        mid = _midplanes(inplanes, planes)
        self.conv1 = nn.Sequential(_conv(kind, inplanes, planes, mid, stride),
                                   BatchNorm3d(planes), nn.ReLU())
        self.conv2 = nn.Sequential(_conv(kind, planes, planes, mid, 1),
                                   BatchNorm3d(planes))
        ds = (1, stride, stride) if kind == "no_temporal" else (stride,) * 3
        self.downsample = (nn.Sequential(
            nn.Conv3d(inplanes, planes, 1, ds, bias=False), BatchNorm3d(planes))
            if downsample else None)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = self.conv2(self.conv1(x))
        identity = x if self.downsample is None else self.downsample(x)
        return F.relu(out + identity)


class VideoResNet(nn.Module):
    """``forward(x, return_features=True)`` also returns the stem's and
    each stage's output under ``stem`` and ``layer1`` .. ``layer4``."""

    def __init__(self, conv_makers: Sequence[str],
                 layers: Sequence[int] = (2, 2, 2, 2),
                 stem_type: str = "basic", num_classes: int = 400):
        super().__init__()
        if stem_type == "basic":
            self.stem = nn.Sequential(
                _conv3d(3, 64, (3, 7, 7), (1, 2, 2)), BatchNorm3d(64),
                nn.ReLU())
        else:
            self.stem = nn.Sequential(
                _conv3d(3, 45, (1, 7, 7), (1, 2, 2)), BatchNorm3d(45),
                nn.ReLU(), _conv3d(45, 64, (3, 1, 1), (1, 1, 1)),
                BatchNorm3d(64), nn.ReLU())
        inplanes = 64
        for i, (planes, blocks, kind) in enumerate(
                zip((64, 128, 256, 512), layers, conv_makers)):
            stride = 1 if i == 0 else 2
            stage: List[nn.Module] = []
            for j in range(blocks):
                stage.append(BasicBlock(
                    kind, inplanes, planes, stride if j == 0 else 1,
                    j == 0 and (stride != 1 or inplanes != planes)))
                inplanes = planes
            self.add_module(f"layer{i + 1}", nn.Sequential(*stage))
        self.fc = nn.Linear(512, num_classes)

    def forward(self, x: torch.Tensor, return_features: bool = False,
                generator: Optional[torch.Generator] = None):
        x = self.stem(x)
        features: Dict[str, torch.Tensor] = {"stem": x}
        for name in ("layer1", "layer2", "layer3", "layer4"):
            x = getattr(self, name)(x)
            features[name] = x
        logits = self.fc(x.mean((-3, -2, -1)))
        if return_features:
            return logits, features
        return logits


@torch.no_grad()
def init_weights(model: nn.Module, generator: torch.Generator) -> None:
    """torchvision's: convolutions He-normal over the fan out, the Linear
    normal of std 0.01 with zero bias, norms identity."""
    init_norms(model)
    for m in model.modules():
        if isinstance(m, nn.Conv3d):
            fan_out_normal_(m.weight, generator)
        elif isinstance(m, nn.Linear):
            normal_(m.weight, 0.01, generator)
            m.bias.zero_()


def _w(file, acc1, acc5, num_params, ops):
    return video_weights(file, acc1, acc5, num_params, ops, crop=(112, 112),
                         resize=(128, 171))


class R3D_18_Weights(WeightsEnum):
    KINETICS400_V1 = _w("r3d_18-b3b3357e.pth", 63.200, 83.479, 33371472,
                        40.697)
    DEFAULT = KINETICS400_V1


class MC3_18_Weights(WeightsEnum):
    KINETICS400_V1 = _w("mc3_18-a90a0ba3.pth", 63.960, 84.130, 11695440,
                        43.343)
    DEFAULT = KINETICS400_V1


class R2Plus1D_18_Weights(WeightsEnum):
    KINETICS400_V1 = _w("r2plus1d_18-91a641e6.pth", 67.463, 86.175, 31505325,
                        40.519)
    DEFAULT = KINETICS400_V1


def _video_resnet(conv_makers, stem, weights, device: Device, seed: int,
                  **kwargs: Any) -> VideoResNet:
    return build(lambda: VideoResNet(conv_makers, stem_type=stem, **kwargs),
                 init_weights, weights, device, seed)


@register_model()
def r3d_18(*, weights: Optional[R3D_18_Weights] = None, device: Device = None,
           seed: int = 0, **kwargs: Any) -> VideoResNet:
    return _video_resnet(("3d",) * 4, "basic", R3D_18_Weights.verify(weights),
                         device, seed, **kwargs)


@register_model()
def mc3_18(*, weights: Optional[MC3_18_Weights] = None, device: Device = None,
           seed: int = 0, **kwargs: Any) -> VideoResNet:
    return _video_resnet(("3d",) + ("no_temporal",) * 3, "basic",
                         MC3_18_Weights.verify(weights), device, seed, **kwargs)


@register_model()
def r2plus1d_18(*, weights: Optional[R2Plus1D_18_Weights] = None,
                device: Device = None, seed: int = 0,
                **kwargs: Any) -> VideoResNet:
    return _video_resnet(("2plus1d",) * 4, "r2plus1d",
                         R2Plus1D_18_Weights.verify(weights), device, seed,
                         **kwargs)
