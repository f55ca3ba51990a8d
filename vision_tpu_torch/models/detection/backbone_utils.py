"""ResNet trunk + FPN, NCHW (counterpart of
``vision_tpu/models/detection/backbone_utils.py``): the v1 trunk with
frozen batch norm, or (``frozen_bn=False``, the v2 detectors) the
classification blocks of ``models/resnet.py`` with live, trainable batch
norm. Module names are torchvision's, so
``backbone.body.layer1.0.conv1.weight`` and the like load from a
torchvision checkpoint. ``deform_stages`` puts deformable 3x3
convolutions into the bottlenecks of the listed stages
(``DeformFrozenBottleneck``), as the JAX trunk does. The MobileNetV3-Large
FPN trunk of the MobileNet Faster R-CNNs is ``MobileNetV3FPNBackbone``
(``backbone.body.{0..16}``, torchvision's names)."""

from __future__ import annotations

from collections import OrderedDict
from typing import Callable, Dict, Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from vision_tpu_torch.models import resnet
from vision_tpu_torch.models.mobilenetv3 import (
    InvertedResidual,
    _cna,
    _large_setting,
)
from vision_tpu_torch.ops.deform_conv import DeformConv2d
from vision_tpu_torch.ops.feature_pyramid_network import (
    ExtraFPNBlock,
    FeaturePyramidNetwork,
    LastLevelMaxPool,
)
from vision_tpu_torch.ops.misc import BatchNorm2d, FrozenBatchNorm2d

__all__ = ["BackboneWithFPN", "DeformFrozenBottleneck", "FrozenBasicBlock",
           "FrozenBottleneck", "MobileNetV3FPNBackbone", "ResNetTrunk",
           "freeze_layers_before", "freeze_trunk_layers"]

# the trunk's stages from the last to the first, as torchvision's
# ``_resnet_fpn_extractor`` and the JAX recipe (``references/detection/
# train.py:60``) count the trainable ones
_STAGE_ORDER = ("layer4", "layer3", "layer2", "layer1", "conv1")


def _conv(cin: int, cout: int, k: int, stride: int = 1) -> nn.Conv2d:
    return nn.Conv2d(cin, cout, k, stride, padding=(k - 1) // 2, bias=False)


def _downsample(cin: int, cout: int, stride: int) -> nn.Sequential:
    return nn.Sequential(_conv(cin, cout, 1, stride), FrozenBatchNorm2d(cout))


class FrozenBasicBlock(nn.Module):
    expansion = 1

    def __init__(self, cin: int, planes: int, stride: int = 1,
                 downsample: bool = False):
        super().__init__()
        self.conv1 = _conv(cin, planes, 3, stride)
        self.bn1 = FrozenBatchNorm2d(planes)
        self.conv2 = _conv(planes, planes, 3)
        self.bn2 = FrozenBatchNorm2d(planes)
        self.downsample = _downsample(cin, planes, stride) if downsample else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = F.relu(self.bn1(self.conv1(x)))
        out = self.bn2(self.conv2(out))
        identity = x if self.downsample is None else self.downsample(x)
        return F.relu(out + identity)


class FrozenBottleneck(nn.Module):
    """Bottleneck with the stride on the 3x3 conv (ResNet v1.5)."""

    expansion = 4

    def __init__(self, cin: int, planes: int, stride: int = 1,
                 downsample: bool = False):
        super().__init__()
        self.conv1 = _conv(cin, planes, 1)
        self.bn1 = FrozenBatchNorm2d(planes)
        self.conv2 = _conv(planes, planes, 3, stride)
        self.bn2 = FrozenBatchNorm2d(planes)
        self.conv3 = _conv(planes, planes * 4, 1)
        self.bn3 = FrozenBatchNorm2d(planes * 4)
        self.downsample = (
            _downsample(cin, planes * 4, stride) if downsample else None
        )

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = F.relu(self.bn1(self.conv1(x)))
        out = F.relu(self.bn2(self.conv2(out)))
        out = self.bn3(self.conv3(out))
        identity = x if self.downsample is None else self.downsample(x)
        return F.relu(out + identity)


class DeformFrozenBottleneck(FrozenBottleneck):
    """``FrozenBottleneck`` with ``conv2`` a deformable 3x3 convolution
    (counterpart of ``_DeformFrozenBottleneck``, DCNv1, or DCNv2 with
    ``modulated``): ``conv2_offset``, a 3x3 convolution with a bias and the
    block's stride, predicts each tap's (dy, dx) (18 channels) and, when
    ``modulated``, 9 mask logits through a sigmoid (27 channels). The
    detectors' initialisation zeroes it, so that the block starts as the
    plain one (DCNv2: with its conv2 branch halved)."""

    def __init__(self, cin: int, planes: int, stride: int = 1,
                 downsample: bool = False, modulated: bool = False):
        super().__init__(cin, planes, stride, downsample)
        self.modulated = modulated
        self.conv2 = DeformConv2d(planes, planes, 3, stride, padding=1,
                                  bias=False)
        self.conv2_offset = nn.Conv2d(planes, (3 if modulated else 2) * 9, 3,
                                      stride, padding=1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = F.relu(self.bn1(self.conv1(x)))
        pred = self.conv2_offset(out)
        if self.modulated:
            offset, mask = pred[:, :18], torch.sigmoid(pred[:, 18:])
        else:
            offset, mask = pred, None
        out = F.relu(self.bn2(self.conv2(out, offset, mask)))
        out = self.bn3(self.conv3(out))
        identity = x if self.downsample is None else self.downsample(x)
        return F.relu(out + identity)


_DEPTHS = {18: (FrozenBasicBlock, (2, 2, 2, 2)),
           50: (FrozenBottleneck, (3, 4, 6, 3))}
# the live-BN (v2) trunk's blocks: the classification models' own
_LIVE_BLOCKS = {FrozenBasicBlock: resnet.BasicBlock,
                FrozenBottleneck: resnet.Bottleneck}


class ResNetTrunk(nn.Module):
    """ResNet body without the classifier, returning the four stage outputs
    under the keys "0".."3". ``deform_stages`` lists 1-based stage indices
    (2..4 = C3..C5) whose bottlenecks are ``DeformFrozenBottleneck``s, with
    ``deform_modulated`` (DCNv2). ``frozen_bn=False`` takes
    ``models/resnet.py``'s ``BasicBlock`` / ``Bottleneck`` and a live
    ``BatchNorm2d`` stem: batch statistics in training mode, updating the
    running ones, which eval mode uses (the frozen-BN path only for
    ``deform_stages``)."""

    def __init__(self, depth: int = 50, deform_stages: Sequence[int] = (),
                 deform_modulated: bool = False, frozen_bn: bool = True):
        super().__init__()
        block, layers = _DEPTHS[depth]
        if deform_stages and block is not FrozenBottleneck:
            raise ValueError("deform_stages requires a Bottleneck trunk")
        if deform_stages and not frozen_bn:
            raise ValueError("deform_stages requires the frozen-BN trunk")
        if not frozen_bn:
            block = _LIVE_BLOCKS[block]
        self.conv1 = nn.Conv2d(3, 64, 7, 2, padding=3, bias=False)
        self.bn1 = FrozenBatchNorm2d(64) if frozen_bn else BatchNorm2d(64)
        cin = 64
        for i, (planes, blocks) in enumerate(zip((64, 128, 256, 512), layers)):
            stride = 1 if i == 0 else 2
            stage = []
            deform = (i + 1) in deform_stages
            for j in range(blocks):
                s = stride if j == 0 else 1
                needs_ds = j == 0 and (s != 1 or cin != planes * block.expansion)
                stage.append(
                    DeformFrozenBottleneck(cin, planes, s, needs_ds,
                                           deform_modulated) if deform
                    else block(cin, planes, s, needs_ds))
                cin = planes * block.expansion
            self.add_module(f"layer{i + 1}", nn.Sequential(*stage))
        self.out_channels = [c * block.expansion for c in (64, 128, 256, 512)]

    def forward(self, x: torch.Tensor) -> Dict[str, torch.Tensor]:
        x = F.relu(self.bn1(self.conv1(x)))
        x = F.max_pool2d(x, 3, 2, 1)
        out = OrderedDict()
        for i in range(4):
            x = getattr(self, f"layer{i + 1}")(x)
            out[str(i)] = x
        return out


class BackboneWithFPN(nn.Module):
    """Trunk -> FPN over the stages of ``returned_layers`` (1-based, 1..4 =
    C2..C5), keyed "0", "1", ... in that order, then ``extra_blocks``
    (``LastLevelMaxPool`` unless given); children ``body`` and ``fpn`` as in
    torchvision. By default returns {"0", "1", "2", "3", "pool"} NCHW maps
    of ``out_channels``. ``deform_stages``, ``deform_modulated`` and
    ``frozen_bn`` go to the trunk, ``norm_layer`` to the FPN (the v2
    detectors')."""

    def __init__(self, depth: int = 50, out_channels: int = 256,
                 deform_stages: Sequence[int] = (),
                 deform_modulated: bool = False,
                 returned_layers: Sequence[int] = (1, 2, 3, 4),
                 extra_blocks: Optional[ExtraFPNBlock] = None,
                 frozen_bn: bool = True,
                 norm_layer: Optional[Callable[..., nn.Module]] = None):
        super().__init__()
        self.body = ResNetTrunk(depth, deform_stages, deform_modulated,
                                frozen_bn)
        self.returned_layers = tuple(returned_layers)
        self.fpn = FeaturePyramidNetwork(
            [self.body.out_channels[i - 1] for i in self.returned_layers],
            out_channels, extra_blocks, norm_layer)
        self.out_channels = out_channels

    def forward(self, x: torch.Tensor) -> Dict[str, torch.Tensor]:
        feats = self.body(x)
        return self.fpn(OrderedDict(
            (str(i), feats[str(layer - 1)])
            for i, layer in enumerate(self.returned_layers)))


class MobileNetV3FPNBackbone(nn.Module):
    """MobileNetV3-Large's features with frozen batch norm (``body``, an
    ``nn.Sequential`` of the stem, the 15 blocks and the last 1x1
    convolution: ``body.0`` .. ``body.16``), tapped after ``body.13`` (160
    channels) as "0" and after ``body.16`` (960 channels) as "1", both at
    stride 32 (``body.13`` is the last strided block), then an FPN of
    ``out_channels`` with ``LastLevelMaxPool``: {"0", "1", "pool"}."""

    taps = {13: "0", 16: "1"}
    # the first block of each stage (torchvision's ``_is_cn`` blocks, the
    # strided ones), then the last convolution: where freezing may stop
    stage_starts = (0, 2, 4, 7, 13, 16)

    def __init__(self, out_channels: int = 256):
        super().__init__()
        setting, _ = _large_setting()
        layers = [_cna(3, setting[0].input_channels, 3, 2,
                       norm_layer=FrozenBatchNorm2d)]
        layers += [InvertedResidual(c, norm_layer=FrozenBatchNorm2d)
                   for c in setting]
        layers.append(_cna(setting[-1].out_channels, 6 * setting[-1].out_channels,
                           1, norm_layer=FrozenBatchNorm2d))
        self.body = nn.Sequential(*layers)
        self.fpn = FeaturePyramidNetwork(
            [setting[12].out_channels, 6 * setting[-1].out_channels],
            out_channels, LastLevelMaxPool())
        self.out_channels = out_channels

    def forward(self, x: torch.Tensor) -> Dict[str, torch.Tensor]:
        taps = OrderedDict()
        for i, layer in enumerate(self.body):
            x = layer(x)
            if i in self.taps:
                taps[self.taps[i]] = x
        return self.fpn(taps)


def freeze_layers_before(layers: Sequence[nn.Module], starts: Sequence[int],
                         trainable_layers: int) -> None:
    """torchvision's rule for the MobileNet and VGG trunks: of ``layers``
    (the trunk's modules in order, its stages beginning at ``starts``),
    train only the last ``trainable_layers`` stages (0 .. len(starts)):
    every parameter of the layers before the first of them gets
    ``requires_grad_(False)``, all of them at 0."""
    if not 0 <= trainable_layers <= len(starts):
        raise ValueError(f"trainable_layers must be in [0, {len(starts)}], "
                         f"got {trainable_layers}")
    before = (len(layers) if trainable_layers == 0
              else starts[len(starts) - trainable_layers])
    for layer in list(layers)[:before]:
        for p in layer.parameters():
            p.requires_grad_(False)


def freeze_trunk_layers(trunk: ResNetTrunk, trainable_layers: int) -> None:
    """Train only the last ``trainable_layers`` (0-5) stages of ``trunk``
    in the order ``layer4, layer3, layer2, layer1, conv1``: the parameters
    of every other stage get ``requires_grad_(False)``. The frozen batch
    norms hold no parameters; a live one's weight and bias freeze with its
    stage, and the stem's ``bn1`` with none, as the JAX recipe's update mask
    has it. A live batch norm's running statistics are not parameters:
    every stage updates them in training mode."""
    if not 0 <= trainable_layers <= len(_STAGE_ORDER):
        raise ValueError("trainable_layers must be in [0, 5], got "
                         f"{trainable_layers}")
    train = _STAGE_ORDER[:trainable_layers]
    for name, p in trunk.named_parameters():
        p.requires_grad_(name.split(".")[0] in train)
