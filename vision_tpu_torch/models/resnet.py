"""ResNet family (counterpart of ``vision_tpu/models/resnet.py``):
resnet18/34/50/101/152, resnext50_32x4d/101_32x8d/101_64x4d,
wide_resnet50_2/101_2.

NCHW input; module and state-dict names are torchvision's
(``layer1.0.conv1.weight`` ...), so torchvision checkpoints load as they
are. Batch norm is :class:`vision_tpu_torch.ops.misc.BatchNorm2d`, which
follows the JAX package's arithmetic.

``fused_bn=True`` sends the training-mode calls of every ``Bottleneck``
through :func:`vision_tpu_torch.ops._conv1x1_bn.matmul_stats`: the 1x1
convolutions are matrix products over channels-last rows whose batch-norm
statistics come from the product's epilogue, and bn2's normalise+ReLU is
folded into conv3's input read. The parameters and buffers are the same
as on the standard path, which eval-mode calls always take.
"""

from __future__ import annotations

import functools
import math
from typing import Any, Dict, List, Optional, Sequence, Type, Union

import torch
import torch.nn.functional as F
from torch import nn

from vision_tpu_torch.models._api import (
    Weights,
    WeightsEnum,
    register_model,
    resolve_device,
)
from vision_tpu_torch.ops import _conv1x1_bn
from vision_tpu_torch.ops.misc import BatchNorm2d, batch_mean_var
from vision_tpu_torch.transforms._presets import ImageClassification

__all__ = [
    "BasicBlock",
    "Bottleneck",
    "ResNet",
    "ResNet18_Weights",
    "ResNet34_Weights",
    "ResNet50_Weights",
    "ResNet101_Weights",
    "ResNet152_Weights",
    "ResNeXt50_32X4D_Weights",
    "ResNeXt101_32X8D_Weights",
    "ResNeXt101_64X4D_Weights",
    "Wide_ResNet50_2_Weights",
    "Wide_ResNet101_2_Weights",
    "init_weights",
    "resnet18",
    "resnet34",
    "resnet50",
    "resnet101",
    "resnet152",
    "resnext50_32x4d",
    "resnext101_32x8d",
    "resnext101_64x4d",
    "wide_resnet50_2",
    "wide_resnet101_2",
]


def _conv(cin: int, cout: int, kernel: int, stride: int = 1, groups: int = 1,
          dilation: int = 1) -> nn.Conv2d:
    pad = dilation * (kernel - 1) // 2
    return nn.Conv2d(cin, cout, kernel, stride, padding=pad, dilation=dilation,
                     groups=groups, bias=False)


def _downsample(cin: int, cout: int, stride: int) -> nn.Sequential:
    return nn.Sequential(_conv(cin, cout, 1, stride), BatchNorm2d(cout))


class BasicBlock(nn.Module):
    """Two 3x3 convs; expansion 1. ``fused_bn`` is accepted and ignored: the
    block has no 1x1 conv on its main branch to fuse."""

    expansion = 1

    def __init__(self, inplanes: int, planes: int, stride: int = 1,
                 downsample: bool = False, groups: int = 1,
                 base_width: int = 64, dilation: int = 1,
                 fused_bn: bool = False):
        super().__init__()
        self.conv1 = _conv(inplanes, planes, 3, stride, dilation=dilation)
        self.bn1 = BatchNorm2d(planes)
        self.conv2 = _conv(planes, planes, 3, dilation=dilation)
        self.bn2 = BatchNorm2d(planes)
        self.downsample = (
            _downsample(inplanes, planes, stride) if downsample else None
        )

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = F.relu(self.bn1(self.conv1(x)))
        out = self.bn2(self.conv2(out))
        identity = x if self.downsample is None else self.downsample(x)
        return F.relu(out + identity)


def _rows(x: torch.Tensor) -> torch.Tensor:
    """NCHW ``x`` as ``[N*H*W, C]`` rows: a view when ``x`` is
    channels-last in memory, a copy otherwise."""
    return x.permute(0, 2, 3, 1).reshape(-1, x.shape[1])


def _matrix(conv: nn.Conv2d) -> torch.Tensor:
    """The 1x1 conv's ``[out, in, 1, 1]`` weight as the ``[K, N]`` matrix
    of the product: a transposed view, which ``matmul_stats`` reads where
    it lies."""
    return conv.weight.flatten(1).t()


def _mean_var(s1: torch.Tensor, s2: torch.Tensor, count: int):
    mean = s1 / count
    return mean, (s2 / count - mean * mean).clamp(min=0.0)


class Bottleneck(nn.Module):
    """1x1, 3x3, 1x1 convs; expansion 4; the stride on the 3x3 conv
    (ResNet v1.5)."""

    expansion = 4

    def __init__(self, inplanes: int, planes: int, stride: int = 1,
                 downsample: bool = False, groups: int = 1,
                 base_width: int = 64, dilation: int = 1,
                 fused_bn: bool = False):
        super().__init__()
        width = int(planes * (base_width / 64.0)) * groups
        cout = planes * self.expansion
        self.conv1 = _conv(inplanes, width, 1)
        self.bn1 = BatchNorm2d(width)
        self.conv2 = _conv(width, width, 3, stride, groups, dilation)
        self.bn2 = BatchNorm2d(width)
        self.conv3 = _conv(width, cout, 1)
        self.bn3 = BatchNorm2d(cout)
        self.downsample = (
            _downsample(inplanes, cout, stride) if downsample else None
        )
        self.stride = stride
        self.fused_bn = fused_bn

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.fused_bn and self.training:
            return self._fused_train(x)
        out = F.relu(self.bn1(self.conv1(x)))
        out = F.relu(self.bn2(self.conv2(out)))
        out = self.bn3(self.conv3(out))
        identity = x if self.downsample is None else self.downsample(x)
        return F.relu(out + identity)

    def _fused_train(self, x: torch.Tensor) -> torch.Tensor:
        """``vision_tpu/models/resnet.py:Bottleneck._fused_train`` on
        channels-last rows. Returns an NCHW tensor that is channels-last in
        memory, so the next block's rows are a view."""
        matmul_stats = _conv1x1_bn.matmul_stats
        b, cin, h, w_ = x.shape
        x = x.contiguous(memory_format=torch.channels_last)
        xf = _rows(x)

        y1, a1, b1 = matmul_stats(xf, _matrix(self.conv1))
        inv1, sh1 = self.bn1.affine_from_stats(*_mean_var(a1, b1, y1.shape[0]))
        odt = torch.promote_types(y1.dtype, self.bn1.weight.dtype)
        y1n = F.relu(y1.float() * inv1 + sh1).to(odt)

        y2 = self.conv2(y1n.reshape(b, h, w_, -1).permute(0, 3, 1, 2))
        # bn2's statistics in one pass over the 3x3 output; its
        # normalise+ReLU is not materialised: it rides conv3's prologue
        inv2, sh2 = self.bn2.affine_from_stats(*batch_mean_var(y2))

        h2, w2 = y2.shape[2:]
        y3, a3, b3 = matmul_stats(_rows(y2), _matrix(self.conv3), inv2, sh2)
        inv3, sh3 = self.bn3.affine_from_stats(*_mean_var(a3, b3, y3.shape[0]))

        if self.downsample is not None:
            conv_d, bn_d = self.downsample[0], self.downsample[1]
            xd = _rows(x[:, :, :: self.stride, :: self.stride])  # a copy
            yd, ad, bd = matmul_stats(xd, _matrix(conv_d))
            invd, shd = bn_d.affine_from_stats(*_mean_var(ad, bd, yd.shape[0]))
            idn = yd.float() * invd + shd
        else:
            idn = xf.float()

        out = F.relu(y3.float() * inv3 + sh3 + idn).to(odt)
        return out.reshape(b, h2, w2, -1).permute(0, 3, 1, 2)


class ResNet(nn.Module):
    """torchvision's ``ResNet``. ``forward(x, return_features=True)`` also
    returns the four stage outputs under ``layer1`` .. ``layer4``."""

    def __init__(
        self,
        block: Type[Union[BasicBlock, Bottleneck]],
        layers: Sequence[int],
        num_classes: int = 1000,
        groups: int = 1,
        width_per_group: int = 64,
        replace_stride_with_dilation: Sequence[bool] = (False, False, False),
        fused_bn: bool = False,
    ):
        super().__init__()
        if len(replace_stride_with_dilation) != 3:
            raise ValueError("replace_stride_with_dilation takes 3 flags, got "
                             f"{replace_stride_with_dilation}")
        self.fused_bn = fused_bn
        self.conv1 = nn.Conv2d(3, 64, 7, 2, padding=3, bias=False)
        self.bn1 = BatchNorm2d(64)
        inplanes, dilation = 64, 1
        for i, (planes, blocks) in enumerate(zip((64, 128, 256, 512), layers)):
            stride = 1 if i == 0 else 2
            prev_dilation = dilation
            if i > 0 and replace_stride_with_dilation[i - 1]:
                dilation *= stride
                stride = 1
            needs_ds = stride != 1 or inplanes != planes * block.expansion
            stage = [block(inplanes, planes, stride, needs_ds, groups,
                           width_per_group, prev_dilation, fused_bn)]
            inplanes = planes * block.expansion
            stage += [block(inplanes, planes, groups=groups,
                            base_width=width_per_group, dilation=dilation,
                            fused_bn=fused_bn)
                      for _ in range(1, blocks)]
            self.add_module(f"layer{i + 1}", nn.Sequential(*stage))
        self.fc = nn.Linear(inplanes, num_classes)

    def forward(self, x: torch.Tensor, return_features: bool = False):
        if self.fused_bn and self.training:
            # the fused blocks read channels-last rows: start that way, so
            # the stem's output needs no transpose
            x = x.contiguous(memory_format=torch.channels_last)
        x = F.relu(self.bn1(self.conv1(x)))
        x = F.max_pool2d(x, 3, 2, 1)
        features: Dict[str, torch.Tensor] = {}
        for name in ("layer1", "layer2", "layer3", "layer4"):
            x = getattr(self, name)(x)
            features[name] = x
        logits = self.fc(x.mean((2, 3)))  # global average pool
        if return_features:
            return logits, features
        return logits


@torch.no_grad()
def init_weights(model: ResNet, generator: torch.Generator) -> None:
    """torchvision's ResNet initialisation, drawn from ``generator``: convs
    He-normal over the fan out, ``fc`` PyTorch's default uniform; batch norm
    keeps weight 1, bias 0 and identity statistics."""
    for m in model.modules():
        if isinstance(m, nn.Conv2d):
            fan_out = m.weight.shape[0] * m.weight[0, 0].numel()
            m.weight.normal_(0.0, math.sqrt(2.0 / fan_out), generator=generator)
        elif isinstance(m, nn.Linear):
            bound = 1.0 / math.sqrt(m.in_features)
            m.weight.uniform_(-bound, bound, generator=generator)
            m.bias.uniform_(-bound, bound, generator=generator)


_COMMON_META = {"min_size": (1, 1), "categories": "imagenet-1k"}


def _cls_weights(url: str, crop: int, resize: int, metrics: Dict[str, float],
                 num_params: int, ops: float, file_size: float) -> Weights:
    return Weights(url=url, transforms=functools.partial(
        ImageClassification, crop_size=crop, resize_size=resize), meta={
        **_COMMON_META,
        "num_params": num_params,
        "recipe": "",
        "_metrics": {"ImageNet-1K": metrics},
        "_ops": ops,  # GMACs at 224x224
        "_file_size": file_size,  # checkpoint MB
    })


_URL = "https://download.pytorch.org/models/"


class ResNet18_Weights(WeightsEnum):
    IMAGENET1K_V1 = _cls_weights(
        _URL + "resnet18-f37072fd.pth", 224, 256,
        {"acc@1": 69.758, "acc@5": 89.078}, 11689512, 1.814, 44.661)
    DEFAULT = IMAGENET1K_V1


class ResNet34_Weights(WeightsEnum):
    IMAGENET1K_V1 = _cls_weights(
        _URL + "resnet34-b627a593.pth", 224, 256,
        {"acc@1": 73.314, "acc@5": 91.420}, 21797672, 3.664, 83.275)
    DEFAULT = IMAGENET1K_V1


class ResNet50_Weights(WeightsEnum):
    IMAGENET1K_V1 = _cls_weights(
        _URL + "resnet50-0676ba61.pth", 224, 256,
        {"acc@1": 76.130, "acc@5": 92.862}, 25557032, 4.089, 97.781)
    IMAGENET1K_V2 = _cls_weights(
        _URL + "resnet50-11ad3fa6.pth", 224, 232,
        {"acc@1": 80.858, "acc@5": 95.434}, 25557032, 4.089, 97.79)
    DEFAULT = IMAGENET1K_V2


class ResNet101_Weights(WeightsEnum):
    IMAGENET1K_V1 = _cls_weights(
        _URL + "resnet101-63fe2227.pth", 224, 256,
        {"acc@1": 77.374, "acc@5": 93.546}, 44549160, 7.801, 170.511)
    IMAGENET1K_V2 = _cls_weights(
        _URL + "resnet101-cd907fc2.pth", 224, 232,
        {"acc@1": 81.886, "acc@5": 95.780}, 44549160, 7.801, 170.53)
    DEFAULT = IMAGENET1K_V2


class ResNet152_Weights(WeightsEnum):
    IMAGENET1K_V1 = _cls_weights(
        _URL + "resnet152-394f9c45.pth", 224, 256,
        {"acc@1": 78.312, "acc@5": 94.046}, 60192808, 11.514, 230.434)
    IMAGENET1K_V2 = _cls_weights(
        _URL + "resnet152-f82ba261.pth", 224, 232,
        {"acc@1": 82.284, "acc@5": 96.002}, 60192808, 11.514, 230.474)
    DEFAULT = IMAGENET1K_V2


class ResNeXt50_32X4D_Weights(WeightsEnum):
    IMAGENET1K_V1 = _cls_weights(
        _URL + "resnext50_32x4d-7cdf4587.pth", 224, 256,
        {"acc@1": 77.618, "acc@5": 93.698}, 25028904, 4.23, 95.789)
    IMAGENET1K_V2 = _cls_weights(
        _URL + "resnext50_32x4d-1a0047aa.pth", 224, 232,
        {"acc@1": 81.198, "acc@5": 95.340}, 25028904, 4.23, 95.833)
    DEFAULT = IMAGENET1K_V2


class ResNeXt101_32X8D_Weights(WeightsEnum):
    IMAGENET1K_V1 = _cls_weights(
        _URL + "resnext101_32x8d-8ba56ff5.pth", 224, 256,
        {"acc@1": 79.312, "acc@5": 94.526}, 88791336, 16.414, 339.586)
    IMAGENET1K_V2 = _cls_weights(
        _URL + "resnext101_32x8d-110c445d.pth", 224, 232,
        {"acc@1": 82.834, "acc@5": 96.228}, 88791336, 16.414, 339.673)
    DEFAULT = IMAGENET1K_V2


class ResNeXt101_64X4D_Weights(WeightsEnum):
    IMAGENET1K_V1 = _cls_weights(
        _URL + "resnext101_64x4d-173b62eb.pth", 224, 232,
        {"acc@1": 83.246, "acc@5": 96.454}, 83455272, 15.46, 319.318)
    DEFAULT = IMAGENET1K_V1


class Wide_ResNet50_2_Weights(WeightsEnum):
    IMAGENET1K_V1 = _cls_weights(
        _URL + "wide_resnet50_2-95faca4d.pth", 224, 256,
        {"acc@1": 78.468, "acc@5": 94.086}, 68883240, 11.398, 131.82)
    IMAGENET1K_V2 = _cls_weights(
        _URL + "wide_resnet50_2-9ba9bcbe.pth", 224, 232,
        {"acc@1": 81.602, "acc@5": 95.758}, 68883240, 11.398, 263.124)
    DEFAULT = IMAGENET1K_V2


class Wide_ResNet101_2_Weights(WeightsEnum):
    IMAGENET1K_V1 = _cls_weights(
        _URL + "wide_resnet101_2-32ee1156.pth", 224, 256,
        {"acc@1": 78.848, "acc@5": 94.284}, 126886696, 22.753, 242.896)
    IMAGENET1K_V2 = _cls_weights(
        _URL + "wide_resnet101_2-d733dc28.pth", 224, 232,
        {"acc@1": 82.510, "acc@5": 96.020}, 126886696, 22.753, 484.747)
    DEFAULT = IMAGENET1K_V2


def _resnet(
    block: Type[nn.Module],
    layers: List[int],
    weights_enum: Type[WeightsEnum],
    weights: Any,
    device: Union[str, torch.device, None],
    seed: int,
    **kwargs: Any,
) -> ResNet:
    """The model in eval mode on ``device`` (the card when None; raises
    without one). Without ``weights`` the parameters are torchvision's
    initialisation drawn from a CPU ``torch.Generator`` seeded with
    ``seed``, so every device gets the same numbers."""
    device = resolve_device(device)
    weights = weights_enum.verify(weights)
    model = ResNet(block, layers, **kwargs)
    if weights is not None:
        model.load_state_dict(weights.get_state_dict())
    else:
        init_weights(model, torch.Generator().manual_seed(seed))
    return model.eval().to(device)


_Device = Union[str, torch.device, None]


@register_model()
def resnet18(*, weights: Optional[ResNet18_Weights] = None,
             device: _Device = None, seed: int = 0, **kwargs: Any) -> ResNet:
    return _resnet(BasicBlock, [2, 2, 2, 2], ResNet18_Weights, weights,
                   device, seed, **kwargs)


@register_model()
def resnet34(*, weights: Optional[ResNet34_Weights] = None,
             device: _Device = None, seed: int = 0, **kwargs: Any) -> ResNet:
    return _resnet(BasicBlock, [3, 4, 6, 3], ResNet34_Weights, weights,
                   device, seed, **kwargs)


@register_model()
def resnet50(*, weights: Optional[ResNet50_Weights] = None,
             device: _Device = None, seed: int = 0, **kwargs: Any) -> ResNet:
    return _resnet(Bottleneck, [3, 4, 6, 3], ResNet50_Weights, weights,
                   device, seed, **kwargs)


@register_model()
def resnet101(*, weights: Optional[ResNet101_Weights] = None,
              device: _Device = None, seed: int = 0, **kwargs: Any) -> ResNet:
    return _resnet(Bottleneck, [3, 4, 23, 3], ResNet101_Weights, weights,
                   device, seed, **kwargs)


@register_model()
def resnet152(*, weights: Optional[ResNet152_Weights] = None,
              device: _Device = None, seed: int = 0, **kwargs: Any) -> ResNet:
    return _resnet(Bottleneck, [3, 8, 36, 3], ResNet152_Weights, weights,
                   device, seed, **kwargs)


@register_model()
def resnext50_32x4d(*, weights: Optional[ResNeXt50_32X4D_Weights] = None,
                    device: _Device = None, seed: int = 0,
                    **kwargs: Any) -> ResNet:
    return _resnet(Bottleneck, [3, 4, 6, 3], ResNeXt50_32X4D_Weights, weights,
                   device, seed, groups=32, width_per_group=4, **kwargs)


@register_model()
def resnext101_32x8d(*, weights: Optional[ResNeXt101_32X8D_Weights] = None,
                     device: _Device = None, seed: int = 0,
                     **kwargs: Any) -> ResNet:
    return _resnet(Bottleneck, [3, 4, 23, 3], ResNeXt101_32X8D_Weights,
                   weights, device, seed, groups=32, width_per_group=8,
                   **kwargs)


@register_model()
def resnext101_64x4d(*, weights: Optional[ResNeXt101_64X4D_Weights] = None,
                     device: _Device = None, seed: int = 0,
                     **kwargs: Any) -> ResNet:
    return _resnet(Bottleneck, [3, 4, 23, 3], ResNeXt101_64X4D_Weights,
                   weights, device, seed, groups=64, width_per_group=4,
                   **kwargs)


@register_model()
def wide_resnet50_2(*, weights: Optional[Wide_ResNet50_2_Weights] = None,
                    device: _Device = None, seed: int = 0,
                    **kwargs: Any) -> ResNet:
    return _resnet(Bottleneck, [3, 4, 6, 3], Wide_ResNet50_2_Weights, weights,
                   device, seed, width_per_group=128, **kwargs)


@register_model()
def wide_resnet101_2(*, weights: Optional[Wide_ResNet101_2_Weights] = None,
                     device: _Device = None, seed: int = 0,
                     **kwargs: Any) -> ResNet:
    return _resnet(Bottleneck, [3, 4, 23, 3], Wide_ResNet101_2_Weights,
                   weights, device, seed, width_per_group=128, **kwargs)
