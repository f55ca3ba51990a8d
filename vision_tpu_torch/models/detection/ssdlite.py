"""SSDlite320-MobileNetV3-Large (counterpart of
``vision_tpu/models/detection/ssdlite.py``).

``SSDLiteFeatureExtractor``: MobileNetV3-Large with the reduced tail
(``_large_setting(reduced_tail=True)``), split at the C4 block's expansion:
``features.0`` (a ReLU6 stem, blocks 0-11 and the C4 block's 1x1
expansion, 672 channels at stride 16) and ``features.1`` (the rest of the
C4 block, blocks 13-14 and the last 1x1 convolution, 480 channels at
stride 32), then four extra blocks (1x1 to half, a depthwise 3x3 of stride
2, 1x1 out; ReLU6 throughout) of 512, 256, 256 and 128 channels: six maps,
20x20 to 1x1 at 320 px. Every batch norm is live, eps 1e-3 and momentum
0.03 (flax's 0.97), as the JAX package's is. ``SSDLiteHead``: a depthwise
3x3 CNA (ReLU6) and a 1x1 convolution a map, for the classes and for the
boxes. Six default boxes a location (ratios 2 and 3, scales 0.2 to 0.95).

Matching is ``Matcher(0.5, 0.5)`` with low-quality matches, not
``SSDMatcher``; postprocessing and the loss are SSD's
(``ssd.SSD.postprocess_detections``, ``compute_loss``), with SSD's
defaults in the class and, as in the JAX package, the builder's own:
``score_thresh`` 0.001, NMS at 0.55, 300 candidates a class (27,000 an
image) and 300 detections.

Names are torchvision's: the C4 block's depthwise, squeeze-excitation and
projection under ``backbone.features.1.0.{1,2,3}``, as torchvision's slice
of that block keeps them (the JAX package numbers them from 0; the JAX
converter maps them through ``jax_names``).

Training mode updates the running statistics of every batch norm (f32,
also in the amp step); ``zoo.to_bf16`` keeps them f32 for a bf16 request.
"""

from __future__ import annotations

import functools
import math
from typing import List, Optional, Union

import torch
import torch.nn.functional as F
from torch import nn

from vision_tpu_torch.models._api import Weights, WeightsEnum, register_model
from vision_tpu_torch.models._utils import _make_divisible
from vision_tpu_torch.models.detection._utils import Matcher
from vision_tpu_torch.models.detection.anchor_utils import DefaultBoxGenerator
from vision_tpu_torch.models.detection.backbone_utils import freeze_layers_before
from vision_tpu_torch.models.detection.faster_rcnn import build_detector
from vision_tpu_torch.models.detection.ssd import SSD, SSDHead
from vision_tpu_torch.models.mobilenetv3 import (
    InvertedResidual,
    _cna,
    _large_setting,
)
from vision_tpu_torch.ops.misc import BatchNorm2d, SqueezeExcitation
from vision_tpu_torch.transforms._presets import ObjectDetection

__all__ = ["SSDLite", "SSDLite320_MobileNet_V3_Large_Weights",
           "SSDLiteFeatureExtractor", "ssdlite320_mobilenet_v3_large"]

_NORM = functools.partial(BatchNorm2d, eps=1e-3, momentum=0.03)
# the C4 block: the 13th of the setting, features.13 of MobileNetV3
_C4 = 12


class _ReLU6(nn.Module):
    """``min(relu(x), 6)``, the JAX package's ReLU6, through ``F.relu``."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.relu(x).clamp(max=6.0)


def _lite_cna(cin: int, cout: int, kernel: int = 1, stride: int = 1,
              groups: int = 1) -> nn.Module:
    return _cna(cin, cout, kernel, stride, groups=groups, act=_ReLU6,
                norm_layer=_NORM)


class _C4Rest(nn.Sequential):
    """The C4 block after its expansion: the depthwise CNA, the
    squeeze-excitation and the projection, children ``1``, ``2``, ``3``
    (torchvision's slice of the block keeps the block's own indices)."""

    jax_names = {"0": "1", "1": "2", "2": "3"}

    def __init__(self, cnf):
        e = cnf.expanded_channels
        super().__init__()
        self.add_module("1", _cna(e, e, cnf.kernel, cnf.stride, groups=e,
                                  norm_layer=_NORM))
        self.add_module("2", SqueezeExcitation(
            e, _make_divisible(e // 4, 8), scale_activation=nn.Hardsigmoid))
        self.add_module("3", _cna(e, cnf.out_channels, 1, act=None,
                                  norm_layer=_NORM))


class SSDLiteFeatureExtractor(nn.Module):
    """The six maps of SSDlite320 (module docstring)."""

    def __init__(self):
        super().__init__()
        setting, _ = _large_setting(reduced_tail=True)
        c4 = setting[_C4]
        last = 6 * setting[-1].out_channels
        self.features = nn.Sequential(
            nn.Sequential(
                _lite_cna(3, setting[0].input_channels, 3, 2),
                *[InvertedResidual(c, _NORM) for c in setting[:_C4]],
                _cna(c4.input_channels, c4.expanded_channels, 1,
                     norm_layer=_NORM)),
            nn.Sequential(
                _C4Rest(c4),
                *[InvertedResidual(c, _NORM) for c in setting[_C4 + 1:]],
                _cna(setting[-1].out_channels, last, 1, norm_layer=_NORM)))
        extra, cin = [], last
        for cout in (512, 256, 256, 128):
            mid = cout // 2
            extra.append(nn.Sequential(_lite_cna(cin, mid),
                                       _lite_cna(mid, mid, 3, 2, groups=mid),
                                       _lite_cna(mid, cout)))
            cin = cout
        self.extra = nn.ModuleList(extra)
        self.out_channels = [c4.expanded_channels, last, 512, 256, 256, 128]

    def forward(self, x: torch.Tensor) -> List[torch.Tensor]:
        out = []
        for block in (*self.features, *self.extra):
            x = block(x)
            out.append(x)
        return out

    def trunk_layers(self) -> List[nn.Module]:
        """MobileNetV3's 17 layers in its own order (the C4 block as its
        two halves together), as torchvision counts its stages."""
        first, rest = self.features
        return [*first[:_C4 + 1], nn.ModuleList([first[_C4 + 1], rest[0]]),
                *rest[1:]]


class SSDLite(SSD):
    """SSDlite320-MobileNetV3-Large on a 320x320 normalised batch."""

    def __init__(
        self,
        num_classes: int = 91,
        score_thresh: float = 0.01,
        nms_thresh: float = 0.45,
        detections_per_img: int = 200,
        topk_candidates: int = 400,
        iou_thresh: float = 0.5,
        neg_to_pos_ratio: int = 3,
    ):
        nn.Module.__init__(self)
        self.backbone = SSDLiteFeatureExtractor()
        self.anchor_generator = DefaultBoxGenerator(
            [[2, 3]] * 6, min_ratio=0.2, max_ratio=0.95)
        self.head = SSDHead(
            self.backbone.out_channels,
            self.anchor_generator.num_anchors_per_location(), num_classes,
            make_predictor=lambda cin, cout: nn.Sequential(
                _lite_cna(cin, cin, 3, groups=cin), nn.Conv2d(cin, cout, 1)))
        self.proposal_matcher = Matcher(iou_thresh, iou_thresh,
                                        allow_low_quality_matches=True)
        self._setup(num_classes, score_thresh, nms_thresh, detections_per_img,
                    topk_candidates, neg_to_pos_ratio)


@torch.no_grad()
def init_ssdlite_weights(model: SSDLite, generator: torch.Generator) -> None:
    """torchvision's initialisation, drawn from ``generator``: the
    MobileNetV3 trunk's convolutions He-normal over the fan out, the extra
    blocks' and the head's N(0, 0.03), all biases zero; batch norms
    identity."""
    for name, m in model.named_modules():
        if isinstance(m, nn.Conv2d):
            if name.startswith("backbone.features"):
                fan_out = m.weight.shape[0] * m.weight[0, 0].numel()
                m.weight.normal_(0.0, math.sqrt(2.0 / fan_out),
                                 generator=generator)
            else:
                m.weight.normal_(0.0, 0.03, generator=generator)
            if m.bias is not None:
                m.bias.zero_()
        elif isinstance(m, BatchNorm2d):
            m.weight.fill_(1.0)
            m.bias.zero_()
            m.running_mean.zero_()
            m.running_var.fill_(1.0)


class SSDLite320_MobileNet_V3_Large_Weights(WeightsEnum):
    COCO_V1 = Weights(
        url="https://download.pytorch.org/models/"
        "ssdlite320_mobilenet_v3_large_coco-a79551df.pth",
        transforms=ObjectDetection,
        meta={"num_params": 3440060,
              "_metrics": {"COCO-val2017": {"box_map": 21.3}}},
    )
    DEFAULT = COCO_V1


# MobileNetV3's stages as torchvision's ``_mobilenet_extractor`` counts
# them: the stem, the first block of each strided stage, the last conv
_MOBILENET_STAGE_STARTS = (0, 2, 4, 7, 13, 16)


def _freeze_mobilenet(model: SSDLite, trainable_layers: int) -> None:
    """torchvision's rule for the split MobileNetV3 trunk (0-6 stages)."""
    freeze_layers_before(model.backbone.trunk_layers(), _MOBILENET_STAGE_STARTS,
                         trainable_layers)


@register_model()
def ssdlite320_mobilenet_v3_large(
    *,
    weights: Optional[Union[SSDLite320_MobileNet_V3_Large_Weights, Weights,
                            str]] = None,
    device: Union[str, torch.device, None] = None,
    seed: int = 0,
    trainable_backbone_layers: Optional[int] = None,
    **kwargs,
) -> SSDLite:
    """SSDlite320-MobileNetV3-Large with the reduced tail
    (``faster_rcnn.build_detector``): score threshold 0.001, NMS at 0.55,
    300 candidates a class and 300 detections unless given."""
    kwargs.setdefault("score_thresh", 0.001)
    kwargs.setdefault("nms_thresh", 0.55)
    kwargs.setdefault("detections_per_img", 300)
    kwargs.setdefault("topk_candidates", 300)
    return build_detector(SSDLite, weights, SSDLite320_MobileNet_V3_Large_Weights,
                          device, seed, trainable_backbone_layers,
                          init=init_ssdlite_weights, upgrade=dict,
                          freeze=_freeze_mobilenet, **kwargs)
