"""Pieces shared by the segmentation builders: the checkpoint entry, the
initialisation, the upsampling of each head's logits to the input size and
the trunk-and-heads model of FCN and DeepLabV3."""

from __future__ import annotations

import functools
from typing import Dict, Optional

import torch
from torch import nn

from vision_tpu_torch.models._api import Weights
from vision_tpu_torch.models._utils import (
    default_,
    fan_out_normal_,
    init_norms,
    zero_bias_,
)
from vision_tpu_torch.transforms._presets import SemanticSegmentation
from vision_tpu_torch.transforms.v2.functional._resample import resize_2d

__all__ = ["SimpleSegmentationModel", "init_weights", "seg_weights",
           "upsample"]

_URL = "https://download.pytorch.org/models/"


def seg_weights(file: str, miou: float, pixel_acc: float, num_params: int,
                ops: float) -> Weights:
    """A COCO (VOC labels) checkpoint under torchvision's URL: its mIoU and
    pixel accuracy, parameter count (the JAX model's: its auxiliary head
    always built), GMACs a sample at 520x520 (``_ops``) and its
    ``SemanticSegmentation`` preset (shorter edge 520)."""
    return Weights(url=_URL + file, transforms=functools.partial(
        SemanticSegmentation, resize_size=520), meta={
        "num_params": num_params, "_ops": ops,
        "_metrics": {"COCO-val2017-VOC-labels": {"miou": miou,
                                                 "pixel_acc": pixel_acc}},
    })


@torch.no_grad()
def init_weights(model: nn.Module, generator: torch.Generator) -> None:
    """torchvision's: the trunk's convolutions He-normal over the fan out
    with zero bias (its classifier's initialisation), the heads' PyTorch's
    default; norms identity."""
    init_norms(model)
    for name, m in model.named_modules():
        if isinstance(m, nn.Conv2d):
            if name.startswith("backbone."):
                fan_out_normal_(m.weight, generator)
                zero_bias_(m)
            else:
                default_(m, generator)


def upsample(logits: Dict[str, torch.Tensor], size) -> Dict[str, torch.Tensor]:
    """Each head's logits resized to the input's ``(H, W)``: bilinear, not
    antialiased, as the JAX models resize them."""
    return {k: resize_2d(v, tuple(size), mode="bilinear", antialias=False)
            for k, v in logits.items()}


class SimpleSegmentationModel(nn.Module):
    """``backbone`` (a dict of maps), ``classifier`` on its ``out`` map and
    ``aux_classifier`` on its ``aux`` map, each head's logits upsampled to
    the input: ``{"out": [N, classes, H, W], "aux": ...}``. The heads'
    dropout draws from ``generator`` in training mode."""

    def forward(self, x: torch.Tensor,
                generator: Optional[torch.Generator] = None
                ) -> Dict[str, torch.Tensor]:
        feats = self.backbone(x)
        return upsample({
            "out": self.classifier(feats["out"], generator),
            "aux": self.aux_classifier(feats["aux"], generator)},
            x.shape[-2:])
