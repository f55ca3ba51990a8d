"""Inference presets attached to weights (counterpart of
``vision_tpu/transforms/_presets.py``): ``ImageClassification`` and
``ObjectDetection``. The others come with their models.

A preset takes one ``[C, H, W]`` (or batched ``[..., C, H, W]``) uint8 or
float image, moves it to the preset's device (the card unless the caller
passes ``device="cpu"``) and returns an f32 image.
"""

from __future__ import annotations

from typing import Sequence, Union

import torch

from vision_tpu_torch.models._api import resolve_device
from vision_tpu_torch.transforms.v2 import functional as F

__all__ = ["ImageClassification", "ObjectDetection"]


class ImageClassification:
    """Resize the shorter edge to ``resize_size``, centre-crop to
    ``crop_size``, rescale to [0, 1], normalise."""

    def __init__(
        self,
        *,
        crop_size: int,
        resize_size: int = 256,
        mean: Sequence[float] = (0.485, 0.456, 0.406),
        std: Sequence[float] = (0.229, 0.224, 0.225),
        interpolation: str = "bilinear",
        antialias: bool = True,
        device: Union[str, torch.device, None] = None,
    ):
        self.crop_size = crop_size
        self.resize_size = resize_size
        self.mean = list(mean)
        self.std = list(std)
        self.interpolation = interpolation
        self.antialias = antialias
        self.device = resolve_device(device)

    def __call__(self, img: torch.Tensor) -> torch.Tensor:
        img = img.to(self.device)
        img = F.resize_image(img, self.resize_size, self.interpolation,
                             antialias=self.antialias)
        img = F.center_crop_image(img, self.crop_size)
        img = F.to_dtype_image(img, torch.float32, scale=True)
        return F.normalize_image(img, self.mean, self.std)

    def __repr__(self) -> str:
        return (f"ImageClassification(crop_size={self.crop_size}, "
                f"resize_size={self.resize_size})")


class ObjectDetection:
    """Rescale to an f32 image in [0, 1]."""

    def __init__(self, *, device: Union[str, torch.device, None] = None):
        self.device = resolve_device(device)

    def __call__(self, img: torch.Tensor) -> torch.Tensor:
        return F.to_dtype_image(img.to(self.device), torch.float32, scale=True)

    def __repr__(self) -> str:
        return "ObjectDetection()"
