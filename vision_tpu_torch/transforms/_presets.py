"""Inference presets attached to weights (counterpart of
``vision_tpu/transforms/_presets.py``): ``ImageClassification``,
``ObjectDetection``, ``SemanticSegmentation``, ``VideoClassification`` and
``OpticalFlow``.

A preset takes one ``[C, H, W]`` (or batched ``[..., C, H, W]``) uint8 or
float image, moves it to the preset's device (the card unless the caller
passes ``device="cpu"``) and returns an f32 image. ``VideoClassification``
takes torchvision's ``[..., T, C, H, W]`` clips and returns ``[..., C, T,
H, W]``; ``OpticalFlow`` takes and returns a pair of images.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple, Union

import torch

from vision_tpu_torch.models._api import resolve_device
from vision_tpu_torch.transforms.v2 import functional as F
from vision_tpu_torch.transforms.v2.functional._resample import resize_2d

__all__ = ["ImageClassification", "ObjectDetection", "OpticalFlow",
           "SemanticSegmentation", "VideoClassification"]


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


class SemanticSegmentation:
    """Resize the shorter edge to ``resize_size`` (antialiased; none when
    None), rescale to [0, 1], normalise."""

    def __init__(
        self,
        *,
        resize_size: Optional[int],
        mean: Sequence[float] = (0.485, 0.456, 0.406),
        std: Sequence[float] = (0.229, 0.224, 0.225),
        interpolation: str = "bilinear",
        antialias: bool = True,
        device: Union[str, torch.device, None] = None,
    ):
        self.resize_size = [resize_size] if resize_size is not None else None
        self.mean = list(mean)
        self.std = list(std)
        self.interpolation = interpolation
        self.antialias = antialias
        self.device = resolve_device(device)

    def __call__(self, img: torch.Tensor) -> torch.Tensor:
        img = img.to(self.device)
        if self.resize_size is not None:
            img = F.resize_image(img, self.resize_size, self.interpolation,
                                 antialias=self.antialias)
        img = F.to_dtype_image(img, torch.float32, scale=True)
        return F.normalize_image(img, self.mean, self.std)

    def __repr__(self) -> str:
        return f"SemanticSegmentation(resize_size={self.resize_size})"


class VideoClassification:
    """Each frame of a ``[..., T, C, H, W]`` clip resized to
    ``resize_size`` (not antialiased), centre-cropped to ``crop_size``,
    rescaled to [0, 1] and normalised; returned as ``[..., C, T, H, W]``,
    the video models' layout."""

    def __init__(
        self,
        *,
        crop_size: Tuple[int, int],
        resize_size: Tuple[int, int],
        mean: Sequence[float] = (0.43216, 0.394666, 0.37645),
        std: Sequence[float] = (0.22803, 0.22145, 0.216989),
        interpolation: str = "bilinear",
        device: Union[str, torch.device, None] = None,
    ):
        self.crop_size = crop_size
        self.resize_size = resize_size
        self.mean = list(mean)
        self.std = list(std)
        self.interpolation = interpolation
        self.device = resolve_device(device)

    def __call__(self, vid: torch.Tensor) -> torch.Tensor:
        vid = vid.to(self.device)
        size = (tuple(self.resize_size) if len(self.resize_size) == 2
                else (self.resize_size[0], self.resize_size[0]))
        vid = resize_2d(vid, size, mode=self.interpolation, antialias=False)
        vid = F.center_crop_image(vid, self.crop_size)
        vid = F.to_dtype_image(vid, torch.float32, scale=True)
        vid = F.normalize_image(vid, self.mean, self.std)
        return vid.transpose(-4, -3)

    def __repr__(self) -> str:
        return (f"VideoClassification(crop_size={self.crop_size}, "
                f"resize_size={self.resize_size})")


class OpticalFlow:
    """Both images rescaled to [0, 1], then normalised to [-1, 1]."""

    def __init__(self, *, device: Union[str, torch.device, None] = None):
        self.device = resolve_device(device)

    def __call__(self, img1: torch.Tensor, img2: torch.Tensor
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
        out = []
        for img in (img1, img2):
            img = F.to_dtype_image(img.to(self.device), torch.float32,
                                   scale=True)
            out.append(F.normalize_image(img, [0.5] * 3, [0.5] * 3))
        return out[0], out[1]

    def __repr__(self) -> str:
        return "OpticalFlow()"
