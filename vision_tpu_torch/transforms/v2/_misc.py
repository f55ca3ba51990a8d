"""Misc transforms (counterpart of ``vision_tpu/transforms/v2/_misc.py``):
``ToDtype`` and ``Normalize``, over the port's functionals."""

from __future__ import annotations

from typing import Sequence

import torch

from vision_tpu_torch.transforms.v2._transform import Transform
from vision_tpu_torch.transforms.v2.functional._misc import (
    normalize_image,
    to_dtype_image,
)

__all__ = ["Normalize", "ToDtype"]


class ToDtype(Transform):
    def __init__(self, dtype: torch.dtype = torch.float32, scale: bool = False):
        self.dtype = dtype
        self.scale = scale

    def transform(self, images, params):
        return to_dtype_image(images, self.dtype, self.scale)

    def __repr__(self) -> str:
        return f"ToDtype({self.dtype}, scale={self.scale})"


class Normalize(Transform):
    def __init__(self, mean: Sequence[float], std: Sequence[float]):
        self.mean = [float(m) for m in mean]
        self.std = [float(s) for s in std]

    def transform(self, images, params):
        return normalize_image(images, self.mean, self.std)

    def __repr__(self) -> str:
        return f"Normalize(mean={self.mean}, std={self.std})"
