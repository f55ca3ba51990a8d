"""The v1-only names (counterpart of ``vision_tpu/transforms/_compat.py``):
``InterpolationMode``, ``ToTensor`` and ``ConvertImageDtype``; every other
v1 class is its v2 class (``transforms/__init__.py``)."""

from __future__ import annotations

import enum

import numpy as np
import torch
import torch.utils._pytree as pytree

from vision_tpu_torch.transforms.v2._transform import Transform
from vision_tpu_torch.transforms.v2.functional._aliases import (
    is_pil_image,
    to_tensor,
)
from vision_tpu_torch.transforms.v2.functional._misc import (
    to_dtype,
    to_dtype_image,
)

__all__ = ["ConvertImageDtype", "InterpolationMode", "ToTensor"]


class InterpolationMode(str, enum.Enum):
    """torchvision's interpolation modes. A ``str`` subclass, so that a
    member goes wherever the transforms take a mode's name."""

    NEAREST = "nearest"
    NEAREST_EXACT = "nearest-exact"
    BILINEAR = "bilinear"
    BICUBIC = "bicubic"
    BOX = "box"
    HAMMING = "hamming"
    LANCZOS = "lanczos"

    def __str__(self):
        return self.value


class ToTensor(Transform):
    """The v1 ``ToTensor``: each numpy array and PIL image of the input as
    an f32 ``[C, H, W]`` tensor, integers scaled into [0, 1]
    (``functional.to_tensor``; torchvision's layout, where the JAX package
    keeps ``(H, W, C)``). Everything else passes through."""

    def __call__(self, inputs, generator=None):
        return pytree.tree_map(
            lambda x: to_tensor(x) if isinstance(x, np.ndarray)
            or is_pil_image(x) else x, inputs)


class ConvertImageDtype(Transform):
    """The v1 ``ConvertImageDtype``: ``ToDtype(dtype, scale=True)`` of
    images, videos and the plain image tensor; a batch too."""

    def __init__(self, dtype: torch.dtype = torch.float32):
        self.dtype = dtype

    def transform(self, images, params):
        return to_dtype_image(images, self.dtype, scale=True)

    def transform_sample(self, inpt, params):
        return to_dtype(inpt, self.dtype, scale=True)

    def __repr__(self) -> str:
        return f"ConvertImageDtype({self.dtype})"
