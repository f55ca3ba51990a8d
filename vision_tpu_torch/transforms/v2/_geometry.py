"""Geometry transforms (counterpart of
``vision_tpu/transforms/v2/_geometry.py``) for batches:
``RandomResizedCrop`` (the JAX package's traced draw and its ``batched``
resample, with the horizontal flip folded in) and
``RandomHorizontalFlip``."""

from __future__ import annotations

import math
from typing import Any, Dict, Optional, Sequence, Union

import torch

from vision_tpu_torch.transforms.v2._transform import (
    Shape,
    Transform,
    _RandomApplyTransform,
    rand,
)
from vision_tpu_torch.transforms.v2.functional._geometry import (
    horizontal_flip_image,
    resized_crop_flip_batch,
)

__all__ = ["RandomHorizontalFlip", "RandomResizedCrop"]

_CANDIDATES = 10


class RandomHorizontalFlip(_RandomApplyTransform):
    """Mirror each image with probability ``p``."""

    def transform_all(self, images, params):
        return horizontal_flip_image(images)


class RandomResizedCrop(Transform):
    """A crop of random area (a share in ``scale`` of the image's) and
    aspect (log-uniform in ``ratio``) resized to ``size``, one an image.

    The draw is the JAX package's traced one (``_make_params_traced``):
    ten candidates an image, the first whose rounded width and height fit
    the image is taken, its top-left corner uniform over the places it
    fits; an image with none takes the centre crop at the nearest aspect
    in range. ``draw(..., flip_p=p)`` also draws a mirror flag an image
    (RandomHorizontalFlip's), which the resample folds in. The resample is
    ``resized_crop_flip_batch``: bilinear, without antialias, as the JAX
    package's ``batched`` form (``interpolation`` and ``antialias`` are
    kept for its signature)."""

    def __init__(
        self,
        size: Union[int, Sequence[int]],
        scale=(0.08, 1.0),
        ratio=(3.0 / 4.0, 4.0 / 3.0),
        interpolation: str = "bilinear",
        antialias: bool = True,
    ):
        self.size = (size, size) if isinstance(size, int) else tuple(size)
        self.scale = tuple(scale)
        self.ratio = tuple(ratio)
        self.interpolation = interpolation
        self.antialias = antialias

    def output_shape(self, shape: Shape) -> Shape:
        return (*shape[:-2], *self.size)

    def draw(self, shape: Shape, generator: torch.Generator,
             flip_p: Optional[float] = None) -> Dict[str, Any]:
        """``top``, ``left``, ``height``, ``width``: ``[N]`` f32 pixels; with
        ``flip_p``, ``flip``: ``[N]`` bool."""
        n, height, width = shape[0], shape[-2], shape[-1]
        log_lo, log_hi = math.log(self.ratio[0]), math.log(self.ratio[1])
        u_scale = rand((n, _CANDIDATES), generator)
        u_scale = self.scale[0] + u_scale * (self.scale[1] - self.scale[0])
        aspect = torch.exp(log_lo + rand((n, _CANDIDATES), generator)
                           * (log_hi - log_lo))
        target_area = height * width * u_scale
        ws = torch.round(torch.sqrt(target_area * aspect))
        hs = torch.round(torch.sqrt(target_area / aspect))
        valid = (ws > 0) & (ws <= width) & (hs > 0) & (hs <= height)
        first = valid.int().argmax(1, keepdim=True)  # the first that fits
        any_valid = valid.any(1)
        # the centre crop at an in-range aspect (host numbers)
        in_ratio = width / height
        if in_ratio < self.ratio[0]:
            fw, fh = width, round(width / self.ratio[0])
        elif in_ratio > self.ratio[1]:
            fh, fw = height, round(height * self.ratio[1])
        else:
            fw, fh = width, height
        w = torch.where(any_valid, ws.gather(1, first)[:, 0], float(fw))
        h = torch.where(any_valid, hs.gather(1, first)[:, 0], float(fh))
        top = torch.where(any_valid, torch.floor(rand((n,), generator)
                                                 * (height - h + 1.0)),
                          torch.floor((height - h) / 2))
        left = torch.where(any_valid, torch.floor(rand((n,), generator)
                                                  * (width - w + 1.0)),
                           torch.floor((width - w) / 2))
        params = {"top": top, "left": left, "height": h, "width": w}
        if flip_p is not None:
            params["flip"] = rand((n,), generator) < flip_p
        return params

    def transform(self, images, params):
        return resized_crop_flip_batch(images, params["top"], params["left"],
                                       params["height"], params["width"],
                                       self.size, params.get("flip"))

    def batched(self, images: torch.Tensor, generator: torch.Generator,
                flip_p: Optional[float] = None) -> torch.Tensor:
        """The JAX package's ``batched``: crop (and, with ``flip_p``, flip)
        a whole batch."""
        return self.transform(images, self.draw(tuple(images.shape),
                                                generator, flip_p))

    def __repr__(self) -> str:
        return (f"RandomResizedCrop(size={self.size}, scale={self.scale}, "
                f"ratio={self.ratio})")
