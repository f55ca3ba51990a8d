"""Geometric functionals of the image presets (counterpart of
``vision_tpu/transforms/v2/functional/_geometry.py``): ``resize_image``,
``crop_image`` and ``center_crop_image``, on ``(..., C, H, W)`` tensors."""

from __future__ import annotations

from typing import Optional, Sequence, Tuple, Union

import torch
import torch.nn.functional as F

from vision_tpu_torch.transforms.v2.functional._resample import resize_2d

__all__ = ["center_crop_image", "crop_image", "resize_image"]


def _compute_resized_output_size(
    canvas_size: Tuple[int, int],
    size: Union[int, Sequence[int], None],
    max_size: Optional[int] = None,
) -> Tuple[int, int]:
    """An int or ``[s]``: the shorter edge to ``s``, the aspect kept and the
    longer edge capped at ``max_size``; ``(h, w)``: exactly that."""
    h, w = canvas_size
    if isinstance(size, int):
        size = [size]
    elif isinstance(size, (list, tuple)) and len(size) == 2:
        return int(size[0]), int(size[1])
    (requested,) = size
    short, long = (w, h) if w <= h else (h, w)
    new_short = requested
    new_long = int(requested * long / short)
    if max_size is not None:
        if max_size <= requested:
            raise ValueError(f"max_size {max_size} must be > size {requested}")
        if new_long > max_size:
            new_short = int(max_size * new_short / new_long)
            new_long = max_size
    return (new_long, new_short) if w <= h else (new_short, new_long)


def resize_image(
    image: torch.Tensor,
    size: Union[int, Sequence[int], None],
    interpolation: str = "bilinear",
    max_size: Optional[int] = None,
    antialias: bool = True,
) -> torch.Tensor:
    h, w = image.shape[-2:]
    new_h, new_w = _compute_resized_output_size((h, w), size, max_size)
    if (new_h, new_w) == (h, w) and interpolation != "area":
        return image
    return resize_2d(image, (new_h, new_w), mode=interpolation,
                     antialias=antialias)


def crop_image(image: torch.Tensor, top: int, left: int, height: int,
               width: int) -> torch.Tensor:
    """The ``height x width`` region at (top, left); what lies outside the
    image is zero."""
    h, w = image.shape[-2:]
    pad_top = max(-top, 0)
    pad_left = max(-left, 0)
    pad_bottom = max(top + height - h, 0)
    pad_right = max(left + width - w, 0)
    if pad_top or pad_left or pad_bottom or pad_right:
        image = F.pad(image, (pad_left, pad_right, pad_top, pad_bottom))
        top += pad_top
        left += pad_left
    return image[..., top:top + height, left:left + width]


def center_crop_image(image: torch.Tensor,
                      output_size: Union[int, Sequence[int]]) -> torch.Tensor:
    """The central crop, zero-padded where the image is smaller."""
    if isinstance(output_size, int):
        output_size = (output_size, output_size)
    elif len(output_size) == 1:
        output_size = (output_size[0], output_size[0])
    crop_h, crop_w = output_size
    h, w = image.shape[-2:]
    top = int(round((h - crop_h) / 2.0))
    left = int(round((w - crop_w) / 2.0))
    return crop_image(image, top, left, crop_h, crop_w)
