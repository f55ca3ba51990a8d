"""Colour functionals (counterpart of
``vision_tpu/transforms/v2/functional/_color.py``): the RandAugment colour
ops on ``(..., C, H, W)`` tensors; the blends, solarize and autocontrast
take uint8 or float in [0, 1], posterize and equalize uint8.

Every factor may be a Python number or a tensor with one value a sample
(``[N]`` for an ``[N, C, H, W]`` batch), so that one call applies a
different factor to each image. A factor is taken as the JAX package takes
a Python float: the blend's two weights ``f`` and ``1 - f`` are formed in
the factor's own precision (float64 for a Python number) and rounded to
f32 once each; pass float64 tensors to get the JAX per-sample functional's
arithmetic. Integer results are clamped to the type's range and truncated,
as ``torch``'s ``.to(uint8)`` and JAX's ``astype`` do.
"""

from __future__ import annotations

from typing import Union

import numpy as np
import torch

__all__ = [
    "adjust_brightness",
    "adjust_contrast",
    "adjust_saturation",
    "adjust_sharpness",
    "autocontrast",
    "equalize",
    "posterize",
    "rgb_to_grayscale",
    "solarize",
]

Factor = Union[float, torch.Tensor]

# the sharpness kernel's weights, divided in f32 as the JAX kernel is
_SIDE = float(np.float32(1.0) / np.float32(13.0))
_CENTRE = float(np.float32(5.0) / np.float32(13.0))


def _max_value(dtype: torch.dtype) -> float:
    return 1.0 if dtype.is_floating_point else float(torch.iinfo(dtype).max)


def _per_sample(value: Factor, image: torch.Tensor) -> Factor:
    """A ``[N]`` tensor as ``[N, 1, 1, 1]`` against ``image`` (``[N, C, H,
    W]``); a number or a 0-d tensor as it is."""
    if isinstance(value, torch.Tensor) and value.dim() == 1:
        return value.reshape(-1, *([1] * (image.dim() - 1)))
    return value


def _f32(value: Factor) -> Factor:
    return value.float() if isinstance(value, torch.Tensor) else value


def _blend(img1: torch.Tensor, img2: torch.Tensor, ratio: Factor) -> torch.Tensor:
    """``ratio * img1 + (1 - ratio) * img2`` in f32, clamped to the type's
    range and cast back (truncation for integers)."""
    ratio = _per_sample(ratio, img1)
    out = _f32(ratio) * img1.float() + _f32(1.0 - ratio) * img2.float()
    return out.clamp(0.0, _max_value(img1.dtype)).to(img1.dtype)


def _gray_f32(image: torch.Tensor) -> torch.Tensor:
    r, g, b = image[..., 0, :, :], image[..., 1, :, :], image[..., 2, :, :]
    return 0.2989 * r.float() + 0.587 * g.float() + 0.114 * b.float()


def rgb_to_grayscale(image: torch.Tensor,
                     num_output_channels: int = 1) -> torch.Tensor:
    """``L = 0.2989 R + 0.587 G + 0.114 B`` in f32, truncated to the input's
    type."""
    if image.shape[-3] == 1:
        out = image
    else:
        out = _gray_f32(image).to(image.dtype).unsqueeze(-3)
    if num_output_channels == 3:
        out = out.expand(*out.shape[:-3], 3, *out.shape[-2:])
    return out


def adjust_brightness(image: torch.Tensor, brightness_factor: Factor) -> torch.Tensor:
    return _blend(image, torch.zeros_like(image), brightness_factor)


def adjust_saturation(image: torch.Tensor, saturation_factor: Factor) -> torch.Tensor:
    if image.shape[-3] == 1:
        return image
    return _blend(image, rgb_to_grayscale(image, 3), saturation_factor)


def adjust_contrast(image: torch.Tensor, contrast_factor: Factor) -> torch.Tensor:
    """Blend with the mean of the grayscale image (floored first for an
    integer image), one mean an image."""
    if image.shape[-3] == 3:
        gray = _gray_f32(image)
    else:
        gray = image[..., 0, :, :].float()
    if not image.dtype.is_floating_point:
        gray = torch.floor(gray)
    mean = gray.mean(dim=(-2, -1), keepdim=True).unsqueeze(-3)
    return _blend(image, mean.expand(image.shape), contrast_factor)


def adjust_sharpness(image: torch.Tensor, sharpness_factor: Factor) -> torch.Tensor:
    """Blend with the image smoothed by the 3x3 kernel ``[[1, 1, 1], [1, 5,
    1], [1, 1, 1]] / 13``; the border ring keeps the original pixels. The
    nine taps are summed in a fixed order, row by row, so that every device
    computes the same bits."""
    h, w = image.shape[-2:]
    if h <= 2 or w <= 2:
        return image
    f = image.float()
    blur = None
    for dy in range(3):
        for dx in range(3):
            weight = _CENTRE if (dy, dx) == (1, 1) else _SIDE
            tap = f[..., dy:h - 2 + dy, dx:w - 2 + dx] * weight
            blur = tap if blur is None else blur + tap
    blur = blur.clamp(0.0, _max_value(image.dtype))
    if not image.dtype.is_floating_point:
        blur = torch.floor(blur)
    blurred = f.clone()
    blurred[..., 1:-1, 1:-1] = blur
    return _blend(image, blurred, sharpness_factor)


def posterize(image: torch.Tensor, bits: Union[int, torch.Tensor]) -> torch.Tensor:
    """Keep the top ``bits`` bits of a uint8 image (``bits`` an int or one
    a sample)."""
    if image.dtype != torch.uint8:
        raise TypeError(f"posterize takes uint8 images, got {image.dtype}")
    if not isinstance(bits, torch.Tensor):
        return image & (-(2 ** (8 - int(bits))) & 0xFF)
    shift = (8 - _per_sample(bits, image).to(torch.int32)).clamp(0, 8)
    mask = (256 - torch.bitwise_left_shift(torch.ones_like(shift), shift)) & 0xFF
    return image & mask.to(torch.uint8)


def solarize(image: torch.Tensor, threshold: Factor) -> torch.Tensor:
    """Invert the pixels at or above ``threshold``."""
    bound = _max_value(image.dtype)
    inverted = (bound - image.float()).to(image.dtype)
    return torch.where(image >= _per_sample(threshold, image), inverted, image)


def autocontrast(image: torch.Tensor) -> torch.Tensor:
    """Stretch each channel of each image to the full range (a constant
    channel is left as it is)."""
    bound = _max_value(image.dtype)
    f = image.float()
    lo = f.amin(dim=(-2, -1), keepdim=True)
    hi = f.amax(dim=(-2, -1), keepdim=True)
    eq = hi == lo
    scale = bound / torch.where(eq, torch.ones_like(hi), hi - lo)
    out = torch.where(eq, f, ((f - lo) * scale).clamp(0.0, bound))
    return out.to(image.dtype)


def equalize(image: torch.Tensor) -> torch.Tensor:
    """Histogram equalisation of each channel of each uint8 image
    (torchvision's ``_equalize``: ``step = (n - hist[max]) // 255``, the
    table ``(cumsum + step // 2) // step`` shifted by one, the channel kept
    where ``step`` is 0)."""
    if image.dtype != torch.uint8:
        raise TypeError(f"equalize takes uint8 images, got {image.dtype}")
    h, w = image.shape[-2:]
    rows = image.reshape(-1, h * w).long()  # one row a channel of an image
    hist = torch.zeros(rows.shape[0], 256, dtype=torch.int64, device=image.device)
    hist.scatter_add_(1, rows, torch.ones_like(rows))
    hist_at_max = hist.gather(1, rows.amax(dim=1, keepdim=True))
    step = (h * w - hist_at_max) // 255
    lut = (hist.cumsum(1) + step // 2) // step.clamp(min=1)
    lut = torch.cat([torch.zeros_like(lut[:, :1]), lut[:, :-1]], 1).clamp(0, 255)
    out = torch.where(step == 0, rows, lut.gather(1, rows))
    return out.to(torch.uint8).reshape(image.shape)
