"""Colour functionals (counterpart of
``vision_tpu/transforms/v2/functional/_color.py``) on ``(..., C, H, W)``
tensors, images and videos (``Image`` and ``Video`` come back typed, any
other typed tensor raises): uint8 or float in [0, 1].

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

import functools
from typing import Sequence, Union

import numpy as np
import torch

from vision_tpu_torch import tv_tensors
from vision_tpu_torch.transforms.v2.functional._misc import _index

__all__ = [
    "adjust_brightness",
    "adjust_contrast",
    "adjust_gamma",
    "adjust_hue",
    "adjust_saturation",
    "adjust_sharpness",
    "autocontrast",
    "equalize",
    "grayscale_to_rgb",
    "invert",
    "permute_channels",
    "posterize",
    "rgb_to_grayscale",
    "solarize",
]


def _image_functional(fn):
    """``fn`` of plain tensors, taking an ``Image`` or a ``Video`` too and
    giving its result the input's type."""

    @functools.wraps(fn)
    def wrapper(inpt, *args, **kwargs):
        if isinstance(inpt, tv_tensors.TVTensor):
            if not isinstance(inpt, (tv_tensors.Image, tv_tensors.Video)):
                raise TypeError(f"{fn.__name__} takes images and videos, got "
                                f"{type(inpt).__name__}")
            return tv_tensors.wrap(fn(inpt.as_tensor(), *args, **kwargs),
                                   like=inpt)
        return fn(inpt, *args, **kwargs)

    return wrapper

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


@_image_functional
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


@_image_functional
def adjust_brightness(image: torch.Tensor, brightness_factor: Factor) -> torch.Tensor:
    return _blend(image, torch.zeros_like(image), brightness_factor)


@_image_functional
def adjust_saturation(image: torch.Tensor, saturation_factor: Factor) -> torch.Tensor:
    if image.shape[-3] == 1:
        return image
    return _blend(image, rgb_to_grayscale(image, 3), saturation_factor)


@_image_functional
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


@_image_functional
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


@_image_functional
def posterize(image: torch.Tensor, bits: Union[int, torch.Tensor]) -> torch.Tensor:
    """Keep the top ``bits`` bits of a uint8 image (``bits`` an int or one
    a sample); a float image (``bits`` an int) to ``2^bits`` levels,
    floored."""
    if image.is_floating_point() and not isinstance(bits, torch.Tensor):
        if bits >= 8:
            return image
        levels = float(2 ** int(bits))
        return torch.floor(image * levels) / levels
    if image.dtype != torch.uint8:
        raise TypeError(f"posterize takes uint8 or float images, got "
                        f"{image.dtype}")
    if not isinstance(bits, torch.Tensor):
        return image & (-(2 ** (8 - int(bits))) & 0xFF)
    shift = (8 - _per_sample(bits, image).to(torch.int32)).clamp(0, 8)
    mask = (256 - torch.bitwise_left_shift(torch.ones_like(shift), shift)) & 0xFF
    return image & mask.to(torch.uint8)


@_image_functional
def solarize(image: torch.Tensor, threshold: Factor) -> torch.Tensor:
    """Invert the pixels at or above ``threshold``."""
    bound = _max_value(image.dtype)
    inverted = (bound - image.float()).to(image.dtype)
    return torch.where(image >= _per_sample(threshold, image), inverted, image)


@_image_functional
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


@_image_functional
def equalize(image: torch.Tensor) -> torch.Tensor:
    """Histogram equalisation of each channel of each uint8 image
    (torchvision's ``_equalize``: ``step = (n - hist[max]) // 255``, the
    table ``(cumsum + step // 2) // step`` shifted by one, the channel kept
    where ``step`` is 0)."""
    if image.is_floating_point():
        # the JAX package's float path: through uint8 and back
        u8 = (image.float() * 255.0).to(torch.uint8)
        return (equalize(u8).float() / 255.0).to(image.dtype)
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


@_image_functional
def grayscale_to_rgb(image: torch.Tensor) -> torch.Tensor:
    if image.shape[-3] == 3:
        return image
    return image.expand(*image.shape[:-3], 3, *image.shape[-2:])


def _rgb_to_hsv(img: torch.Tensor) -> torch.Tensor:
    """torchvision's ``_rgb2hsv`` on f32 in [0, 1], the JAX package's order
    of operations."""
    r, g, b = img.unbind(-3)
    maxc = torch.maximum(torch.maximum(r, g), b)
    minc = torch.minimum(torch.minimum(r, g), b)
    eqc = maxc == minc
    cr = maxc - minc
    ones = torch.ones_like(maxc)
    s = cr / torch.where(eqc, ones, maxc)
    cr_divisor = torch.where(eqc, ones, cr)
    rc = (maxc - r) / cr_divisor
    gc = (maxc - g) / cr_divisor
    bc = (maxc - b) / cr_divisor
    hr = (maxc == r) * (bc - gc)
    hg = ((maxc == g) & (maxc != r)) * (2.0 + rc - bc)
    hb = ((maxc != g) & (maxc != r)) * (4.0 + gc - rc)
    h = torch.remainder((hr + hg + hb) / 6.0 + 1.0, 1.0)
    return torch.stack([h, s, maxc], -3)


def _hsv_to_rgb(img: torch.Tensor) -> torch.Tensor:
    h, s, v = img.unbind(-3)
    i = torch.floor(h * 6.0)
    f = h * 6.0 - i
    i = i.to(torch.int32) % 6
    p = (v * (1.0 - s)).clamp(0.0, 1.0)
    q = (v * (1.0 - s * f)).clamp(0.0, 1.0)
    t = (v * (1.0 - s * (1.0 - f))).clamp(0.0, 1.0)
    table = torch.stack([torch.stack(c, -3) for c in (
        (v, t, p), (q, v, p), (p, v, t), (p, q, v), (t, p, v), (v, p, q))], 0)
    pick = i.long().unsqueeze(-3).expand(*i.shape[:-2], 3, *i.shape[-2:])
    return table.gather(0, pick.unsqueeze(0))[0]


@_image_functional
def adjust_hue(image: torch.Tensor, hue_factor: float) -> torch.Tensor:
    """Rotate the hue by ``hue_factor`` (in [-0.5, 0.5]) of a turn, through
    HSV; an integer image is rounded back."""
    if not -0.5 <= hue_factor <= 0.5:
        raise ValueError(f"hue_factor must be in [-0.5, 0.5], got {hue_factor}")
    if image.shape[-3] == 1:
        return image
    bound = _max_value(image.dtype)
    hsv = _rgb_to_hsv(image.float() / bound)
    h = torch.remainder(hsv[..., 0, :, :] + hue_factor, 1.0)
    out = _hsv_to_rgb(torch.stack([h, hsv[..., 1, :, :], hsv[..., 2, :, :]],
                                  -3)) * bound
    if not image.dtype.is_floating_point:
        out = torch.round(out)
    return out.to(image.dtype)


@_image_functional
def adjust_gamma(image: torch.Tensor, gamma: float, gain: float = 1.0
                 ) -> torch.Tensor:
    if gamma < 0:
        raise ValueError("gamma must be non-negative")
    bound = _max_value(image.dtype)
    out = (gain * (image.float() / bound) ** gamma).clamp(0.0, 1.0) * bound
    if not image.dtype.is_floating_point:
        out = torch.round(out)
    return out.to(image.dtype)


@_image_functional
def invert(image: torch.Tensor) -> torch.Tensor:
    bound = _max_value(image.dtype)
    if not image.dtype.is_floating_point:
        return (int(bound) - image.to(torch.int32)).to(image.dtype)
    return bound - image


@_image_functional
def permute_channels(image: torch.Tensor, permutation: Sequence[int]
                     ) -> torch.Tensor:
    if len(permutation) != image.shape[-3]:
        raise ValueError("permutation length must equal the channel count")
    return image.index_select(-3, _index(tuple(int(i) for i in permutation),
                                         image.device))
