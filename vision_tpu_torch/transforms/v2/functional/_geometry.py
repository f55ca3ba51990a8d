"""Geometric functionals (counterpart of
``vision_tpu/transforms/v2/functional/_geometry.py``) on ``(..., C, H, W)``
tensors: those of the image presets (``resize_image``, ``crop_image``,
``center_crop_image``) and those of the train-time augmentation
(``horizontal_flip_image``, ``resized_crop_flip_batch``, ``affine_image``,
``rotate_image``, and ``affine_grid_sample``, which warps each image of a
batch by a matrix of its own)."""

from __future__ import annotations

import math
from typing import Optional, Sequence, Tuple, Union

import numpy as np
import torch
import torch.nn.functional as F

from vision_tpu_torch.transforms.v2.functional._misc import _channel_values
from vision_tpu_torch.transforms.v2.functional._resample import resize_2d

__all__ = [
    "affine_grid_sample",
    "affine_image",
    "center_crop_image",
    "crop_image",
    "horizontal_flip_image",
    "inverse_affine_matrix",
    "resize_image",
    "resized_crop_flip_batch",
    "rotate_image",
]


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


def horizontal_flip_image(image: torch.Tensor) -> torch.Tensor:
    return image.flip(-1)


def resized_crop_flip_batch(
    images: torch.Tensor,
    top: torch.Tensor,
    left: torch.Tensor,
    height: torch.Tensor,
    width: torch.Tensor,
    size: Union[int, Sequence[int]],
    flip: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Per-sample resized crops of ``images`` (``[N, C, H, W]``), each
    mirrored where ``flip`` (``[N]`` bool) is set, as two batched products:
    ``out[n] = W_y[n] @ img[n] @ W_x[n]^T`` with the tent weights
    ``W_y[n, o, i] = relu(1 - |gy[n, o] - i|)``, which are the two-point
    bilinear lerp, since ``gy`` is clamped inside the image; the flip
    reverses ``gx``. ``top``, ``left``, ``height``, ``width`` are ``[N]``
    crop rectangles in pixels (floats allowed). No antialias. An integer
    batch comes back in its type, rounded half to even and clamped."""
    out_h, out_w = (size, size) if isinstance(size, int) else tuple(size)
    in_h, in_w = images.shape[-2:]
    dev = images.device
    top, left, height, width = (t.float().to(dev)[:, None]
                                for t in (top, left, height, width))
    ys = torch.arange(out_h, dtype=torch.float32, device=dev)[None, :]
    xs = torch.arange(out_w, dtype=torch.float32, device=dev)[None, :]
    gy = (top + (ys + 0.5) * height / out_h - 0.5).clamp(0.0, in_h - 1.0)
    gx = (left + (xs + 0.5) * width / out_w - 0.5).clamp(0.0, in_w - 1.0)
    if flip is not None:
        gx = torch.where(flip.to(dev)[:, None], gx.flip(-1), gx)
    iy = torch.arange(in_h, dtype=torch.float32, device=dev)
    ix = torch.arange(in_w, dtype=torch.float32, device=dev)
    wy = (1.0 - (gy[:, :, None] - iy).abs()).clamp(min=0.0)  # [N, out_h, H]
    wx = (1.0 - (gx[:, :, None] - ix).abs()).clamp(min=0.0)  # [N, out_w, W]
    t = torch.matmul(wy[:, None], images.float())  # [N, C, out_h, W]
    out = torch.matmul(t, wx.transpose(1, 2)[:, None])  # [N, C, out_h, out_w]
    if images.dtype.is_floating_point:
        return out.to(images.dtype)
    info = torch.iinfo(images.dtype)
    return torch.round(out).clamp(info.min, info.max).to(images.dtype)


_RAD = math.pi / 180.0  # CPython's math.radians / math.degrees constant


def inverse_affine_matrix(center_x, center_y, angle, translate_x,
                          translate_y, scale, shear_x, shear_y):
    """torchvision's ``_get_inverse_affine_matrix`` (the PIL convention):
    centred output pixel -> centred source pixel, six coefficients. Every
    argument may be a Python number or a float64 tensor of one value a
    sample; the result is a list of six, of the arguments' kind. Degrees
    go to radians as CPython's ``math.radians`` does."""
    args = (center_x, center_y, angle, translate_x, translate_y, scale,
            shear_x, shear_y)
    tensors = [v for v in args if isinstance(v, torch.Tensor)]
    lib = math
    if tensors:
        lib = torch
        # numbers filled in on the device: a copy from the host would wait
        args = tuple(v.to(torch.float64) if isinstance(v, torch.Tensor)
                     else torch.full_like(tensors[0], v, dtype=torch.float64)
                     for v in args)
    (center_x, center_y, angle, translate_x, translate_y, scale, shear_x,
     shear_y) = args
    rot = angle * _RAD
    sx = shear_x * _RAD
    sy = shear_y * _RAD
    a = lib.cos(rot - sy) / lib.cos(sy)
    b = -lib.cos(rot - sy) * lib.tan(sx) / lib.cos(sy) - lib.sin(rot)
    c = lib.sin(rot - sy) / lib.cos(sy)
    d = -lib.sin(rot - sy) * lib.tan(sx) / lib.cos(sy) + lib.cos(rot)
    m = [d / scale, -b / scale, 0.0, -c / scale, a / scale, 0.0]
    m[2] = (m[0] * (-center_x - translate_x)
            + m[1] * (-center_y - translate_y)) + center_x
    m[5] = (m[3] * (-center_x - translate_x)
            + m[4] * (-center_y - translate_y)) + center_y
    return m


def _gather_nhwc(rows: torch.Tensor, yy: torch.Tensor, xx: torch.Tensor,
                 h: int, w: int) -> torch.Tensor:
    """``rows[n, yy * w + xx]`` for ``rows`` ``[N, H*W, C]`` and integer maps
    ``[N, OH, OW]`` already clamped inside the image: ``[N, OH, OW, C]``."""
    n = rows.shape[0]
    base = torch.arange(n, device=rows.device).view(n, 1, 1) * (h * w)
    flat = (base + yy.long() * w + xx.long()).reshape(-1)
    return rows.reshape(n * h * w, -1).index_select(0, flat).view(
        *yy.shape, rows.shape[-1])


def affine_grid_sample(
    images: torch.Tensor,
    matrix: Sequence,
    interpolation: str = "nearest",
    fill=None,
) -> torch.Tensor:
    """Inverse-warp ``images`` (``[N, C, H, W]``) by the six coefficients of
    :func:`inverse_affine_matrix` (numbers, or ``[N]`` tensors for a
    matrix a sample), sampling as ``grid_sample(align_corners=False)`` does
    with zeros outside, nearest (round half to even) or bilinear. The
    arithmetic is the JAX package's (``_affine_grid_sample``): the
    coefficients rounded to f32 and scaled into the normalised grid, the
    grid unnormalised, the four corners' weights and sum, in f32 and in
    that order. ``fill`` (a number or one a channel) replaces the zeros:
    nearest where the sample's own weight is at least a half, bilinear
    blended by it. An integer batch is rounded and clamped back."""
    n, c, h, w = images.shape  # the output keeps the canvas (no expand)
    dev = images.device

    def coeff(v, half):
        if isinstance(v, torch.Tensor):
            return (v.to(dev, torch.float32) / half).view(-1, 1, 1)
        return float(np.float32(v) / np.float32(half))

    r0, r1, r2 = (coeff(v, 0.5 * w) for v in matrix[:3])
    r3, r4, r5 = (coeff(v, 0.5 * h) for v in matrix[3:])
    ys = torch.arange(h, dtype=torch.float32, device=dev) - h * 0.5 + 0.5
    xs = torch.arange(w, dtype=torch.float32, device=dev) - w * 0.5 + 0.5
    yg, xg = torch.meshgrid(ys, xs, indexing="ij")
    gx = r0 * xg + r1 * yg + r2
    gy = r3 * xg + r4 * yg + r5
    src_x = ((gx + 1.0) * w - 1.0) * 0.5
    src_y = ((gy + 1.0) * h - 1.0) * 0.5
    if src_x.dim() == 2:
        src_x, src_y = src_x.expand(n, h, w), src_y.expand(n, h, w)

    img = images.float()
    if fill is not None:
        img = torch.cat([img, torch.ones_like(img[:, :1])], 1)
    rows = img.permute(0, 2, 3, 1).reshape(n, h * w, -1)

    def corner(yy, xx):
        valid = (yy >= 0) & (yy < h) & (xx >= 0) & (xx < w)
        return _gather_nhwc(rows, yy.clamp(0, h - 1), xx.clamp(0, w - 1),
                            h, w), valid

    if interpolation == "nearest":
        v, valid = corner(torch.round(src_y).int(), torch.round(src_x).int())
        out = v * valid[..., None]
    elif interpolation == "bilinear":
        y0 = torch.floor(src_y).int()
        x0 = torch.floor(src_x).int()
        ly, lx = src_y - y0, src_x - x0
        out = None
        for yy, xx, wy, wx in ((y0, x0, 1 - ly, 1 - lx), (y0, x0 + 1, 1 - ly, lx),
                               (y0 + 1, x0, ly, 1 - lx), (y0 + 1, x0 + 1, ly, lx)):
            v, valid = corner(yy, xx)
            term = v * (wy * wx * valid)[..., None]
            out = term if out is None else out + term
    else:
        raise ValueError(f"interpolation must be nearest or bilinear, got "
                         f"{interpolation!r}")
    out = out.permute(0, 3, 1, 2)
    if fill is not None:
        mask, out = out[:, -1:], out[:, :-1]
        fills = (float(fill) if isinstance(fill, (int, float))
                 else _channel_values(tuple(map(float, fill)), torch.float32, dev))
        if interpolation == "nearest":
            out = torch.where(mask >= 0.5, out, fills)
        else:
            out = out * mask + (1.0 - mask) * fills
    if not images.dtype.is_floating_point:
        info = torch.iinfo(images.dtype)
        out = torch.round(out).clamp(info.min, info.max)
    return out.to(images.dtype)


def affine_image(
    image: torch.Tensor,
    angle: float,
    translate: Sequence[float],
    scale: float,
    shear: Sequence[float],
    interpolation: str = "nearest",
    fill=None,
    center: Optional[Sequence[float]] = None,
) -> torch.Tensor:
    """Rotation about ``center`` (the image's centre by default) with
    translate, scale and shear, in the PIL convention, for ``(..., C, H,
    W)`` images."""
    h, w = image.shape[-2:]
    cx, cy = ((0.0, 0.0) if center is None
              else (center[0] - w * 0.5, center[1] - h * 0.5))
    matrix = inverse_affine_matrix(cx, cy, float(angle), float(translate[0]),
                                   float(translate[1]), scale, float(shear[0]),
                                   float(shear[1]))
    batch = image.reshape(-1, *image.shape[-3:])
    out = affine_grid_sample(batch, matrix, interpolation, fill)
    return out.reshape(image.shape)


def rotate_image(
    image: torch.Tensor,
    angle: float,
    interpolation: str = "nearest",
    center: Optional[Sequence[float]] = None,
    fill=None,
) -> torch.Tensor:
    """Counter-clockwise rotation by ``angle`` degrees about ``center``, on
    the same canvas (``expand=False``)."""
    h, w = image.shape[-2:]
    cx, cy = ((0.0, 0.0) if center is None
              else (center[0] - w * 0.5, center[1] - h * 0.5))
    matrix = inverse_affine_matrix(cx, cy, -float(angle), 0.0, 0.0, 1.0,
                                   0.0, 0.0)
    batch = image.reshape(-1, *image.shape[-3:])
    out = affine_grid_sample(batch, matrix, interpolation, fill)
    return out.reshape(image.shape)
