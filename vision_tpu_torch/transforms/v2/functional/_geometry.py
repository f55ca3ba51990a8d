"""Geometric functionals (counterpart of
``vision_tpu/transforms/v2/functional/_geometry.py``) on ``(..., C, H, W)``
tensors: those of the image presets (``resize_image``, ``crop_image``,
``center_crop_image``) and those of the train-time augmentation
(``horizontal_flip_image``, ``resized_crop_flip_batch``, ``affine_image``,
``rotate_image``, and ``affine_grid_sample``, which warps each image of a
batch by a matrix of its own); and the per-sample kernels of masks, boxes,
keypoints and videos beside them, with the functionals (``resize``,
``horizontal_flip``, ``vertical_flip``, ``crop``, ``center_crop``, ``pad``,
``resized_crop``, ``affine``, ``rotate``, ``perspective``, ``elastic``)
that pick a kernel by the input's type, and ``five_crop`` and
``ten_crop``."""

from __future__ import annotations

import math
from typing import Optional, Sequence, Tuple, Union

import numpy as np
import torch
import torch.nn.functional as F

from vision_tpu_torch import tv_tensors
from vision_tpu_torch.ops.boxes import box_convert
from vision_tpu_torch.transforms.v2.functional._meta import (
    clamp_bounding_boxes,
    get_size,
)
from vision_tpu_torch.transforms.v2.functional._misc import (
    _channel_values,
    _index,
    _pad_index,
)
from vision_tpu_torch.transforms.v2.functional._resample import resize_2d
from vision_tpu_torch.transforms.v2.functional._utils import (
    _call_kernel,
    _register_kernel_internal,
)

__all__ = [
    "affine",
    "affine_bounding_boxes",
    "affine_grid_sample",
    "affine_image",
    "affine_keypoints",
    "affine_mask",
    "center_crop",
    "center_crop_image",
    "crop",
    "crop_bounding_boxes",
    "crop_image",
    "crop_keypoints",
    "crop_mask",
    "elastic",
    "elastic_bounding_boxes",
    "elastic_image",
    "elastic_keypoints",
    "elastic_mask",
    "five_crop",
    "horizontal_flip",
    "horizontal_flip_bounding_boxes",
    "horizontal_flip_image",
    "horizontal_flip_keypoints",
    "horizontal_flip_mask",
    "inverse_affine_matrix",
    "pad",
    "pad_image",
    "pad_mask",
    "perspective",
    "perspective_bounding_boxes",
    "perspective_image",
    "perspective_keypoints",
    "perspective_mask",
    "resize",
    "resize_bounding_boxes",
    "resize_image",
    "resize_keypoints",
    "resize_mask",
    "resized_crop",
    "resized_crop_dynamic",
    "resized_crop_flip_batch",
    "resized_crop_image",
    "rotate",
    "rotate_bounding_boxes",
    "rotate_image",
    "rotate_keypoints",
    "rotate_mask",
    "ten_crop",
    "vertical_flip",
    "vertical_flip_bounding_boxes",
    "vertical_flip_image",
    "vertical_flip_keypoints",
    "vertical_flip_mask",
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


def _grid_sample(images: torch.Tensor, src_y: torch.Tensor,
                 src_x: torch.Tensor, interpolation: str = "nearest",
                 fill=None) -> torch.Tensor:
    """Sample ``images`` (``[N, C, H, W]``) at the source pixel coordinates
    ``src_y``, ``src_x`` (f32, ``[OH, OW]`` for every image or ``[N, OH,
    OW]``), as ``grid_sample(align_corners=False)`` does with zeros
    outside: nearest (round half to even) or bilinear, the four corners'
    weights and sum in f32 and in the JAX package's order
    (``_sample_bilinear_zero_pad``). ``fill`` (a number or one a channel)
    replaces the zeros: nearest where the sample's own weight is at least
    a half, bilinear blended by it. An integer batch is rounded and
    clamped back."""
    n, c, h, w = images.shape
    dev = images.device
    if src_x.dim() == 2:
        src_x = src_x.expand(n, *src_x.shape)
        src_y = src_y.expand(n, *src_y.shape)
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


def affine_grid_sample(
    images: torch.Tensor,
    matrix: Sequence,
    interpolation: str = "nearest",
    fill=None,
    out_size: Optional[Tuple[int, int]] = None,
) -> torch.Tensor:
    """Inverse-warp ``images`` (``[N, C, H, W]``) by the six coefficients of
    :func:`inverse_affine_matrix` (numbers, or ``[N]`` tensors for a
    matrix a sample) onto a canvas of ``out_size`` (the input's by
    default), sampled by :func:`_grid_sample`. The arithmetic is the JAX
    package's (``_affine_grid_sample``): the coefficients rounded to f32
    and scaled into the normalised grid by the input's size, the grid
    unnormalised, in f32 and in that order."""
    n, c, h, w = images.shape
    oh, ow = (h, w) if out_size is None else out_size
    dev = images.device

    def coeff(v, half):
        if isinstance(v, torch.Tensor):
            return (v.to(dev, torch.float32) / half).view(-1, 1, 1)
        return float(np.float32(v) / np.float32(half))

    r0, r1, r2 = (coeff(v, 0.5 * w) for v in matrix[:3])
    r3, r4, r5 = (coeff(v, 0.5 * h) for v in matrix[3:])
    ys = torch.arange(oh, dtype=torch.float32, device=dev) - oh * 0.5 + 0.5
    xs = torch.arange(ow, dtype=torch.float32, device=dev) - ow * 0.5 + 0.5
    yg, xg = torch.meshgrid(ys, xs, indexing="ij")
    gx = r0 * xg + r1 * yg + r2
    gy = r3 * xg + r4 * yg + r5
    src_x = ((gx + 1.0) * w - 1.0) * 0.5
    src_y = ((gy + 1.0) * h - 1.0) * 0.5
    return _grid_sample(images, src_y, src_x, interpolation, fill)


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
    expand: bool = False,
    center: Optional[Sequence[float]] = None,
    fill=None,
) -> torch.Tensor:
    """Counter-clockwise rotation by ``angle`` degrees about ``center``; with
    ``expand`` the canvas grows to hold the whole rotated image
    (``_compute_affine_output_size``)."""
    h, w = image.shape[-2:]
    cx, cy = ((0.0, 0.0) if center is None
              else (center[0] - w * 0.5, center[1] - h * 0.5))
    matrix = inverse_affine_matrix(cx, cy, -float(angle), 0.0, 0.0, 1.0,
                                   0.0, 0.0)
    out_size = None
    if expand:
        new_w, new_h = _compute_affine_output_size(matrix, w, h)
        out_size = (new_h, new_w)
    batch = image.reshape(-1, *image.shape[-3:])
    out = affine_grid_sample(batch, matrix, interpolation, fill, out_size)
    return out.reshape(*image.shape[:-2], *out.shape[-2:])


def _compute_affine_output_size(matrix: Sequence[float], w: int, h: int
                                ) -> Tuple[int, int]:
    """(new_w, new_h): the canvas that holds the image's four corners under
    the inverse matrix, in f32 with the 1e-4 truncation before ceil and
    floor, as the JAX package computes it (``_geometry.py:876``)."""
    half_w, half_h = 0.5 * w, 0.5 * h
    theta = np.asarray(matrix, dtype=np.float32).reshape(2, 3)
    pts = np.array([[-half_w, -half_h, 1.0], [-half_w, half_h, 1.0],
                    [half_w, half_h, 1.0], [half_w, -half_h, 1.0]],
                   dtype=np.float32)
    new_pts = pts @ theta.T
    halfs = np.array([half_w, half_h], dtype=np.float32)
    min_vals = new_pts.min(axis=0) + halfs
    max_vals = new_pts.max(axis=0) + halfs
    tol, inv_tol = 1e-4, 1e4
    cmax = np.ceil(np.trunc(max_vals * inv_tol) * tol)
    cmin = np.floor(np.trunc(min_vals * inv_tol) * tol)
    size = cmax - cmin
    return int(size[0]), int(size[1])


# ----------------------------------------------------------------------
# Per-sample kernels of masks, boxes, keypoints and videos, and the
# functionals that dispatch on the input's type (``_utils.py``): the
# counterparts of ``vision_tpu/transforms/v2/functional/_geometry.py``'s
# resize (l.123-216), flips (l.218-340), crop (l.345-421), center_crop
# (l.423-472), pad (l.474-531) and resized_crop (l.533-551). Box arithmetic
# is f32 (the boxes' own type again at the end), scale factors rounded to
# f32 first, as the JAX package's are.
# ----------------------------------------------------------------------

def _f32(v: float) -> float:
    return float(np.float32(v))


def resize_mask(mask: torch.Tensor, size, max_size: Optional[int] = None
                ) -> torch.Tensor:
    """Nearest resize of ``[..., H, W]`` masks."""
    h, w = mask.shape[-2:]
    new_h, new_w = _compute_resized_output_size((h, w), size, max_size)
    if (new_h, new_w) == (h, w):
        return mask
    if mask.dtype == torch.bool:
        return resize_2d(mask.to(torch.uint8), (new_h, new_w), mode="nearest",
                         antialias=False).bool()
    return resize_2d(mask, (new_h, new_w), mode="nearest", antialias=False)


def _scale_boxes(b: torch.Tensor, format, rw: float, rh: float) -> torch.Tensor:
    rw, rh = _f32(rw), _f32(rh)
    fmt = _box_format(format)
    if fmt == "xyxyxyxy":
        factors = (rw, rh) * 4
    elif fmt in ("xywhr", "cxcywhr"):
        factors = (rw, rh, rw, rh, 1.0)
    else:
        factors = (rw, rh, rw, rh)
    return torch.stack([b[..., i] * f for i, f in enumerate(factors)], -1)


def resize_bounding_boxes(boxes: torch.Tensor, format, canvas_size, size,
                          max_size: Optional[int] = None):
    """Boxes scaled by the resize's ratios; returns (boxes, new canvas)."""
    old_h, old_w = canvas_size
    new_h, new_w = _compute_resized_output_size(canvas_size, size, max_size)
    out = _scale_boxes(boxes.float(), format, new_w / old_w, new_h / old_h)
    return out.to(boxes.dtype), (new_h, new_w)


def resize_keypoints(kp: torch.Tensor, canvas_size, size,
                     max_size: Optional[int] = None):
    old_h, old_w = canvas_size
    new_h, new_w = _compute_resized_output_size(canvas_size, size, max_size)
    xy = kp[..., :2].float()
    xy = torch.stack([xy[..., 0] * _f32(new_w / old_w),
                      xy[..., 1] * _f32(new_h / old_h)], -1).to(kp.dtype)
    return torch.cat([xy, kp[..., 2:]], -1), (new_h, new_w)


def _box_format(format) -> str:
    return (format.value if isinstance(format, tv_tensors.BoundingBoxFormat)
            else str(format)).lower()


def horizontal_flip_mask(mask: torch.Tensor) -> torch.Tensor:
    return mask.flip(-1)


def vertical_flip_image(image: torch.Tensor) -> torch.Tensor:
    return image.flip(-2)


vertical_flip_mask = vertical_flip_image


def _flip_boxes(b: torch.Tensor, format, extent: float, axis: int
                ) -> torch.Tensor:
    """Mirror boxes across the canvas's vertical (``axis`` 0: x) or
    horizontal (``axis`` 1: y) centre line."""
    fmt = _box_format(format)
    c = list(b.unbind(-1))
    if fmt == "xyxy":
        c[axis], c[axis + 2] = extent - c[axis + 2], extent - c[axis]
    elif fmt == "xywh":
        c[axis] = extent - c[axis] - c[axis + 2]
    elif fmt == "cxcywh":
        c[axis] = extent - c[axis]
    elif fmt == "cxcywhr":
        c[axis], c[4] = extent - c[axis], -c[4]
    elif fmt == "xywhr":
        c[axis] = extent - c[axis]
        c[4] = 180.0 - c[4] if axis == 0 else -c[4]
    elif fmt == "xyxyxyxy":
        for i in range(axis, 8, 2):
            c[i] = extent - c[i]
    else:
        raise ValueError(f"unsupported format {format}")
    return torch.stack(c, -1)


def horizontal_flip_bounding_boxes(boxes: torch.Tensor, format, canvas_size
                                   ) -> torch.Tensor:
    return _flip_boxes(boxes, format, canvas_size[1], 0)


def vertical_flip_bounding_boxes(boxes: torch.Tensor, format, canvas_size
                                 ) -> torch.Tensor:
    return _flip_boxes(boxes, format, canvas_size[0], 1)


def horizontal_flip_keypoints(kp: torch.Tensor, canvas_size,
                              flip_indices: Optional[Sequence[int]] = None
                              ) -> torch.Tensor:
    """x to ``W - 1 - x``; with ``flip_indices`` (COCO person's left/right
    pairs) the points of each instance re-ordered after, so that a
    mirrored left shoulder is a right shoulder."""
    x = (canvas_size[1] - 1 - kp[..., 0:1]).to(kp.dtype)
    out = torch.cat([x, kp[..., 1:]], -1)
    if flip_indices is not None:
        out = out.index_select(-2, _index(tuple(int(i) for i in flip_indices),
                                          out.device))
    return out


def vertical_flip_keypoints(kp: torch.Tensor, canvas_size) -> torch.Tensor:
    y = (canvas_size[0] - 1 - kp[..., 1:2]).to(kp.dtype)
    return torch.cat([kp[..., 0:1], y, kp[..., 2:]], -1)


def crop_mask(mask: torch.Tensor, top: int, left: int, height: int,
              width: int) -> torch.Tensor:
    return crop_image(mask.unsqueeze(-3), top, left, height, width).squeeze(-3)


def crop_bounding_boxes(boxes: torch.Tensor, format, top: int, left: int,
                        height: int, width: int):
    """Boxes moved by the crop's corner (not clamped); returns (boxes, new
    canvas)."""
    fmt = _box_format(format)
    shift = {"xyxyxyxy": (left, top) * 4, "xywhr": (left, top, 0, 0, 0),
             "cxcywhr": (left, top, 0, 0, 0), "xywh": (left, top, 0, 0),
             "cxcywh": (left, top, 0, 0)}.get(fmt, (left, top, left, top))
    b = boxes.float()
    out = torch.stack([b[..., i] - float(s) for i, s in enumerate(shift)], -1)
    return out.to(boxes.dtype), (height, width)


def crop_keypoints(kp: torch.Tensor, top: int, left: int, height: int,
                   width: int):
    xy = torch.stack([kp[..., 0] - left, kp[..., 1] - top], -1).to(kp.dtype)
    return torch.cat([xy, kp[..., 2:]], -1), (height, width)


def _parse_pad(padding) -> Tuple[int, int, int, int]:
    """(left, top, right, bottom) from torch's padding conventions."""
    if isinstance(padding, (int, float)):
        return (int(padding),) * 4
    padding = [int(p) for p in padding]
    if len(padding) == 1:
        return (padding[0],) * 4
    if len(padding) == 2:
        return (padding[0], padding[1], padding[0], padding[1])
    if len(padding) == 4:
        return tuple(padding)
    raise ValueError(f"invalid padding {padding}")


def pad_image(image: torch.Tensor, padding, fill=0,
              padding_mode: str = "constant") -> torch.Tensor:
    """``[..., C, H, W]`` padded by (left, top, right, bottom): with
    ``fill`` (a number, or one a channel) for ``"constant"``, else by
    ``"edge"``, ``"reflect"`` or ``"symmetric"`` copies."""
    left, top, right, bottom = _parse_pad(padding)
    h, w = image.shape[-2:]
    if padding_mode != "constant":
        rows = _pad_index(h, top, bottom, padding_mode, image.device)
        cols = _pad_index(w, left, right, padding_mode, image.device)
        return image.index_select(-2, rows).index_select(-1, cols)
    shape = (*image.shape[:-2], h + top + bottom, w + left + right)
    if fill is None:
        fill = 0
    if isinstance(fill, (list, tuple)):
        c = image.shape[-3]
        values = [fill[i if len(fill) > 1 else 0] for i in range(c)]
        out = torch.empty(shape, dtype=image.dtype, device=image.device)
        for i, v in enumerate(values):
            out[..., i, :, :] = v
    else:
        out = torch.full(shape, fill, dtype=image.dtype, device=image.device)
    out[..., top:top + h, left:left + w] = image
    return out


def pad_mask(mask: torch.Tensor, padding, fill=0,
             padding_mode: str = "constant") -> torch.Tensor:
    """A mask padded as one channel: a fill of one value a channel gives it
    its first value (the JAX package pads a mask through its image kernel)."""
    return pad_image(mask.unsqueeze(-3), padding, fill, padding_mode).squeeze(-3)


def _resize_boxes_k(inpt, size, interpolation="bilinear", max_size=None,
                    antialias=True):
    out, cs = resize_bounding_boxes(inpt.as_tensor(), inpt.format,
                                    inpt.canvas_size, size, max_size)
    return tv_tensors.wrap(out, like=inpt, canvas_size=cs)


def _resize_kp_k(inpt, size, interpolation="bilinear", max_size=None,
                 antialias=True):
    out, cs = resize_keypoints(inpt.as_tensor(), inpt.canvas_size, size,
                               max_size)
    return tv_tensors.wrap(out, like=inpt, canvas_size=cs)


def resize(inpt, size, interpolation: str = "bilinear",
           max_size: Optional[int] = None, antialias: bool = True):
    return _call_kernel(resize, inpt, size, interpolation, max_size, antialias)


def horizontal_flip(inpt, keypoint_flip_indices=None):
    """``keypoint_flip_indices`` re-orders the points of ``KeyPoints`` after
    the mirror (``horizontal_flip_keypoints``); other types ignore it."""
    if isinstance(inpt, tv_tensors.KeyPoints):
        return tv_tensors.wrap(horizontal_flip_keypoints(
            inpt.as_tensor(), inpt.canvas_size, keypoint_flip_indices),
            like=inpt)
    return _call_kernel(horizontal_flip, inpt)


def vertical_flip(inpt):
    return _call_kernel(vertical_flip, inpt)


def crop(inpt, top: int, left: int, height: int, width: int):
    """The ``height x width`` region at (top, left): zeros outside the
    image; boxes moved and clamped to the new canvas, keypoints moved."""
    return _call_kernel(crop, inpt, top, left, height, width)


def _crop_boxes_k(inpt, top, left, height, width):
    out, cs = crop_bounding_boxes(inpt.as_tensor(), inpt.format, top, left,
                                  height, width)
    return clamp_bounding_boxes(tv_tensors.wrap(out, like=inpt, canvas_size=cs))


def _crop_kp_k(inpt, top, left, height, width):
    out, cs = crop_keypoints(inpt.as_tensor(), top, left, height, width)
    return tv_tensors.wrap(out, like=inpt, canvas_size=cs)


def center_crop(inpt, output_size):
    if isinstance(output_size, int):
        output_size = (output_size, output_size)
    elif len(output_size) == 1:
        output_size = (output_size[0], output_size[0])
    crop_h, crop_w = output_size
    h, w = get_size(inpt)
    top = int(round((h - crop_h) / 2.0))
    left = int(round((w - crop_w) / 2.0))
    return crop(inpt, top, left, crop_h, crop_w)


def pad(inpt, padding, fill=0, padding_mode: str = "constant"):
    """Pad by (left, top, right, bottom); boxes and keypoints move with the
    corner (boxes clamped to the new canvas)."""
    return _call_kernel(pad, inpt, padding, fill, padding_mode)


def _pad_boxes_k(inpt, padding, fill=0, padding_mode="constant"):
    left, top, right, bottom = _parse_pad(padding)
    h, w = inpt.canvas_size
    cs = (h + top + bottom, w + left + right)
    out, _ = crop_bounding_boxes(inpt.as_tensor(), inpt.format, -top, -left,
                                 *cs)
    return clamp_bounding_boxes(tv_tensors.wrap(out, like=inpt, canvas_size=cs))


def _pad_kp_k(inpt, padding, fill=0, padding_mode="constant"):
    left, top, right, bottom = _parse_pad(padding)
    h, w = inpt.canvas_size
    kp = inpt.as_tensor()
    xy = torch.stack([kp[..., 0] + left, kp[..., 1] + top], -1).to(kp.dtype)
    return tv_tensors.wrap(torch.cat([xy, kp[..., 2:]], -1), like=inpt,
                           canvas_size=(h + top + bottom, w + left + right))


def resized_crop_image(image, top, left, height, width, size,
                       interpolation="bilinear", antialias=True):
    return resize_image(crop_image(image, top, left, height, width), size,
                        interpolation, antialias=antialias)


def resized_crop(inpt, top, left, height, width, size,
                 interpolation="bilinear", antialias=True):
    return resize(crop(inpt, top, left, height, width), size, interpolation,
                  antialias=antialias)


def resized_crop_dynamic(image: torch.Tensor, top, left, height, width,
                         size) -> torch.Tensor:
    """A bilinear resized crop whose rectangle may be tensors (0-d, on the
    image's device) as well as numbers, the output size fixed: one
    coordinate gather, ``align_corners=False`` with the source clamped
    inside the image, no antialias (the JAX package's
    ``resized_crop_dynamic``). ``image``: ``[..., C, H, W]``; an integer
    image comes back in its type, rounded and clamped."""
    out_h, out_w = (size, size) if isinstance(size, int) else tuple(size)
    in_h, in_w = image.shape[-2:]
    dev = image.device

    def scalar(v):  # a number filled in on the device: no copy waits
        return (v.to(dev, torch.float32) if isinstance(v, torch.Tensor)
                else torch.full((), float(v), dtype=torch.float32, device=dev))

    top, left, height, width = (scalar(v) for v in (top, left, height, width))
    ys = torch.arange(out_h, dtype=torch.float32, device=dev)
    xs = torch.arange(out_w, dtype=torch.float32, device=dev)
    gy = torch.clamp(top + (ys + 0.5) * height / out_h - 0.5, min=0.0)
    gx = torch.clamp(left + (xs + 0.5) * width / out_w - 0.5, min=0.0)
    gy = torch.clamp(gy, max=in_h - 1.0)
    gx = torch.clamp(gx, max=in_w - 1.0)
    y0 = torch.floor(gy).long()
    x0 = torch.floor(gx).long()
    y1 = torch.clamp(y0 + 1, max=in_h - 1)
    x1 = torch.clamp(x0 + 1, max=in_w - 1)
    img = image.float()

    def take(yy, xx):
        return img.index_select(-2, yy).index_select(-1, xx)

    ly = (gy - y0)[:, None]
    lx = gx - x0
    out = (take(y0, x0) * (1 - ly) * (1 - lx) + take(y0, x1) * (1 - ly) * lx
           + take(y1, x0) * ly * (1 - lx) + take(y1, x1) * ly * lx)
    if image.dtype.is_floating_point:
        return out.to(image.dtype)
    info = torch.iinfo(image.dtype)
    return torch.round(out).clamp(info.min, info.max).to(image.dtype)


# ----------------------------------------------------------------------
# The warps of masks, boxes and keypoints (the JAX package's l.876-1487):
# affine, rotate (with ``expand``), perspective and elastic, and the
# five- and ten-crops. Points move by the forward map, in f32 from the
# host's f64 coefficients rounded once; nothing is read back to the host.
# ----------------------------------------------------------------------

def _mask_kernel(image_kernel):
    """A mask kernel from an image kernel: the mask as one channel, nearest,
    a bool mask through uint8, a fill of one value a channel its first."""
    def kernel(mask, *args, fill=None, **kwargs):
        if isinstance(fill, (list, tuple)):
            fill = fill[0]
        m = mask.to(torch.uint8) if mask.dtype == torch.bool else mask
        out = image_kernel(m.unsqueeze(-3), *args, fill=fill,
                           **kwargs).squeeze(-3)
        return out.bool() if mask.dtype == torch.bool else out
    return kernel


def _forward_affine_matrix(center, angle, translate, scale, shear):
    """The JAX package's ``_get_inverse_affine_matrix(..., inverted=False)``:
    source pixel -> output pixel about the absolute ``center``, Python
    floats in its order of operations."""
    rot = float(angle) * _RAD
    sx = float(shear[0]) * _RAD
    sy = float(shear[1]) * _RAD
    cx, cy = center
    tx, ty = (float(t) for t in translate)
    a = math.cos(rot - sy) / math.cos(sy)
    b = -math.cos(rot - sy) * math.tan(sx) / math.cos(sy) - math.sin(rot)
    c = math.sin(rot - sy) / math.cos(sy)
    d = -math.sin(rot - sy) * math.tan(sx) / math.cos(sy) + math.cos(rot)
    m = [v * scale for v in (a, b, 0.0, c, d, 0.0)]
    m[2] += m[0] * (-cx) + m[1] * (-cy)
    m[5] += m[3] * (-cx) + m[4] * (-cy)
    m[2] += cx + tx
    m[5] += cy + ty
    return m


def _expand_canvas(canvas_size, center, angle, translate, scale, shear):
    """The expanded canvas (H, W) of boxes and keypoints: sized from the
    inverse matrix about the *absolute* ``center``, as torchvision's and
    the JAX package's box and keypoint kernels size it (an image's canvas
    comes from the matrix about the centred one, and the two can differ
    by a pixel)."""
    h, w = canvas_size
    inv = inverse_affine_matrix(center[0], center[1], float(angle),
                                float(translate[0]), float(translate[1]),
                                scale, float(shear[0]), float(shear[1]))
    new_w, new_h = _compute_affine_output_size(inv, w, h)
    return (new_h, new_w)


def _apply_matrix(x: torch.Tensor, y: torch.Tensor, m: Sequence[float]):
    """(m0 x + m1 y + m2, m3 x + m4 y + m5) in f32, the coefficients rounded
    to f32 first."""
    m = [_f32(v) for v in m]
    return (x * m[0] + y * m[1]) + m[2], (x * m[3] + y * m[4]) + m[5]


def _expand_shift(m, canvas_size):
    """The smallest x and y of the canvas's frame under the forward matrix
    ``m``, in f32 numpy (the JAX package's ``tr``)."""
    h, w = canvas_size
    frame = np.array([[0.0, 0.0, 1.0], [0.0, h, 1.0], [w, h, 1.0],
                      [w, 0.0, 1.0]], dtype=np.float32)
    mn = np.array([m[:3], m[3:]], dtype=np.float32)
    tr = (frame @ mn.T).min(axis=0)
    return float(tr[0]), float(tr[1])


def _corners(xyxy: torch.Tensor):
    """x and y of the four corners ``[..., 4]``: (x1, y1), (x2, y1), (x2,
    y2), (x1, y2)."""
    x1, y1, x2, y2 = xyxy.unbind(-1)
    return (torch.stack([x1, x2, x2, x1], -1),
            torch.stack([y1, y1, y2, y2], -1))


def _envelope(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    return torch.stack([x.amin(-1), y.amin(-1), x.amax(-1), y.amax(-1)], -1)


def _axis_aligned(format) -> str:
    fmt = _box_format(format)
    if fmt not in ("xyxy", "xywh", "cxcywh"):
        raise ValueError(f"the warps take axis-aligned boxes, got {format}")
    return fmt


def _affine_bounding_boxes_with_expand(boxes, format, canvas_size, angle,
                                       translate, scale, shear, center=None,
                                       expand: bool = False,
                                       clamping_mode: Optional[str] = "soft"):
    """Each box's four corners by the forward matrix, their envelope, moved
    into the expanded canvas with ``expand``, clamped to the (new) canvas:
    returns (boxes, canvas)."""
    h, w = canvas_size
    if center is None:
        center = [w * 0.5, h * 0.5]
    fmt = _axis_aligned(format)
    xyxy = box_convert(boxes.float(), fmt, "xyxy")
    m = _forward_affine_matrix(center, angle, translate, scale, shear)
    out = _envelope(*_apply_matrix(*_corners(xyxy), m))
    new_canvas = tuple(canvas_size)
    if expand:
        tx, ty = _expand_shift(m, canvas_size)
        out = out - _row4(out, tx, ty)
        new_canvas = _expand_canvas(canvas_size, center, angle, translate,
                                    scale, shear)
    out = clamp_bounding_boxes(out, format=tv_tensors.BoundingBoxFormat.XYXY,
                               canvas_size=new_canvas,
                               clamping_mode=clamping_mode)
    return box_convert(out, "xyxy", fmt).to(boxes.dtype), new_canvas


def _row4(t: torch.Tensor, x: float, y: float) -> torch.Tensor:
    """(x, y, x, y) broadcast against ``t`` ``[..., 4]``, made on its device
    without a copy from the host."""
    return torch.stack([torch.full_like(t[..., 0], v) for v in (x, y, x, y)], -1)


def affine_bounding_boxes(boxes, format, canvas_size, angle, translate, scale,
                          shear, center=None, clamping_mode="soft"):
    out, _ = _affine_bounding_boxes_with_expand(
        boxes, format, canvas_size, angle, translate, scale, shear, center,
        False, clamping_mode)
    return out


def _affine_keypoints_with_expand(kp, canvas_size, angle, translate, scale,
                                  shear, center=None, expand: bool = False):
    """Keypoints by the forward matrix; with ``expand`` moved into the
    expanded canvas. Channels after (x, y) ride along. Returns (keypoints,
    canvas)."""
    h, w = canvas_size
    if center is None:
        center = [w * 0.5, h * 0.5]
    m = _forward_affine_matrix(center, angle, translate, scale, shear)
    xy = kp[..., :2].float()
    x, y = _apply_matrix(xy[..., 0], xy[..., 1], m)
    new_canvas = tuple(canvas_size)
    if expand:
        tx, ty = _expand_shift(m, canvas_size)
        x, y = x - _f32(tx), y - _f32(ty)
        new_canvas = _expand_canvas(canvas_size, center, angle, translate,
                                    scale, shear)
    out = torch.stack([x, y], -1).to(kp.dtype)
    return torch.cat([out, kp[..., 2:]], -1), new_canvas


def affine_keypoints(kp, canvas_size, angle, translate, scale, shear,
                     center=None):
    """Returns ``(keypoints, canvas_size)``, as the JAX package's kernel."""
    return _affine_keypoints_with_expand(kp, canvas_size, angle, translate,
                                         scale, shear, center, False)


def affine_mask(mask, angle, translate, scale, shear, fill=None, center=None):
    return _mask_kernel(affine_image)(mask, angle, translate, scale, shear,
                                      "nearest", fill=fill, center=center)


def affine(inpt, angle: float, translate: Sequence[float], scale: float,
           shear: Sequence[float], interpolation: str = "nearest", fill=None,
           center=None):
    """Rotation about ``center`` with translate, scale and shear (the PIL
    convention): images and videos resampled, masks nearest, boxes by
    their corners (clamped in their own mode), keypoints moved."""
    return _call_kernel(affine, inpt, angle, translate, scale, shear,
                        interpolation, fill, center)


def rotate_mask(mask, angle, expand=False, center=None, fill=None):
    return _mask_kernel(rotate_image)(mask, angle, "nearest", expand,
                                      center, fill=fill)


def rotate_bounding_boxes(boxes, format, canvas_size, angle, expand=False,
                          center=None, clamping_mode="soft"):
    """Returns ``(boxes, canvas_size)``."""
    return _affine_bounding_boxes_with_expand(
        boxes, format, canvas_size, -angle, [0.0, 0.0], 1.0, [0.0, 0.0],
        center, expand, clamping_mode)


def rotate_keypoints(kp, canvas_size, angle, expand=False, center=None):
    """Returns ``(keypoints, canvas_size)``."""
    return _affine_keypoints_with_expand(kp, canvas_size, -angle, [0.0, 0.0],
                                         1.0, [0.0, 0.0], center, expand)


def rotate(inpt, angle: float, interpolation: str = "nearest",
           expand: bool = False, center=None, fill=None):
    """Counter-clockwise rotation by ``angle`` degrees; with ``expand`` the
    canvas of every type grows to hold the rotated image."""
    return _call_kernel(rotate, inpt, angle, interpolation, expand, center,
                        fill)


def _perspective_coeffs(startpoints, endpoints) -> list:
    """The eight coefficients of the homography that maps ``endpoints`` to
    ``startpoints``: a float64 least-squares solve on the host (the JAX
    package's and torchvision's ``_get_perspective_coeffs``)."""
    a = np.zeros((2 * len(startpoints), 8), dtype=np.float64)
    b = []
    for i, (p1, p2) in enumerate(zip(endpoints, startpoints)):
        a[2 * i, :] = [p1[0], p1[1], 1, 0, 0, 0, -p2[0] * p1[0], -p2[0] * p1[1]]
        a[2 * i + 1, :] = [0, 0, 0, p1[0], p1[1], 1, -p2[1] * p1[0],
                           -p2[1] * p1[1]]
        b.extend([p2[0], p2[1]])
    res = np.linalg.lstsq(a, np.array(b, dtype=np.float64), rcond=None)[0]
    return [float(c) for c in res]


def _coefficients(startpoints, endpoints, coefficients):
    if coefficients is None:
        coefficients = _perspective_coeffs(startpoints, endpoints)
    return [float(v) for v in coefficients]


def perspective_image(image: torch.Tensor, startpoints=None, endpoints=None,
                      interpolation: str = "bilinear", fill=None,
                      coefficients: Optional[Sequence[float]] = None
                      ) -> torch.Tensor:
    """Inverse warp by the homography ``x_src = (c0 x + c1 y + c2) / (c6 x +
    c7 y + 1)`` over pixel centres, in f32 from the coefficients rounded
    once."""
    c = [_f32(v) for v in _coefficients(startpoints, endpoints, coefficients)]
    h, w = image.shape[-2:]
    dev = image.device
    ys = torch.arange(h, dtype=torch.float32, device=dev) + 0.5
    xs = torch.arange(w, dtype=torch.float32, device=dev) + 0.5
    yg, xg = torch.meshgrid(ys, xs, indexing="ij")
    den = c[6] * xg + c[7] * yg + 1.0
    src_x = (c[0] * xg + c[1] * yg + c[2]) / den - 0.5
    src_y = (c[3] * xg + c[4] * yg + c[5]) / den - 0.5
    batch = image.reshape(-1, *image.shape[-3:])
    return _grid_sample(batch, src_y, src_x, interpolation,
                        fill).reshape(image.shape)


def perspective_mask(mask, startpoints=None, endpoints=None, fill=None,
                     coefficients=None):
    return _mask_kernel(perspective_image)(mask, startpoints, endpoints,
                                           "nearest", fill=fill,
                                           coefficients=coefficients)


def _forward_homography(coefficients) -> list:
    """The inverse of the image's homography (boxes and keypoints move
    forward): nine f64 entries, from numpy's inverse."""
    c = coefficients
    m = np.array([[c[0], c[1], c[2]], [c[3], c[4], c[5]], [c[6], c[7], 1.0]],
                 dtype=np.float64)
    return [float(v) for v in np.linalg.inv(m).reshape(-1)]


def _apply_homography(x: torch.Tensor, y: torch.Tensor, m: Sequence[float]):
    m = [_f32(v) for v in m]
    px = (x * m[0] + y * m[1]) + m[2]
    py = (x * m[3] + y * m[4]) + m[5]
    pw = (x * m[6] + y * m[7]) + m[8]
    return px / pw, py / pw


def perspective_bounding_boxes(boxes, format, canvas_size, startpoints=None,
                               endpoints=None, coefficients=None):
    """The four corners by the forward homography (raw coordinates, no
    pixel-centre offset), their envelope; not clamped."""
    m = _forward_homography(_coefficients(startpoints, endpoints, coefficients))
    fmt = _axis_aligned(format)
    xyxy = box_convert(boxes.float(), fmt, "xyxy")
    out = _envelope(*_apply_homography(*_corners(xyxy), m))
    return box_convert(out, "xyxy", fmt).to(boxes.dtype)


def perspective_keypoints(kp, canvas_size, startpoints=None, endpoints=None,
                          coefficients=None):
    m = _forward_homography(_coefficients(startpoints, endpoints, coefficients))
    xy = kp[..., :2].float()
    x, y = _apply_homography(xy[..., 0], xy[..., 1], m)
    return torch.cat([torch.stack([x, y], -1).to(kp.dtype), kp[..., 2:]], -1)


def perspective(inpt, startpoints=None, endpoints=None,
                interpolation: str = "bilinear", fill=None,
                coefficients=None):
    """The homography that maps ``endpoints`` to ``startpoints`` (or its
    eight ``coefficients``): boxes by their corners, clamped in their own
    mode; keypoints moved, not clamped."""
    return _call_kernel(perspective, inpt, startpoints, endpoints,
                        interpolation, fill, coefficients)


def _displacement(displacement: torch.Tensor, h: int, w: int,
                  device) -> torch.Tensor:
    return displacement.to(device, torch.float32).reshape(h, w, 2)


def elastic_image(image: torch.Tensor, displacement: torch.Tensor,
                  interpolation: str = "bilinear", fill=None) -> torch.Tensor:
    """Inverse warp by ``displacement`` (``[1, H, W, 2]``, (dx, dy) in the
    normalised [-1, 1] grid's units) added to each pixel's own place. A
    field on another device than the image is copied to it here."""
    h, w = image.shape[-2:]
    dev = image.device
    d = _displacement(displacement, h, w, dev)
    ys = torch.arange(h, dtype=torch.float32, device=dev)
    xs = torch.arange(w, dtype=torch.float32, device=dev)
    yg, xg = torch.meshgrid(ys, xs, indexing="ij")
    src_x = xg + d[..., 0] * (w * 0.5)
    src_y = yg + d[..., 1] * (h * 0.5)
    batch = image.reshape(-1, *image.shape[-3:])
    return _grid_sample(batch, src_y, src_x, interpolation,
                        fill).reshape(image.shape)


def elastic_mask(mask, displacement, fill=None):
    return _mask_kernel(elastic_image)(mask, displacement, "nearest", fill=fill)


def _elastic_inverse_points(xy: torch.Tensor, canvas_size, displacement,
                            ceil_points: bool) -> torch.Tensor:
    """The reference's approximate inverse warp of points: the field read
    at each point's integer pixel (truncated; box corners ceiled first),
    that pixel's index displaced back."""
    h, w = canvas_size
    d = _displacement(displacement, h, w, xy.device).reshape(h * w, 2)
    pts = torch.ceil(xy) if ceil_points else xy
    xi = pts[..., 0].to(torch.int32).clamp(0, w - 1).long()
    yi = pts[..., 1].to(torch.int32).clamp(0, h - 1).long()
    dd = d.index_select(0, (yi * w + xi).reshape(-1)).reshape(*xi.shape, 2)
    ox = xi.float() - dd[..., 0] * (w * 0.5)
    oy = yi.float() - dd[..., 1] * (h * 0.5)
    return torch.stack([ox, oy], -1)


def elastic_keypoints(kp, canvas_size, displacement):
    """Channels after (x, y) ride along."""
    out = _elastic_inverse_points(kp[..., :2].float(), canvas_size,
                                  displacement, ceil_points=False)
    return torch.cat([out.to(kp.dtype), kp[..., 2:]], -1)


def elastic_bounding_boxes(boxes, format, canvas_size, displacement,
                           clamping_mode="soft"):
    """The four corners ceiled and displaced back, their envelope, clamped
    to the canvas unless ``clamping_mode`` is None."""
    fmt = _axis_aligned(format)
    xyxy = box_convert(boxes.float(), fmt, "xyxy")
    cx, cy = _corners(xyxy)
    tp = _elastic_inverse_points(torch.stack([cx, cy], -1), canvas_size,
                                 displacement, ceil_points=True)
    out = _envelope(tp[..., 0], tp[..., 1])
    if clamping_mode is not None:
        h, w = canvas_size
        out = torch.stack([out[..., 0].clamp(0.0, w), out[..., 1].clamp(0.0, h),
                           out[..., 2].clamp(0.0, w), out[..., 3].clamp(0.0, h)],
                          -1)
    return box_convert(out, "xyxy", fmt).to(boxes.dtype)


def elastic(inpt, displacement, interpolation: str = "bilinear", fill=None):
    return _call_kernel(elastic, inpt, displacement, interpolation, fill)


def five_crop(inpt, size):
    """(top-left, top-right, bottom-left, bottom-right, centre) crops of
    ``size``."""
    if isinstance(size, int):
        size = (size, size)
    elif len(size) == 1:
        size = (size[0], size[0])
    crop_h, crop_w = size
    h, w = get_size(inpt)
    if crop_w > w or crop_h > h:
        raise ValueError(f"crop size {tuple(size)} larger than image ({h}, {w})")
    return (crop(inpt, 0, 0, crop_h, crop_w),
            crop(inpt, 0, w - crop_w, crop_h, crop_w),
            crop(inpt, h - crop_h, 0, crop_h, crop_w),
            crop(inpt, h - crop_h, w - crop_w, crop_h, crop_w),
            center_crop(inpt, (crop_h, crop_w)))


def ten_crop(inpt, size, vertical_flip: bool = False):
    """``five_crop`` of the input, then of its mirror (vertical with
    ``vertical_flip``, else horizontal)."""
    flipped = (globals()["vertical_flip"](inpt) if vertical_flip
               else horizontal_flip(inpt))
    return five_crop(inpt, size) + five_crop(flipped, size)


def _affine_boxes_k(inpt, angle, translate, scale, shear, interpolation="nearest",
                    fill=None, center=None):
    out = affine_bounding_boxes(inpt.as_tensor(), inpt.format, inpt.canvas_size,
                                angle, translate, scale, shear, center,
                                clamping_mode=inpt.clamping_mode)
    return tv_tensors.wrap(out, like=inpt)


def _affine_kp_k(inpt, angle, translate, scale, shear, interpolation="nearest",
                 fill=None, center=None):
    out, _ = affine_keypoints(inpt.as_tensor(), inpt.canvas_size, angle,
                              translate, scale, shear, center)
    return tv_tensors.wrap(out, like=inpt)


def _rotate_boxes_k(inpt, angle, interpolation="nearest", expand=False,
                    center=None, fill=None):
    out, cs = rotate_bounding_boxes(inpt.as_tensor(), inpt.format,
                                    inpt.canvas_size, angle, expand, center,
                                    clamping_mode=inpt.clamping_mode)
    return tv_tensors.wrap(out, like=inpt, canvas_size=cs)


def _rotate_kp_k(inpt, angle, interpolation="nearest", expand=False,
                 center=None, fill=None):
    out, cs = rotate_keypoints(inpt.as_tensor(), inpt.canvas_size, angle,
                               expand, center)
    return tv_tensors.wrap(out, like=inpt, canvas_size=cs)


def _perspective_boxes_k(inpt, startpoints=None, endpoints=None,
                         interpolation="bilinear", fill=None, coefficients=None):
    out = perspective_bounding_boxes(inpt.as_tensor(), inpt.format,
                                     inpt.canvas_size, startpoints, endpoints,
                                     coefficients)
    return clamp_bounding_boxes(tv_tensors.wrap(out, like=inpt))


def _perspective_kp_k(inpt, startpoints=None, endpoints=None,
                      interpolation="bilinear", fill=None, coefficients=None):
    return tv_tensors.wrap(perspective_keypoints(
        inpt.as_tensor(), inpt.canvas_size, startpoints, endpoints,
        coefficients), like=inpt)


def _elastic_boxes_k(inpt, displacement, interpolation="bilinear", fill=None):
    return tv_tensors.wrap(elastic_bounding_boxes(
        inpt.as_tensor(), inpt.format, inpt.canvas_size, displacement,
        clamping_mode=inpt.clamping_mode), like=inpt)


def _elastic_kp_k(inpt, displacement, interpolation="bilinear", fill=None):
    return tv_tensors.wrap(elastic_keypoints(
        inpt.as_tensor(), inpt.canvas_size, displacement), like=inpt)


def _register():
    for fn, image_k, mask_k, boxes_k, kp_k in (
        (resize, resize_image,
         lambda m, size, interpolation="bilinear", max_size=None,
         antialias=True: resize_mask(m, size, max_size),
         _resize_boxes_k, _resize_kp_k),
        (horizontal_flip, horizontal_flip_image, horizontal_flip_mask,
         lambda b: tv_tensors.wrap(horizontal_flip_bounding_boxes(
             b.as_tensor(), b.format, b.canvas_size), like=b), None),
        (vertical_flip, vertical_flip_image, vertical_flip_mask,
         lambda b: tv_tensors.wrap(vertical_flip_bounding_boxes(
             b.as_tensor(), b.format, b.canvas_size), like=b),
         lambda k: tv_tensors.wrap(vertical_flip_keypoints(
             k.as_tensor(), k.canvas_size), like=k)),
        (crop, crop_image, crop_mask, _crop_boxes_k, _crop_kp_k),
        (pad, pad_image, pad_mask, _pad_boxes_k, _pad_kp_k),
        (affine, affine_image,
         lambda m, angle, translate, scale, shear, interpolation="nearest",
         fill=None, center=None: affine_mask(m, angle, translate, scale, shear,
                                             fill, center),
         _affine_boxes_k, _affine_kp_k),
        (rotate, rotate_image,
         lambda m, angle, interpolation="nearest", expand=False, center=None,
         fill=None: rotate_mask(m, angle, expand, center, fill),
         _rotate_boxes_k, _rotate_kp_k),
        (perspective, perspective_image,
         lambda m, startpoints=None, endpoints=None, interpolation="bilinear",
         fill=None, coefficients=None: perspective_mask(
             m, startpoints, endpoints, fill, coefficients),
         _perspective_boxes_k, _perspective_kp_k),
        (elastic, elastic_image,
         lambda m, displacement, interpolation="bilinear", fill=None:
         elastic_mask(m, displacement, fill),
         _elastic_boxes_k, _elastic_kp_k),
    ):
        for image_type in (torch.Tensor, tv_tensors.Image, tv_tensors.Video):
            _register_kernel_internal(fn, image_type)(image_k)
        _register_kernel_internal(fn, tv_tensors.Mask)(mask_k)
        _register_kernel_internal(fn, tv_tensors.BoundingBoxes,
                                  tv_tensor_wrapper=False)(boxes_k)
        if kp_k is not None:
            _register_kernel_internal(fn, tv_tensors.KeyPoints,
                                      tv_tensor_wrapper=False)(kp_k)


_register()
