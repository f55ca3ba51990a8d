"""Metadata functionals (counterpart of
``vision_tpu/transforms/v2/functional/_meta.py``): sizes, the box format
conversion and the clamps to the canvas."""

from __future__ import annotations

from typing import List, Optional, Tuple, Union

import torch

from vision_tpu_torch import tv_tensors
from vision_tpu_torch.ops.boxes import box_convert
from vision_tpu_torch.tv_tensors import (
    BoundingBoxes,
    BoundingBoxFormat,
    KeyPoints,
    Mask,
)

__all__ = [
    "clamp_bounding_boxes",
    "clamp_keypoints",
    "convert_bounding_box_format",
    "get_num_channels",
    "get_num_frames",
    "get_size",
]


def get_size(inpt) -> List[int]:
    """[H, W] of an image, video or mask, or the canvas of boxes or
    keypoints."""
    if isinstance(inpt, (BoundingBoxes, KeyPoints)):
        return list(inpt.canvas_size)
    return list(inpt.shape[-2:])


def get_num_channels(inpt) -> int:
    if isinstance(inpt, Mask) or inpt.ndim < 3:
        return 1
    return int(inpt.shape[-3])


def get_num_frames(inpt) -> int:
    return int(inpt.shape[-4])


def _fmt(fmt: Union[str, BoundingBoxFormat]) -> BoundingBoxFormat:
    return fmt if isinstance(fmt, BoundingBoxFormat) else BoundingBoxFormat(
        fmt.upper())


def _fmt_str(fmt: Union[str, BoundingBoxFormat]) -> str:
    return _fmt(fmt).value.lower()


def convert_bounding_box_format(
    inpt,
    old_format: Optional[Union[str, BoundingBoxFormat]] = None,
    new_format: Optional[Union[str, BoundingBoxFormat]] = None,
    inplace: bool = False,
):
    """Boxes in ``new_format`` (any of the six, rotated to rotated, axis-
    aligned to axis-aligned). ``BoundingBoxes`` carry their format; a plain
    tensor needs ``old_format``. ``inplace`` is accepted and ignored, as the
    JAX package ignores it."""
    del inplace
    if new_format is None:
        raise TypeError("new_format is required")
    if isinstance(inpt, BoundingBoxes):
        out = box_convert(inpt.as_tensor(), _fmt_str(inpt.format),
                          _fmt_str(new_format))
        return tv_tensors.wrap(out, like=inpt, format=_fmt(new_format))
    if old_format is None:
        raise TypeError("old_format is required for plain tensors")
    return box_convert(inpt, _fmt_str(old_format), _fmt_str(new_format))


def clamp_bounding_boxes(
    inpt,
    format: Optional[BoundingBoxFormat] = None,
    canvas_size: Optional[Tuple[int, int]] = None,
    clamping_mode: str = "auto",
):
    """Boxes clamped to the canvas. Axis-aligned: x to [0, W], y to [0, H]
    (``"soft"`` and ``"hard"`` alike). Rotated: the reference's polygon
    clamp, each canvas edge in turn taken as the left one (``"soft"``: the
    smallest box of the same angle around the part inside the canvas,
    ``"hard"``: the largest inside it). ``"auto"`` is the boxes' own mode;
    a mode of None leaves them as they are."""
    if isinstance(inpt, BoundingBoxes):
        mode = inpt.clamping_mode if clamping_mode == "auto" else clamping_mode
        out = _clamp(inpt.as_tensor(), inpt.format, inpt.canvas_size, mode)
        return tv_tensors.wrap(out, like=inpt)
    if format is None or canvas_size is None:
        raise TypeError("format and canvas_size are required for plain tensors")
    mode = "soft" if clamping_mode == "auto" else clamping_mode
    return _clamp(inpt, format, canvas_size, mode)


def _clamp(boxes, fmt, canvas_size, mode):
    if mode is None:
        return boxes
    fmt = _fmt(fmt)
    if fmt in (BoundingBoxFormat.XYWHR, BoundingBoxFormat.CXCYWHR,
               BoundingBoxFormat.XYXYXYXY):
        return _clamp_rotated(boxes, fmt, canvas_size, mode).to(boxes.dtype)
    h, w = canvas_size
    xyxy = box_convert(boxes.float(), _fmt_str(fmt), "xyxy")
    x = xyxy[..., 0::2].clamp(0, w)
    y = xyxy[..., 1::2].clamp(0, h)
    xyxy = torch.stack([x[..., 0], y[..., 0], x[..., 1], y[..., 1]], dim=-1)
    return box_convert(xyxy, "xyxy", _fmt_str(fmt)).to(boxes.dtype)


def _clip(x, lo, hi):
    # jnp.clip's order: the lower bound first, then the upper
    return torch.minimum(torch.maximum(x, lo), hi)


def _order_points(boxes8, indices=None):
    """Each polygon rolled so that (x1, y1) is its lowest-x (then lowest-y)
    vertex."""
    if indices is None:
        x, y = boxes8[..., 0::2], boxes8[..., 1::2]
        y_max = y.abs().amax(1, keepdim=True).clamp(min=1e-12)
        x_max = x.abs().amax(1, keepdim=True).clamp(min=1e-12)
        start = torch.argmin(y / y_max + (x / x_max) * 100.0, dim=1)
        base = torch.ones_like(boxes8)
        base[:, 0] = start * 2
        indices = torch.remainder(torch.cumsum(base, 1), 8).long()
    return indices, torch.gather(boxes8, 1, indices)


def _slope_intercept(box8):
    x, y = box8[..., ::2], box8[..., 1::2]
    dx = torch.diff(x, append=x[..., 0:1])
    dy = torch.diff(y, append=y[..., 0:1])
    a = dy / dx  # inf on a vertical edge
    return a, y - a * x


def _intersections(a, b):
    x = -torch.diff(b, prepend=b[..., 3:4]) / torch.diff(a, prepend=a[..., 3:4])
    y = a * x + b
    return torch.stack([x, y], -1).reshape(a.shape[0], 8)


def _clamp_y_intercept(boxes8, orig8, canvas_size, mode):
    a, b = _slope_intercept(boxes8)
    a1, a2, a3, a4 = a.unbind(-1)
    b1, b2, b3, b4 = b.unbind(-1)
    _, bm = _slope_intercept(orig8)
    b1m, b2m, b3m, b4m = bm.unbind(-1)
    h, w = canvas_size
    zero, hh = torch.zeros_like(b1), torch.full_like(b1, h)
    b1 = _clip(_clip(b2, b1, b3), zero, hh)
    b4 = _clip(_clip(b3, b2, b4), zero, hh)
    if mode == "hard":
        b1 = b4 = (b1 + b4) / 2
        b2_cand = torch.stack([b1 * a2 / a1, b3 * a2 / a3,
                               (a1 - a2) * w + b1, (a3 - a2) * w + b3], 1)
        b2 = torch.minimum(b2_cand.amax(1), b2)
        b3_cand = torch.stack([h * (1 - a3 / a4) + b4 * a3 / a4,
                               h * (1 - a3 / a2) + b2 * a3 / a2,
                               (a2 - a3) * w + b2, (a4 - a3) * w + b4], 1)
        b3 = torch.maximum(b3_cand.amin(1), b3)
    b1 = _clip(b1, b1m, b3m)
    b3 = _clip(b3, b1m, b3m)
    b2 = _clip(b2, b2m, b4m)
    b4 = _clip(b4, b2m, b4m)
    return torch.stack([b1, b2, b3, b4], -1)


def _clamp_along_y_axis(boxes8, orig8, canvas_size, mode):
    a, _ = _slope_intercept(boxes8)
    x1, y1, x2, y2, x3, y3, x4, y4 = boxes8.unbind(-1)
    b = _clamp_y_intercept(boxes8, orig8, canvas_size, mode)
    case_a = _intersections(a, b)
    case_b = boxes8.clone()
    case_b[..., 0] = boxes8[..., 0].clamp(min=0)
    case_b[..., 6] = case_b[..., 6].clamp(min=0)
    case_c = torch.zeros_like(boxes8)
    cond_a = (x1 < 0) & ~torch.isnan(case_a).any(-1)
    cond_b = torch.isclose(y1, y2) | torch.isclose(y3, y4)
    cond_c = ((x1 <= 0) & (x2 <= 0) & (x3 <= 0) & (x4 <= 0)
              | torch.isclose(y1, y4) | torch.isclose(y2, y3)
              | (cond_b & torch.isclose(x1, x2)))
    out = boxes8
    for cond, case in ((cond_a, case_a), (cond_b, case_b), (cond_c, case_c)):
        out = torch.where(cond[..., None], case, out)
    return out


def _clamp_rotated(boxes, fmt, canvas_size, mode):
    """Order the vertices, clamp against the left edge, turn the frame 90
    degrees counter-clockwise, four times."""
    shape = boxes.shape
    fmt_str = _fmt_str(fmt)
    out = box_convert(boxes.float().reshape(-1, shape[-1]), fmt_str,
                      "xyxyxyxy").reshape(-1, 8)
    orig = out
    h, w = canvas_size
    for _ in range(4):
        indices, out = _order_points(out)
        _, orig = _order_points(orig, indices)
        out = _clamp_along_y_axis(out, orig, (h, w), mode)
        _, out = _order_points(out, indices)
        _, orig = _order_points(orig, indices)
        out = torch.stack([out[:, 1::2], w - out[:, ::2]], -1).reshape(-1, 8)
        orig = torch.stack([orig[:, 1::2], w - orig[:, ::2]], -1).reshape(-1, 8)
        h, w = w, h
    return box_convert(out, "xyxyxyxy", fmt_str).reshape(shape)


def clamp_keypoints(inpt, canvas_size: Optional[Tuple[int, int]] = None):
    """x to [0, W - 1], y to [0, H - 1]; the channels after (x, y) as they
    are."""
    if isinstance(inpt, KeyPoints):
        return tv_tensors.wrap(_clamp_kp(inpt.as_tensor(), inpt.canvas_size),
                               like=inpt)
    if canvas_size is None:
        raise TypeError("canvas_size is required for plain tensors")
    return _clamp_kp(inpt, canvas_size)


def _clamp_kp(kp, canvas_size):
    h, w = canvas_size
    x = kp[..., 0:1].clamp(0, w - 1)
    y = kp[..., 1:2].clamp(0, h - 1)
    return torch.cat([x, y, kp[..., 2:]], -1).to(kp.dtype)
