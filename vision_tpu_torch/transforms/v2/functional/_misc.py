"""Value functionals (counterpart of
``vision_tpu/transforms/v2/functional/_misc.py``): ``normalize_image`` and
``to_dtype_image`` on ``(..., C, H, W)`` tensors, ``normalize`` and
``to_dtype`` on typed ones, and ``sanitize_bounding_boxes``."""

from __future__ import annotations

import functools
from typing import Optional, Sequence, Tuple

import torch

from vision_tpu_torch import tv_tensors
from vision_tpu_torch.ops.boxes import box_convert

__all__ = ["normalize", "normalize_image", "sanitize_bounding_boxes",
           "to_dtype", "to_dtype_image"]

_VALUE_BITS = {
    torch.uint8: 8,
    torch.int8: 7,
    torch.int16: 15,
    torch.uint16: 16,
    torch.int32: 31,
    torch.int64: 63,
}


@functools.lru_cache(maxsize=64)
def _channel_values(values: Tuple[float, ...], dtype: torch.dtype,
                    device: torch.device) -> torch.Tensor:
    """``values`` as a ``[C, 1, 1]`` tensor on ``device``, made once: a list
    copied to the card on every call would hold the host until the card's
    stream drains. Never an inference tensor, so that autograd may save it."""
    with torch.inference_mode(False):
        return torch.tensor(values, dtype=dtype).to(device)[:, None, None]


@functools.lru_cache(maxsize=64)
def _index(values: Tuple[int, ...], device: torch.device) -> torch.Tensor:
    """``values`` as an int64 index tensor on ``device``, made once (an
    index list copied to the card at every call would wait for it)."""
    with torch.inference_mode(False):
        host = torch.tensor(values, dtype=torch.int64)
        if device.type == "cuda":
            return host.pin_memory().to(device, non_blocking=True)
        return host.to(device)


def normalize_image(image: torch.Tensor, mean: Sequence[float],
                    std: Sequence[float]) -> torch.Tensor:
    """``(x - mean) / std`` over the channel axis (-3) of a float image."""
    if not image.is_floating_point():
        raise TypeError(f"normalize expects float input, got {image.dtype}")
    mean = _channel_values(tuple(float(m) for m in mean), image.dtype, image.device)
    std = _channel_values(tuple(float(s) for s in std), image.dtype, image.device)
    return (image - mean) / std


def to_dtype_image(image: torch.Tensor, dtype: torch.dtype = torch.float32,
                   scale: bool = False) -> torch.Tensor:
    """Convert ``image`` to ``dtype``; with ``scale``, map the value range
    of one type onto the other's (integers to [0, 1] by the reciprocal of
    the type's maximum; [0, 1] floats to integers by ``max + 1 - 1e-3``,
    truncated; integers to integers by bit shifts)."""
    if image.dtype == dtype:
        return image
    if not scale:
        return image.to(dtype)
    if image.is_floating_point():
        if dtype.is_floating_point:
            return image.to(dtype)
        if image.dtype == torch.float32 and dtype in (torch.int32, torch.int64):
            raise RuntimeError(
                f"conversion {image.dtype} -> {dtype} cannot be performed safely")
        max_value = float(torch.iinfo(dtype).max)
        return (image * (max_value + 1.0 - 1e-3)).to(dtype)
    if dtype.is_floating_point:
        return image.to(dtype) * (1.0 / float(torch.iinfo(image.dtype).max))
    in_bits, out_bits = _VALUE_BITS[image.dtype], _VALUE_BITS[dtype]
    if in_bits > out_bits:
        return (image >> (in_bits - out_bits)).to(dtype)
    return image.to(dtype) << (out_bits - in_bits)


def _image_like(inpt) -> bool:
    return isinstance(inpt, (tv_tensors.Image, tv_tensors.Video)) or not (
        isinstance(inpt, tv_tensors.TVTensor))


def to_dtype(inpt, dtype: torch.dtype = torch.float32, scale: bool = False):
    """Images, videos and plain tensors through ``to_dtype_image``; masks,
    boxes and keypoints cast as they are."""
    if not isinstance(inpt, tv_tensors.TVTensor):
        return to_dtype_image(inpt, dtype, scale)
    if _image_like(inpt):
        out = to_dtype_image(inpt.as_tensor(), dtype, scale)
    else:
        out = inpt.as_tensor().to(dtype)
    return tv_tensors.wrap(out, like=inpt)


def normalize(inpt, mean: Sequence[float], std: Sequence[float]):
    if not _image_like(inpt):
        raise TypeError(f"normalize takes images and videos, got "
                        f"{type(inpt).__name__}")
    if isinstance(inpt, tv_tensors.TVTensor):
        return tv_tensors.wrap(normalize_image(inpt.as_tensor(), mean, std),
                               like=inpt)
    return normalize_image(inpt, mean, std)


def sanitize_bounding_boxes(boxes, format=None,
                            canvas_size: Optional[Tuple[int, int]] = None,
                            min_size: float = 1.0, min_area: float = 1.0):
    """(boxes, valid): ``valid`` ``[N]`` marks the boxes at least
    ``min_size`` wide and high, of area at least ``min_area``, and inside
    the canvas at every coordinate (a box that sticks out is dropped:
    clamp first to keep it). The boxes come back as they were;
    ``format`` and ``canvas_size`` go with a plain tensor only."""
    if isinstance(boxes, tv_tensors.BoundingBoxes):
        if format is not None or canvas_size is not None:
            raise ValueError("format and canvas_size must not be passed with "
                             "BoundingBoxes")
        fmt, (h, w) = boxes.format.value.lower(), boxes.canvas_size
        data = boxes.as_tensor()
    else:
        if format is None or canvas_size is None:
            raise ValueError("format and canvas_size are required for plain "
                             "tensors")
        fmt = (format.value if isinstance(format, tv_tensors.BoundingBoxFormat)
               else str(format)).lower()
        (h, w), data = canvas_size, boxes
    xyxy = box_convert(data.float(), fmt, "xyxy")
    ws = xyxy[..., 2] - xyxy[..., 0]
    hs = xyxy[..., 3] - xyxy[..., 1]
    valid = (ws >= min_size) & (hs >= min_size) & (ws * hs >= min_area)
    valid &= (xyxy >= 0).all(-1)
    valid &= (xyxy[..., 0] <= w) & (xyxy[..., 2] <= w)
    valid &= (xyxy[..., 1] <= h) & (xyxy[..., 3] <= h)
    return boxes, valid
