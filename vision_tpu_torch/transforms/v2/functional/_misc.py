"""Value functionals (counterpart of
``vision_tpu/transforms/v2/functional/_misc.py``): ``normalize_image`` and
``to_dtype_image``, on ``(..., C, H, W)`` tensors."""

from __future__ import annotations

import functools
from typing import Sequence, Tuple

import torch

__all__ = ["normalize_image", "to_dtype_image"]

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
