"""Augment functionals (counterpart of
``vision_tpu/transforms/v2/functional/_augment.py``): ``erase``."""

from __future__ import annotations

from typing import Union

import torch

__all__ = ["erase"]

_Box = Union[int, float, torch.Tensor]


def erase(image: torch.Tensor, i: _Box, j: _Box, h: _Box, w: _Box,
          v: Union[float, torch.Tensor]) -> torch.Tensor:
    """``image`` (``[..., C, H, W]``) with rows ``[i, i + h)`` and columns
    ``[j, j + w)`` set to ``v`` (a number, or a tensor that broadcasts
    against the image). The box may be numbers, or ``[N]``
    tensors for one box an image of an ``[N, C, H, W]`` batch; an empty
    box changes nothing. A new tensor is returned."""
    rows = torch.arange(image.shape[-2], device=image.device, dtype=torch.float32)
    cols = torch.arange(image.shape[-1], device=image.device, dtype=torch.float32)

    def per_image(t):
        if isinstance(t, torch.Tensor) and t.dim() == 1:
            return t.to(image.device, torch.float32).view(-1, 1, 1, 1)
        return t

    i, j, h, w = (per_image(t) for t in (i, j, h, w))
    inside = (((rows[:, None] >= i) & (rows[:, None] < i + h))
              & ((cols >= j) & (cols < j + w)))
    if not isinstance(v, torch.Tensor):
        v = torch.full((), v, dtype=image.dtype, device=image.device)
    return torch.where(inside, v.to(image.dtype), image)
