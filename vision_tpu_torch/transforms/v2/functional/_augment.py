"""Augment functionals (counterpart of
``vision_tpu/transforms/v2/functional/_augment.py``): ``erase`` and
``jpeg``."""

from __future__ import annotations

from typing import Union

import numpy as np
import torch

from vision_tpu_torch import tv_tensors

__all__ = ["erase", "jpeg", "jpeg_image"]

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


def jpeg_image(image: torch.Tensor, quality: int) -> torch.Tensor:
    """The JPEG encode and decode round trip of uint8 ``[..., C, H, W]``
    images (C 1 or 3) at ``quality``, through the port's host codec
    (``io/_codecs.py``: baseline, libjpeg's default tables and sampling).
    An image on the card goes to the host and back: one host
    synchronisation a call (the copy back is from pinned memory and does
    not wait)."""
    # the codec's module loads the io package, which loads the models:
    # imported at the call, not with the transforms
    from vision_tpu_torch.io import _codecs

    if image.dtype != torch.uint8:
        raise ValueError(f"jpeg expects uint8 input, got {image.dtype}")
    host = image.detach().to("cpu").reshape(-1, *image.shape[-3:]).numpy()
    outs = [_codecs.decode_jpeg_native(_codecs.encode_jpeg_native(
        np.ascontiguousarray(im.transpose(1, 2, 0)), quality=int(quality)))
        for im in host]
    out = torch.from_numpy(np.stack([o.transpose(2, 0, 1) for o in outs]))
    out = out.reshape(image.shape)
    if image.device.type == "cpu":
        return out
    return out.pin_memory().to(image.device, non_blocking=True)


def jpeg(inpt, quality: int):
    """``jpeg_image`` of images, videos and plain tensors (as their type);
    masks, boxes and keypoints as they are."""
    if not isinstance(inpt, tv_tensors.TVTensor):
        return jpeg_image(inpt, quality)
    if isinstance(inpt, (tv_tensors.Image, tv_tensors.Video)):
        return tv_tensors.wrap(jpeg_image(inpt.as_tensor(), quality), like=inpt)
    return inpt
