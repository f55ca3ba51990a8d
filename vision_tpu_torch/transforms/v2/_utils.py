"""Queries over a flattened sample (counterpart of
``vision_tpu/transforms/v2/_utils.py``, torchvision's ``_utils.py:156-240``).
Images are ``[..., C, H, W]``, masks ``[..., H, W]``; boxes and keypoints
carry their canvas."""

from __future__ import annotations

from typing import Any, List, Tuple

import torch

from vision_tpu_torch import tv_tensors

__all__ = [
    "check_type",
    "get_bounding_boxes",
    "get_keypoints",
    "has_all",
    "has_any",
    "query_chw",
    "query_size",
]


def check_type(obj: Any, types_or_checks) -> bool:
    """Whether ``obj`` is an instance of one of the types, or passes one of
    the checks."""
    for t in types_or_checks:
        if isinstance(obj, t) if isinstance(t, type) else t(obj):
            return True
    return False


def has_any(flat_inputs: List[Any], *types_or_checks) -> bool:
    return any(check_type(x, types_or_checks) for x in flat_inputs)


def has_all(flat_inputs: List[Any], *types_or_checks) -> bool:
    return all(any(check_type(x, (t,)) for x in flat_inputs)
               for t in types_or_checks)


def get_bounding_boxes(flat_inputs: List[Any]) -> tv_tensors.BoundingBoxes:
    boxes = [x for x in flat_inputs if isinstance(x, tv_tensors.BoundingBoxes)]
    if len(boxes) != 1:
        raise ValueError(f"expected exactly one BoundingBoxes, found {len(boxes)}")
    return boxes[0]


def get_keypoints(flat_inputs: List[Any]) -> tv_tensors.KeyPoints:
    kps = [x for x in flat_inputs if isinstance(x, tv_tensors.KeyPoints)]
    if len(kps) != 1:
        raise ValueError(f"expected exactly one KeyPoints, found {len(kps)}")
    return kps[0]


def _image_like(x: Any) -> bool:
    return isinstance(x, (tv_tensors.Image, tv_tensors.Video)) or (
        isinstance(x, torch.Tensor) and not isinstance(x, tv_tensors.TVTensor)
        and x.ndim >= 3)


def query_size(flat_inputs: List[Any]) -> Tuple[int, int]:
    """The one (H, W) of the sample's images, videos, masks and canvases."""
    sizes = set()
    for x in flat_inputs:
        if isinstance(x, (tv_tensors.BoundingBoxes, tv_tensors.KeyPoints)):
            sizes.add(tuple(x.canvas_size))
        elif isinstance(x, tv_tensors.Mask) or _image_like(x):
            sizes.add(tuple(x.shape[-2:]))
    if not sizes:
        raise TypeError("no image, video, mask, boxes or keypoints found")
    if len(sizes) > 1:
        raise ValueError(f"inconsistent sizes: {sorted(sizes)}")
    return sizes.pop()


def query_chw(flat_inputs: List[Any]) -> Tuple[int, int, int]:
    """The one (C, H, W) of the sample's images and videos."""
    chws = {tuple(x.shape[-3:]) for x in flat_inputs if _image_like(x)}
    if not chws:
        raise TypeError("no image or video found")
    if len(chws) > 1:
        raise ValueError(f"inconsistent shapes: {sorted(chws)}")
    return chws.pop()
