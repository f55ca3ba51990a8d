"""Misc transforms (counterpart of ``vision_tpu/transforms/v2/_misc.py``):
``ToDtype`` and ``Normalize`` for batches and samples; for samples
``ConvertBoundingBoxFormat``, ``ClampBoundingBoxes``,
``SanitizeBoundingBoxes``, ``Identity`` and ``Lambda``."""

from __future__ import annotations

from typing import Any, Callable, Sequence, Union

import torch
import torch.utils._pytree as pytree

from vision_tpu_torch import tv_tensors
from vision_tpu_torch.transforms.v2 import functional as F
from vision_tpu_torch.transforms.v2._transform import Transform
from vision_tpu_torch.transforms.v2.functional._misc import (
    normalize_image,
    to_dtype_image,
)

__all__ = ["ClampBoundingBoxes", "ConvertBoundingBoxFormat", "Identity",
           "Lambda", "Normalize", "SanitizeBoundingBoxes", "ToDtype"]

_IMAGE_TYPES = (tv_tensors.Image, tv_tensors.Video, torch.Tensor)


class ToDtype(Transform):
    """``dtype`` for images and videos (and the plain image tensor), with
    ``scale`` the value range mapped; or a dict ``{type: dtype}`` with an
    optional ``"others"`` entry, None leaving a type as it is. Masks, boxes
    and keypoints keep their type unless the dict names them."""

    def __init__(self, dtype=torch.float32, scale: bool = False):
        self.dtype = dtype
        self.scale = scale

    def transform(self, images, params):
        return to_dtype_image(images, self.dtype, self.scale)

    def transform_sample(self, inpt, params):
        if isinstance(self.dtype, dict):
            for cls, dt in self.dtype.items():
                if cls != "others" and isinstance(inpt, cls):
                    return inpt if dt is None else F.to_dtype(inpt, dt, self.scale)
            dt = self.dtype.get("others")
            return inpt if dt is None else F.to_dtype(inpt, dt, self.scale)
        if isinstance(inpt, (tv_tensors.Image, tv_tensors.Video)) or not (
                isinstance(inpt, tv_tensors.TVTensor)):
            return F.to_dtype(inpt, self.dtype, self.scale)
        return inpt

    def __repr__(self) -> str:
        return f"ToDtype({self.dtype}, scale={self.scale})"


class Normalize(Transform):
    _transformed_types = _IMAGE_TYPES

    def __init__(self, mean: Sequence[float], std: Sequence[float]):
        self.mean = [float(m) for m in mean]
        self.std = [float(s) for s in std]

    def transform(self, images, params):
        return normalize_image(images, self.mean, self.std)

    def transform_sample(self, inpt, params):
        return F.normalize(inpt, self.mean, self.std)

    def __repr__(self) -> str:
        return f"Normalize(mean={self.mean}, std={self.std})"


class Identity(Transform):
    def transform_sample(self, inpt, params):
        return inpt


class Lambda(Transform):
    """``lambd`` on each leaf of the given ``types`` (every tensor when none
    is given)."""

    def __init__(self, lambd: Callable, *types):
        self.lambd = lambd
        if types:
            self._transformed_types = types

    def transform_sample(self, inpt, params):
        return self.lambd(inpt)


class ConvertBoundingBoxFormat(Transform):
    _transformed_types = (tv_tensors.BoundingBoxes,)

    def __init__(self, format):
        self.format = format

    def transform_sample(self, inpt, params):
        return F.convert_bounding_box_format(inpt, new_format=self.format)


class ClampBoundingBoxes(Transform):
    _transformed_types = (tv_tensors.BoundingBoxes,)

    def __init__(self, clamping_mode: str = "auto"):
        self.clamping_mode = clamping_mode

    def transform_sample(self, inpt, params):
        return F.clamp_bounding_boxes(inpt, clamping_mode=self.clamping_mode)


class SanitizeBoundingBoxes(Transform):
    """Drop the boxes ``functional.sanitize_bounding_boxes`` marks, with
    their labels (``labels_getter``: by default ``"labels"`` of a dict
    sample, or of the dict second in a pair) and the masks and keypoints
    of as many rows. The kept rows are read on the host: one host
    synchronisation a call for boxes on the card."""

    def __init__(self, min_size: float = 1.0, min_area: float = 1.0,
                 labels_getter: Union[Callable, str, None] = "default"):
        self.min_size = min_size
        self.min_area = min_area
        self.labels_getter = labels_getter

    def _get_labels(self, sample):
        if callable(self.labels_getter):
            return self.labels_getter(sample)
        if self.labels_getter == "default":
            if isinstance(sample, dict) and "labels" in sample:
                return sample["labels"]
            if (isinstance(sample, (list, tuple)) and len(sample) == 2
                    and isinstance(sample[1], dict) and "labels" in sample[1]):
                return sample[1]["labels"]
        return None

    def forward_sample(self, sample: Any, generator=None) -> Any:
        labels = self._get_labels(sample)
        flat, spec = pytree.tree_flatten(sample)
        boxes = next((x for x in flat if isinstance(x, tv_tensors.BoundingBoxes)),
                     None)
        if boxes is None:
            return sample
        _, valid = F.sanitize_bounding_boxes(boxes, min_size=self.min_size,
                                             min_area=self.min_area)
        keep = valid.nonzero()[:, 0]  # the one host synchronisation
        n = len(valid)

        def rows(x):
            return x.index_select(0, keep if x.device == keep.device
                                  else keep.to(x.device))

        def fixup(x):
            if isinstance(x, tv_tensors.BoundingBoxes):
                return tv_tensors.wrap(rows(x.as_tensor()), like=x)
            if labels is not None and x is labels:
                return rows(x)
            if isinstance(x, (tv_tensors.Mask, tv_tensors.KeyPoints)) and (
                    x.ndim > 0 and x.shape[0] == n):
                return tv_tensors.wrap(rows(x.as_tensor()), like=x)
            return x

        return pytree.tree_unflatten([fixup(x) for x in flat], spec)
