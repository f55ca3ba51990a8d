"""Misc transforms (counterpart of ``vision_tpu/transforms/v2/_misc.py``):
``ToDtype`` and ``Normalize`` for batches and samples; for samples
``ConvertBoundingBoxFormat``, ``ClampBoundingBoxes``, ``ClampKeyPoints``,
``SanitizeBoundingBoxes``, ``SanitizeKeyPoints``, ``SetClampingMode``,
``LinearTransformation``, ``Identity`` and ``Lambda``."""

from __future__ import annotations

from typing import Any, Callable, Dict, Sequence, Union

import torch
import torch.utils._pytree as pytree

from vision_tpu_torch import tv_tensors
from vision_tpu_torch.transforms.v2 import functional as F
from vision_tpu_torch.transforms.v2._transform import Transform
from vision_tpu_torch.transforms.v2.functional._misc import (
    normalize_image,
    to_dtype_image,
)

__all__ = ["ClampBoundingBoxes", "ClampKeyPoints", "ConvertBoundingBoxFormat",
           "Identity", "Lambda", "LinearTransformation", "Normalize",
           "SanitizeBoundingBoxes", "SanitizeKeyPoints", "SetClampingMode",
           "ToDtype"]

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


def _labels(labels_getter, sample):
    """The labels ``labels_getter`` names: a callable's result, or with
    ``"default"`` the ``"labels"`` of a dict sample or of the dict second
    in a pair; else None."""
    if callable(labels_getter):
        return labels_getter(sample)
    if labels_getter == "default":
        if isinstance(sample, dict) and "labels" in sample:
            return sample["labels"]
        if (isinstance(sample, (list, tuple)) and len(sample) == 2
                and isinstance(sample[1], dict) and "labels" in sample[1]):
            return sample[1]["labels"]
    return None


def _rows(x: torch.Tensor, keep: torch.Tensor) -> torch.Tensor:
    return x.index_select(0, keep if x.device == keep.device
                          else keep.to(x.device))


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

    def forward_sample(self, sample: Any, generator=None) -> Any:
        labels = _labels(self.labels_getter, sample)
        flat, spec = pytree.tree_flatten(sample)
        boxes = next((x for x in flat if isinstance(x, tv_tensors.BoundingBoxes)),
                     None)
        if boxes is None:
            return sample
        _, valid = F.sanitize_bounding_boxes(boxes, min_size=self.min_size,
                                             min_area=self.min_area)
        keep = valid.nonzero()[:, 0]  # the one host synchronisation
        n = len(valid)

        def fixup(x):
            if isinstance(x, tv_tensors.BoundingBoxes):
                return tv_tensors.wrap(_rows(x.as_tensor(), keep), like=x)
            if labels is not None and x is labels:
                return _rows(x, keep)
            if isinstance(x, (tv_tensors.Mask, tv_tensors.KeyPoints)) and (
                    x.ndim > 0 and x.shape[0] == n):
                return tv_tensors.wrap(_rows(x.as_tensor(), keep), like=x)
            return x

        return pytree.tree_unflatten([fixup(x) for x in flat], spec)


class SanitizeKeyPoints(Transform):
    """Drop each keypoint group (a row of ``KeyPoints``' first axis) with a
    point outside the canvas (``functional.sanitize_keypoints``), and the
    labels ``labels_getter`` names (none by default, as in the JAX
    package) of as many rows. Boxes and masks beside them are left as they
    are, as the JAX package leaves them: sanitise the boxes apart. The
    kept rows are read on the host: one host synchronisation a call for
    keypoints on the card."""

    def __init__(self, labels_getter: Union[Callable, str, None] = None):
        self.labels_getter = labels_getter

    def forward_sample(self, sample: Any, generator=None) -> Any:
        labels = _labels(self.labels_getter, sample)
        flat, spec = pytree.tree_flatten(sample)
        kps = next((x for x in flat if isinstance(x, tv_tensors.KeyPoints)), None)
        if kps is None:
            return sample
        _, valid = F.sanitize_keypoints(kps)
        keep = valid.nonzero()[:, 0]  # the one host synchronisation
        n = len(valid)

        def fixup(x):
            if isinstance(x, tv_tensors.KeyPoints) and x.ndim > 0 and x.shape[0] == n:
                return tv_tensors.wrap(_rows(x.as_tensor(), keep), like=x)
            if labels is not None and x is labels:
                return _rows(x, keep)
            return x

        return pytree.tree_unflatten([fixup(x) for x in flat], spec)


class ClampKeyPoints(Transform):
    """Keypoints clamped into the canvas (``functional.clamp_keypoints``)."""

    _transformed_types = (tv_tensors.KeyPoints,)

    def transform_sample(self, inpt, params):
        return F.clamp_keypoints(inpt)


class SetClampingMode(Transform):
    """Boxes given ``clamping_mode`` (``"soft"``, ``"hard"`` or None) for
    the transforms after."""

    _transformed_types = (tv_tensors.BoundingBoxes,)

    def __init__(self, clamping_mode):
        if clamping_mode not in (None, "soft", "hard"):
            raise ValueError(f"clamping_mode must be soft, hard or None, got "
                             f"{clamping_mode}")
        self.clamping_mode = clamping_mode

    def transform_sample(self, inpt, params):
        return tv_tensors.wrap(inpt.as_tensor(), like=inpt,
                               clamping_mode=self.clamping_mode)


class LinearTransformation(Transform):
    """``(x - mean_vector) @ transformation_matrix`` over each image
    flattened in torchvision's ``C, H, W`` order (the JAX package flattens
    ``H, W, C``: its matrix and mean, permuted, are this one's). The
    matrix and mean go to each device once and are kept there."""

    _transformed_types = _IMAGE_TYPES

    def __init__(self, transformation_matrix: torch.Tensor,
                 mean_vector: torch.Tensor):
        matrix = torch.as_tensor(transformation_matrix)
        mean = torch.as_tensor(mean_vector)
        d = matrix.shape[0]
        if matrix.shape != (d, d):
            raise ValueError("transformation_matrix must be square")
        if mean.shape != (d,):
            raise ValueError("mean_vector size must match matrix")
        self.transformation_matrix = matrix
        self.mean_vector = mean
        self._on: Dict[torch.device, tuple] = {}

    def _at(self, device: torch.device):
        if device not in self._on:
            self._on[device] = (self.transformation_matrix.to(device),
                                self.mean_vector.to(device))
        return self._on[device]

    def transform_sample(self, inpt, params):
        x = inpt.as_tensor() if isinstance(inpt, tv_tensors.TVTensor) else inpt
        shape = x.shape
        n = shape[-3] * shape[-2] * shape[-1]
        matrix, mean = self._at(x.device)
        if n != matrix.shape[0]:
            raise ValueError(f"input flat size {n} != matrix dim "
                             f"{matrix.shape[0]}")
        out = ((x.reshape(-1, n) - mean) @ matrix).reshape(shape)
        if isinstance(inpt, tv_tensors.TVTensor):
            return tv_tensors.wrap(out, like=inpt)
        return out
