"""Keypoint R-CNN trained on warped samples: the augmentation chain of
``chip_smoke.py``'s ``keypoint_warp_train`` phase, and its batch.

``keypoint_warp_chain()`` is a random affine warp (rotation up to 15
degrees, translation up to a tenth of each side, scale in [0.75, 1.25],
shear up to 8 degrees), a perspective warp half the time, a horizontal
flip half the time with COCO person's keypoint flip map, the boxes and
keypoints clamped into the canvas, and the boxes that became degenerate
dropped with their labels, masks and keypoints. ``transforms`` is the
namespace it is built from (the port's ``transforms.v2`` by default; the
JAX package's, with the same names, builds its twin for a test)."""

from __future__ import annotations

from typing import Any, List, Sequence

import torch

from vision_tpu_torch.parallel.presets import COCO_PERSON_KEYPOINT_FLIP_INDICES
from vision_tpu_torch.transforms import v2 as T
from vision_tpu_torch.transforms.v2 import functional as F

__all__ = ["keypoint_warp_chain", "to_float_samples"]


def keypoint_warp_chain(transforms: Any = T):
    return transforms.Compose([
        transforms.RandomAffine(degrees=15, translate=(0.1, 0.1),
                                scale=(0.75, 1.25), shear=8),
        transforms.RandomPerspective(0.2, p=0.5),
        transforms.RandomHorizontalFlip(
            keypoint_flip_indices=COCO_PERSON_KEYPOINT_FLIP_INDICES),
        transforms.ClampBoundingBoxes(),
        transforms.ClampKeyPoints(),
        transforms.SanitizeBoundingBoxes(),
    ])


def to_float_samples(samples: Sequence[Any]) -> List[Any]:
    """Each ``(Image, target)`` as Keypoint R-CNN's ``collate_detection``
    takes it: the uint8 image scaled into [0, 1] in f32; of the target the
    boxes, the keypoints and the labels, every label 1 (a person: the
    model has two classes)."""
    out = []
    for img, target in samples:
        target = {"boxes": target["boxes"], "keypoints": target["keypoints"],
                  "labels": torch.ones_like(target["labels"])}
        out.append((F.to_dtype(img, torch.float32, scale=True), target))
    return out
