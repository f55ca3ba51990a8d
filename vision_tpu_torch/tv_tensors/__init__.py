"""Typed tensors (counterpart of ``vision_tpu/tv_tensors``): ``Image``,
``Video``, ``Mask``, ``BoundingBoxes``, ``KeyPoints``; and
``wrap_dataset_for_transforms_v2``, which types a dataset's samples
(``_dataset_wrapper.py``)."""

from vision_tpu_torch.tv_tensors._tv_tensor import (
    BoundingBoxes,
    BoundingBoxFormat,
    Image,
    KeyPoints,
    Mask,
    TVTensor,
    Video,
    is_rotated_bounding_format,
    set_return_type,
    wrap,
)
from vision_tpu_torch.tv_tensors._dataset_wrapper import (
    wrap_dataset_for_transforms_v2,
)

__all__ = [
    "BoundingBoxFormat",
    "BoundingBoxes",
    "Image",
    "KeyPoints",
    "Mask",
    "TVTensor",
    "Video",
    "is_rotated_bounding_format",
    "set_return_type",
    "wrap",
    "wrap_dataset_for_transforms_v2",
]
