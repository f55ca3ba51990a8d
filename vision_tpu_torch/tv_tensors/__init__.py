"""Typed tensors (counterpart of ``vision_tpu/tv_tensors``): ``Image``,
``Video``, ``Mask``, ``BoundingBoxes``, ``KeyPoints``. The dataset
wrappers (``_dataset_wrapper.py``) wait for the datasets."""

from vision_tpu_torch.tv_tensors._tv_tensor import (
    BoundingBoxes,
    BoundingBoxFormat,
    Image,
    KeyPoints,
    Mask,
    TVTensor,
    Video,
    wrap,
)

__all__ = [
    "BoundingBoxFormat",
    "BoundingBoxes",
    "Image",
    "KeyPoints",
    "Mask",
    "TVTensor",
    "Video",
    "wrap",
]
