"""Transforms (counterpart of ``vision_tpu/transforms``): the inference
presets that weights carry, and the functionals they call."""

from vision_tpu_torch.transforms import v2
from vision_tpu_torch.transforms._presets import (
    ImageClassification,
    ObjectDetection,
)

__all__ = ["ImageClassification", "ObjectDetection", "v2"]
