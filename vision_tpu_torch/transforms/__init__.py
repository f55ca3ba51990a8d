"""Transforms (counterpart of ``vision_tpu/transforms``): the inference
presets that weights carry, ``v2``, and the v1 surface: each v1 class is
its v2 class (``transforms.Compose``, ``transforms.TenCrop``, ...), beside
the v1-only ``ToTensor``, ``ConvertImageDtype`` and ``InterpolationMode``;
``transforms.functional`` is ``v2.functional``, which carries the v1
functional names too (``hflip``, ``to_tensor``, ``get_image_size``)."""

import sys as _sys

from vision_tpu_torch.transforms import v2
from vision_tpu_torch.transforms._compat import (
    ConvertImageDtype,
    InterpolationMode,
    ToTensor,
)
from vision_tpu_torch.transforms._presets import (
    ImageClassification,
    ObjectDetection,
    OpticalFlow,
    SemanticSegmentation,
    VideoClassification,
)
from vision_tpu_torch.transforms.v2 import functional
from vision_tpu_torch.transforms.v2 import (
    AugMix,
    AutoAugment,
    CenterCrop,
    ColorJitter,
    Compose,
    ElasticTransform,
    FiveCrop,
    GaussianBlur,
    GaussianNoise,
    Grayscale,
    Lambda,
    LinearTransformation,
    Normalize,
    Pad,
    PILToTensor,
    RandAugment,
    RandomAdjustSharpness,
    RandomAffine,
    RandomApply,
    RandomAutocontrast,
    RandomChoice,
    RandomCrop,
    RandomEqualize,
    RandomErasing,
    RandomGrayscale,
    RandomHorizontalFlip,
    RandomInvert,
    RandomOrder,
    RandomPerspective,
    RandomPosterize,
    RandomResizedCrop,
    RandomRotation,
    RandomSolarize,
    RandomVerticalFlip,
    Resize,
    TenCrop,
    ToPILImage,
    TrivialAugmentWide,
)

# ``import vision_tpu_torch.transforms.functional as F``, the v1 path
_sys.modules[__name__ + ".functional"] = functional

__all__ = sorted(n for n in globals() if not n.startswith("_"))
