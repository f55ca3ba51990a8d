"""Transforms v2 (counterpart of ``vision_tpu/transforms/v2``): the batch
transforms of the classification training recipe, the per-sample
transforms of the reference recipes (images, videos, masks, boxes and
keypoints moved together; ``_transform.py`` says which inputs are a batch
and which a sample), and the functionals."""

from vision_tpu_torch.transforms.v2 import functional
from vision_tpu_torch.transforms.v2._augment import CutMix, MixUp, RandomErasing
from vision_tpu_torch.transforms.v2._auto_augment import (
    AugMix,
    AutoAugment,
    AutoAugmentPolicy,
    RandAugment,
    TrivialAugmentWide,
)
from vision_tpu_torch.transforms.v2._batch_augment import apply_ops_batched
from vision_tpu_torch.transforms.v2._color import (
    RGB,
    ColorJitter,
    Grayscale,
    RandomAdjustSharpness,
    RandomAutocontrast,
    RandomChannelPermutation,
    RandomEqualize,
    RandomGrayscale,
    RandomInvert,
    RandomPhotometricDistort,
    RandomPosterize,
    RandomSolarize,
)
from vision_tpu_torch.transforms.v2._container import (
    Compose,
    RandomApply,
    RandomChoice,
    RandomOrder,
)
from vision_tpu_torch.transforms.v2._geometry import (
    CenterCrop,
    Pad,
    RandomCrop,
    RandomHorizontalFlip,
    RandomIoUCrop,
    RandomResize,
    RandomResizedCrop,
    RandomShortestSize,
    RandomVerticalFlip,
    RandomZoomOut,
    Resize,
    ScaleJitter,
)
from vision_tpu_torch.transforms.v2._misc import (
    ClampBoundingBoxes,
    ConvertBoundingBoxFormat,
    Identity,
    Lambda,
    Normalize,
    SanitizeBoundingBoxes,
    ToDtype,
)
from vision_tpu_torch.transforms.v2._temporal import UniformTemporalSubsample
from vision_tpu_torch.transforms.v2._transform import (
    Record,
    Replay,
    Transform,
    is_batch,
    to_device,
)

__all__ = [
    "AugMix",
    "AutoAugment",
    "AutoAugmentPolicy",
    "CenterCrop",
    "ClampBoundingBoxes",
    "ColorJitter",
    "Compose",
    "ConvertBoundingBoxFormat",
    "CutMix",
    "Grayscale",
    "Identity",
    "Lambda",
    "MixUp",
    "Normalize",
    "Pad",
    "RGB",
    "RandAugment",
    "RandomAdjustSharpness",
    "RandomApply",
    "RandomAutocontrast",
    "RandomChannelPermutation",
    "RandomChoice",
    "RandomCrop",
    "RandomEqualize",
    "RandomErasing",
    "RandomGrayscale",
    "RandomHorizontalFlip",
    "RandomInvert",
    "RandomIoUCrop",
    "RandomOrder",
    "RandomPhotometricDistort",
    "RandomPosterize",
    "RandomResize",
    "RandomResizedCrop",
    "RandomShortestSize",
    "RandomSolarize",
    "RandomVerticalFlip",
    "RandomZoomOut",
    "Record",
    "Replay",
    "Resize",
    "SanitizeBoundingBoxes",
    "ScaleJitter",
    "ToDtype",
    "Transform",
    "UniformTemporalSubsample",
    "apply_ops_batched",
    "functional",
    "is_batch",
    "to_device",
]
