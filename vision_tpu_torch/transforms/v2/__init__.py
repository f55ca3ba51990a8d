"""Transforms v2 (counterpart of ``vision_tpu/transforms/v2``): the batch
transforms of the classification training recipe, and the functionals."""

from vision_tpu_torch.transforms.v2 import functional
from vision_tpu_torch.transforms.v2._augment import CutMix, MixUp, RandomErasing
from vision_tpu_torch.transforms.v2._auto_augment import RandAugment
from vision_tpu_torch.transforms.v2._batch_augment import apply_ops_batched
from vision_tpu_torch.transforms.v2._container import Compose, RandomChoice
from vision_tpu_torch.transforms.v2._geometry import (
    RandomHorizontalFlip,
    RandomResizedCrop,
)
from vision_tpu_torch.transforms.v2._misc import Normalize, ToDtype
from vision_tpu_torch.transforms.v2._transform import Transform, to_device

__all__ = [
    "Compose",
    "CutMix",
    "MixUp",
    "Normalize",
    "RandAugment",
    "RandomChoice",
    "RandomErasing",
    "RandomHorizontalFlip",
    "RandomResizedCrop",
    "ToDtype",
    "Transform",
    "apply_ops_batched",
    "functional",
    "to_device",
]
