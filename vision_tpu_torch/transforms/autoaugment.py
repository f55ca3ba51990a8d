"""The v1 module path ``transforms.autoaugment`` (counterpart of
``vision_tpu/transforms/autoaugment.py``): the auto-augment classes of
v2."""

from vision_tpu_torch.transforms.v2._auto_augment import (  # noqa: F401
    AugMix,
    AutoAugment,
    AutoAugmentPolicy,
    RandAugment,
    TrivialAugmentWide,
)
