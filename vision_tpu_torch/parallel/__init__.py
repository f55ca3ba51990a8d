"""Training steps and the classification recipe (counterpart of
``vision_tpu/parallel`` and of the device side of
``references/classification``; one device)."""

from vision_tpu_torch.parallel.recipe import (
    VIT_B_16_RECIPE,
    DeviceAugment,
    ExponentialMovingAverage,
    decay_groups,
    ema_decay,
    lr_schedule,
    make_device_augment,
    make_lr_scheduler,
    make_optimizer,
)
from vision_tpu_torch.parallel.train import (
    cross_entropy_loss,
    make_detection_train_step,
    make_train_step,
)

__all__ = [
    "DeviceAugment",
    "ExponentialMovingAverage",
    "VIT_B_16_RECIPE",
    "cross_entropy_loss",
    "decay_groups",
    "ema_decay",
    "lr_schedule",
    "make_detection_train_step",
    "make_device_augment",
    "make_lr_scheduler",
    "make_optimizer",
    "make_train_step",
]
