"""Training steps, the classification recipe, the reference recipes'
train-side presets with the detection collation, and the video recipe
(counterpart of ``vision_tpu/parallel`` and of the train side of
``references/``; one device)."""

from vision_tpu_torch.parallel.presets import (
    ClassificationPresetEval,
    ClassificationPresetTrain,
    DetectionPresetEval,
    DetectionPresetTrain,
    SegmentationPresetEval,
    SegmentationPresetTrain,
    VideoClassificationPresetEval,
    VideoClassificationPresetTrain,
    collate_detection,
)

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
    make_flow_train_step,
    make_segmentation_train_step,
    make_train_step,
    segmentation_criterion,
    sequence_loss,
)
from vision_tpu_torch.parallel.video import (
    VideoAccuracy,
    video_lr_lambda,
    video_recipe_optimizer,
)

__all__ = [
    "ClassificationPresetEval",
    "ClassificationPresetTrain",
    "DetectionPresetEval",
    "DetectionPresetTrain",
    "DeviceAugment",
    "ExponentialMovingAverage",
    "VIT_B_16_RECIPE",
    "cross_entropy_loss",
    "decay_groups",
    "ema_decay",
    "lr_schedule",
    "make_detection_train_step",
    "make_device_augment",
    "make_flow_train_step",
    "make_lr_scheduler",
    "make_optimizer",
    "make_segmentation_train_step",
    "make_train_step",
    "segmentation_criterion",
    "sequence_loss",
    "SegmentationPresetEval",
    "SegmentationPresetTrain",
    "VideoAccuracy",
    "VideoClassificationPresetEval",
    "VideoClassificationPresetTrain",
    "collate_detection",
    "video_lr_lambda",
    "video_recipe_optimizer",
]
