"""Training steps (counterpart of ``vision_tpu/parallel``; one device)."""

from vision_tpu_torch.parallel.train import (
    cross_entropy_loss,
    make_detection_train_step,
    make_train_step,
)

__all__ = ["cross_entropy_loss", "make_detection_train_step", "make_train_step"]
