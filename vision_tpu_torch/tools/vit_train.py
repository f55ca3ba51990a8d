"""ViT-B/16 (BASELINE config 2) served and trained on the card as
``chip_smoke.py``'s ``vit_b16_*`` phases and ``profile_vit_train`` run it:
the seeded model, the seeded uint8 frames of the JAX bench
(``bench.py:474-476``: 256x256, batch 128), and the recipe's train step
(``RecipeStep``: the device augmentation, the step with clipping, the
schedule and the EMA update, every step).
"""

from __future__ import annotations

from typing import Dict, Optional, Union

import numpy as np
import torch

from vision_tpu_torch.models import get_model
from vision_tpu_torch.models._api import resolve_device
from vision_tpu_torch.parallel import (
    VIT_B_16_RECIPE,
    ExponentialMovingAverage,
    ema_decay,
    lr_schedule,
    make_device_augment,
    make_lr_scheduler,
    make_optimizer,
    make_train_step,
)

__all__ = ["RecipeStep", "frames", "recipe_augment", "seeded_vit"]

SERVE_BATCH = 64  # bench.py:1124-1135, the ViT-B/16 forward
TRAIN_BATCH = 128  # bench.py:474, the train pipeline
FRAME = 256
CROP = 224
IMAGENET_TRAIN_IMAGES = 1_281_167
HEAD_STD = 0.02

_Device = Union[str, torch.device, None]


def seeded_vit(device: _Device = None) -> torch.nn.Module:
    """``vit_b_16(seed=0)`` with ``heads.head``'s weight drawn normal (std
    0.02, seed 1): published, it starts at zero, which would make every
    logit 0 and leave the trunk without a gradient at step 1."""
    model = get_model("vit_b_16", seed=0, device=device)
    head = model.heads.head.weight
    w = torch.empty(head.shape).normal_(
        0.0, HEAD_STD, generator=torch.Generator().manual_seed(1))
    with torch.no_grad():
        head.copy_(w)
    return model


def frames(n: int = TRAIN_BATCH, size: int = FRAME, device: _Device = None
           ) -> Dict[str, torch.Tensor]:
    """``{"image": uint8 [n, 3, size, size], "label": int64 [n]}`` from a
    numpy stream seeded 0, as the JAX bench makes its frames."""
    rng = np.random.RandomState(0)
    images = rng.randint(0, 256, (n, size, size, 3)).astype(np.uint8)
    labels = rng.randint(0, 1000, (n,))
    device = resolve_device(device)
    return {"image": torch.from_numpy(images).permute(0, 3, 1, 2).contiguous()
            .to(device),
            "label": torch.from_numpy(labels).to(device)}


def recipe_augment(random_erase: float = 0.0):
    """The recipe's ``DeviceAugment`` (``VIT_B_16_RECIPE``'s flags, crop 224);
    ``random_erase`` as ``--random-erase``."""
    r = VIT_B_16_RECIPE
    return make_device_augment(
        crop_size=CROP, auto_augment=r["auto_augment"],
        ra_magnitude=r["ra_magnitude"], interpolation=r["interpolation"],
        random_erase=random_erase, mixup_alpha=r["mixup_alpha"],
        cutmix_alpha=r["cutmix_alpha"], num_classes=1000)


class RecipeStep:
    """One step of the recipe on a batch of raw frames: augment, forward,
    backward, clipping, AdamW, the schedule, and the EMA update (every
    step, as the JAX bench times it; the recipe updates every 32nd).
    ``compute_dtype=torch.bfloat16`` is ``--amp``. The schedule runs at the
    steps an epoch of ImageNet-1k at ``batch_size``."""

    def __init__(self, model: torch.nn.Module,
                 compute_dtype: Optional[torch.dtype] = None,
                 batch_size: int = TRAIN_BATCH):
        r = VIT_B_16_RECIPE
        self.model = model
        self.augment = recipe_augment()
        self.optimizer = make_optimizer(model, lr=r["lr"],
                                        weight_decay=r["weight_decay"])
        self.scheduler = make_lr_scheduler(self.optimizer, lr_schedule(
            r["lr"], r["epochs"], IMAGENET_TRAIN_IMAGES // batch_size,
            r["lr_min"], r["lr_warmup_epochs"], r["lr_warmup_decay"]))
        self.train_step = make_train_step(
            model, self.optimizer, label_smoothing=r["label_smoothing"],
            compute_dtype=compute_dtype, clip_grad_norm=r["clip_grad_norm"])
        self.ema = ExponentialMovingAverage(model, ema_decay(
            r["model_ema_decay"], batch_size, r["model_ema_steps"],
            r["epochs"]))

    def __call__(self, raw: Dict[str, torch.Tensor],
                 generator: torch.Generator) -> Dict[str, torch.Tensor]:
        metrics = self.train_step(self.augment(raw, generator))
        self.scheduler.step()
        self.ema.update(self.model)
        return metrics
