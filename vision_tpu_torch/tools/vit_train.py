"""The ViTs served and trained on the card as ``chip_smoke.py``'s
``vit_*`` phases and ``profile_vit_train`` run them: the seeded model, the
seeded uint8 frames, and the recipe's train step (``RecipeStep``: the
device augmentation, the step with clipping, the schedule and the EMA
update, every step).

Cells: ViT-B/16 (BASELINE config 2) at 224 px, served at batch 64 and
trained at batch 128 from the JAX bench's 256x256 frames
(``bench.py:474-476``); the long-sequence ViTs past the flash-attention
gate, at their SWAG checkpoints' sizes (``ViT_L_16_Weights.
IMAGENET1K_SWAG_E2E_V1`` at 512 px, 1,025 tokens; ``ViT_B_16_Weights.
IMAGENET1K_SWAG_E2E_V1`` at 384 px, 577 tokens): ViT-L/16 at 512 served at
batch 32, ViT-B/16 at 384 trained at batch 64 (``--train-crop-size 384``)
from 448x448 frames (about the 224 cell's frame-to-crop ratio).
"""

from __future__ import annotations

from typing import Dict, Optional, Union

import numpy as np
import torch

from vision_tpu_torch.models import get_model
from vision_tpu_torch.models._api import resolve_device
from vision_tpu_torch.models.vision_transformer import (
    VisionTransformer,
    init_weights,
)
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
SERVE_BATCH_512 = 32  # ViT-L/16 at 512 px, served
TRAIN_BATCH_384 = 64  # ViT-B/16 at 384 px, trained
FRAME_384 = 448
CROP_384 = 384
IMAGENET_TRAIN_IMAGES = 1_281_167
HEAD_STD = 0.02

_Device = Union[str, torch.device, None]


def seeded_vit(device: _Device = None, name: str = "vit_b_16",
               image_size: int = CROP) -> torch.nn.Module:
    """The builder ``name``'s model at ``image_size`` px, drawn as the
    builder draws it with ``seed=0`` (``init_weights`` from a CPU generator
    seeded 0; the builders take their SWAG sizes only with the
    checkpoints), with ``heads.head``'s weight drawn normal (std 0.02, seed
    1): published, it starts at zero, which would make every logit 0 and
    leave the trunk without a gradient at step 1."""
    ref = get_model(name, device="meta")
    block = ref.encoder.layers[0]
    model = VisionTransformer(
        image_size, ref.patch_size, len(ref.encoder.layers),
        block.self_attention.num_heads, ref.hidden_dim,
        block.mlp[0].out_features)
    init_weights(model, torch.Generator().manual_seed(0))
    model = model.eval().to(resolve_device(device))
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


def recipe_augment(random_erase: float = 0.0, crop_size: int = CROP):
    """The recipe's ``DeviceAugment`` (``VIT_B_16_RECIPE``'s flags, crop
    ``crop_size``, as ``--train-crop-size``); ``random_erase`` as
    ``--random-erase``."""
    r = VIT_B_16_RECIPE
    return make_device_augment(
        crop_size=crop_size, auto_augment=r["auto_augment"],
        ra_magnitude=r["ra_magnitude"], interpolation=r["interpolation"],
        random_erase=random_erase, mixup_alpha=r["mixup_alpha"],
        cutmix_alpha=r["cutmix_alpha"], num_classes=1000)


class RecipeStep:
    """One step of the recipe on a batch of raw frames: augment, forward,
    backward, clipping, AdamW, the schedule, and the EMA update (every
    step, as the JAX bench times it; the recipe updates every 32nd).
    ``compute_dtype=torch.bfloat16`` is ``--amp``. The schedule runs at the
    steps an epoch of ImageNet-1k at ``batch_size``; the augmentation crops
    to ``crop_size``."""

    def __init__(self, model: torch.nn.Module,
                 compute_dtype: Optional[torch.dtype] = None,
                 batch_size: int = TRAIN_BATCH, crop_size: int = CROP):
        r = VIT_B_16_RECIPE
        self.model = model
        self.augment = recipe_augment(crop_size=crop_size)
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
