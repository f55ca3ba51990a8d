"""The classification training recipe's device-side pieces (counterpart of
``references/classification/train.py`` and ``utils.py``): the augmentation
pipeline on the card (``make_device_augment``, ``train.py:291-345``), the
optimizer with its weight-decay groups (``make_optimizer``, l.374-470), the
learning-rate schedule (l.429-452), and the model EMA (``utils.py:143-164``
with the adjusted decay of ``train.py:556-568``). Clipping is
``make_train_step(clip_grad_norm=...)`` (``parallel/train.py``).

``VIT_B_16_RECIPE`` holds torchvision's published ViT-B/16 flags
(torchvision's ``references/classification/README.md``, ViT section).
"""

from __future__ import annotations

import math
from typing import Any, Callable, Dict, List, Optional, Sequence

import torch
from torch import nn

from vision_tpu_torch.ops.misc import BatchNorm2d, GroupNorm
from vision_tpu_torch.transforms import v2 as T

__all__ = [
    "DeviceAugment",
    "ExponentialMovingAverage",
    "VIT_B_16_RECIPE",
    "decay_groups",
    "ema_decay",
    "lr_schedule",
    "make_device_augment",
    "make_lr_scheduler",
    "make_optimizer",
]

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)
FLIP_P = 0.5  # the horizontal flip folded into the crop

# torchvision's ViT-B/16 recipe; the JAX train.py's defaults fill the rest
# (--ra-magnitude 9, --interpolation bilinear, --model-ema-decay 0.99998,
# --model-ema-steps 32, --lr-min 0, --random-erase 0). make_optimizer is
# its --opt and lr_schedule its --lr-scheduler and --lr-warmup-method.
VIT_B_16_RECIPE: Dict[str, Any] = {
    "epochs": 300, "opt": "adamw", "lr": 0.003, "lr_min": 0.0,
    "weight_decay": 0.3, "lr_scheduler": "cosineannealinglr",
    "lr_warmup_method": "linear", "lr_warmup_epochs": 30,
    "lr_warmup_decay": 0.033, "label_smoothing": 0.11, "mixup_alpha": 0.2,
    "cutmix_alpha": 1.0, "auto_augment": "ra", "ra_magnitude": 9,
    "interpolation": "bilinear", "clip_grad_norm": 1.0, "model_ema": True,
    "model_ema_decay": 0.99998, "model_ema_steps": 32, "amp": True,
}


class DeviceAugment:
    """The recipe's train augmentation on a batch on the card: per image a
    RandomResizedCrop with the horizontal flip folded in (bilinear, no
    antialias), RandAugment (``auto_augment="ra"``), ToDtype + Normalize
    (ImageNet's statistics) and, with ``random_erase > 0``, RandomErasing
    after Normalize; then over the batch MixUp or CutMix, one of the two
    (each that has a positive alpha) picked for the whole batch.

    ``draw(shape, generator)`` makes every draw of a batch ``[N, C, H, W]``
    (a dict a stage: ``"crop"``, ``"auto_augment"``, ``"post"``,
    ``"mix"``); ``apply(batch, draws)`` runs the stages on
    ``{"image": uint8 [N, C, H, W], "label": int [N]}`` and returns
    ``{"image": f32 [N, C, crop, crop], "label"}``, the labels soft ``[N,
    num_classes]`` where a mix ran. ``__call__(batch, generator)`` does
    both. Nothing waits on the host."""

    def __init__(self, crop_size: int = 224, auto_augment: Optional[str] = None,
                 ra_magnitude: int = 9, interpolation: str = "bilinear",
                 random_erase: float = 0.0, mixup_alpha: float = 0.0,
                 cutmix_alpha: float = 0.0, num_classes: int = 1000):
        if auto_augment not in (None, "ra"):
            raise NotImplementedError(
                f"auto_augment={auto_augment!r}: only RandAugment ('ra') is "
                "ported")
        self.crop = T.RandomResizedCrop(crop_size, antialias=True)
        self.auto_augment = (T.RandAugment(magnitude=ra_magnitude,
                                           interpolation=interpolation)
                             if auto_augment == "ra" else None)
        post: List[T.Transform] = [T.ToDtype(torch.float32, scale=True),
                                   T.Normalize(IMAGENET_MEAN, IMAGENET_STD)]
        if random_erase > 0:
            post.append(T.RandomErasing(p=random_erase))
        self.post = T.Compose(post)
        mixers: List[T.Transform] = []
        if mixup_alpha > 0:
            mixers.append(T.MixUp(mixup_alpha, num_classes=num_classes))
        if cutmix_alpha > 0:
            mixers.append(T.CutMix(cutmix_alpha, num_classes=num_classes))
        self.mix = T.RandomChoice(mixers) if mixers else None

    def draw(self, shape: Sequence[int], generator: torch.Generator
             ) -> Dict[str, Any]:
        shape = tuple(shape)
        draws = {"crop": self.crop.draw(shape, generator, flip_p=FLIP_P)}
        shape = self.crop.output_shape(shape)
        if self.auto_augment is not None:
            draws["auto_augment"] = self.auto_augment.draw(shape, generator)
        draws["post"] = self.post.draw(shape, generator)
        if self.mix is not None:
            draws["mix"] = self.mix.draw(shape, generator)
        return draws

    def apply(self, batch: Dict[str, torch.Tensor], draws: Dict[str, Any]
              ) -> Dict[str, torch.Tensor]:
        images = self.crop.apply(batch["image"], draws["crop"])
        if self.auto_augment is not None:
            images = self.auto_augment.apply(images, draws["auto_augment"])
        images = self.post.apply(images, draws["post"])
        labels = batch["label"]
        if self.mix is not None:
            images, labels = self.mix.apply((images, labels), draws["mix"])
        return {"image": images, "label": labels}

    def __call__(self, batch: Dict[str, torch.Tensor],
                 generator: torch.Generator) -> Dict[str, torch.Tensor]:
        return self.apply(batch, self.draw(batch["image"].shape, generator))


def make_device_augment(**kwargs: Any) -> DeviceAugment:
    """``DeviceAugment(**kwargs)``: the JAX recipe's ``make_device_augment``
    with its flags as keywords (``crop_size`` is ``--train-crop-size``)."""
    return DeviceAugment(**kwargs)


_EMBED_KEYS = ("class_token", "cls_token", "position_embedding",
               "pos_embedding", "relative_position_bias")
_NORMS = (nn.LayerNorm, nn.GroupNorm, nn.modules.batchnorm._NormBase,
          BatchNorm2d, GroupNorm)


def _decay_label(name: str, module: nn.Module) -> str:
    """The JAX recipe's ``_wd_label_tree``: ``"embed"`` for token and
    position tables, ``"norm"`` for a normalisation layer's parameters,
    ``"bias"`` for other biases, else ``"main"``."""
    if any(key in name.lower() for key in _EMBED_KEYS):
        return "embed"
    if isinstance(module, _NORMS):
        return "norm"
    if name.rsplit(".", 1)[-1] in ("bias", "in_proj_bias"):
        return "bias"
    return "main"


def decay_groups(model: nn.Module, weight_decay: float,
                 norm_weight_decay: Optional[float] = None,
                 bias_weight_decay: Optional[float] = None,
                 transformer_embedding_decay: Optional[float] = None
                 ) -> List[Dict[str, Any]]:
    """``model``'s trainable parameters as optimizer groups, one a distinct
    decay (``None`` means ``weight_decay``; the JAX recipe's
    ``_decay_transforms``)."""
    decay = {"main": weight_decay, "norm": norm_weight_decay,
             "bias": bias_weight_decay, "embed": transformer_embedding_decay}
    decay = {k: weight_decay if v is None else v for k, v in decay.items()}
    groups: Dict[float, List[nn.Parameter]] = {}
    for mod_name, module in model.named_modules():
        for name, p in module.named_parameters(recurse=False):
            if p.requires_grad:
                full = f"{mod_name}.{name}" if mod_name else name
                groups.setdefault(decay[_decay_label(full, module)], []).append(p)
    return [{"params": params, "weight_decay": wd}
            for wd, params in groups.items()]


def make_optimizer(model: nn.Module, lr: float, weight_decay: float,
                   norm_weight_decay: Optional[float] = None,
                   bias_weight_decay: Optional[float] = None,
                   transformer_embedding_decay: Optional[float] = None
                   ) -> torch.optim.AdamW:
    """The JAX recipe's ``make_optimizer`` at ``--opt adamw``, without its
    schedule and clip (``make_lr_scheduler``,
    ``make_train_step(clip_grad_norm=...)``): ``torch.optim.AdamW`` with
    decoupled decay, ``p -= lr * (adam + wd * p)`` (optax's
    ``scale_by_adam`` then the masked decays), betas (0.9, 0.999), eps
    1e-8, a group a distinct decay."""
    groups = decay_groups(model, weight_decay, norm_weight_decay,
                          bias_weight_decay, transformer_embedding_decay)
    return torch.optim.AdamW(groups, lr=lr, betas=(0.9, 0.999), eps=1e-8)


def lr_schedule(lr: float, epochs: int, steps_per_epoch: int,
                lr_min: float = 0.0, lr_warmup_epochs: int = 0,
                lr_warmup_decay: float = 0.01) -> Callable[[int], float]:
    """The learning rate of update ``count`` (0 for the first), as the JAX
    recipe's optax schedule gives it at ``--lr-scheduler
    cosineannealinglr --lr-warmup-method linear``: a warmup of
    ``lr_warmup_epochs`` from ``lr * lr_warmup_decay`` rising linearly to
    ``lr``, then a cosine from ``lr`` to ``lr_min`` over the epochs left."""
    decay_steps = max(1, epochs - lr_warmup_epochs) * steps_per_epoch
    alpha = lr_min / lr if lr else 0.0
    warm_steps = lr_warmup_epochs * steps_per_epoch
    start = lr * lr_warmup_decay

    def schedule(count: int) -> float:
        if count < warm_steps:
            return (start - lr) * (1.0 - count / warm_steps) + lr
        count = min(count - warm_steps, decay_steps)
        cosine = 0.5 * (1.0 + math.cos(math.pi * count / decay_steps))
        return lr * ((1.0 - alpha) * cosine + alpha)

    return schedule


def make_lr_scheduler(optimizer: torch.optim.Optimizer,
                      schedule: Callable[[int], float]
                      ) -> torch.optim.lr_scheduler.LambdaLR:
    """A ``LambdaLR`` that gives every group ``schedule(count)``, ``count``
    the number of ``scheduler.step()`` calls so far (one after each
    optimizer step). Host numbers only: nothing waits for the card."""
    base = optimizer.param_groups[0]["lr"]
    for group in optimizer.param_groups:
        if group["lr"] != base:
            raise ValueError("every group must start at the same lr")
    return torch.optim.lr_scheduler.LambdaLR(
        optimizer, lambda count: schedule(count) / base if base else 0.0)


def ema_decay(decay: float, batch_size: int, ema_steps: int, epochs: int
              ) -> float:
    """The recipe's adjusted EMA decay on one device: the published decay
    assumes an update every step of a full run; ``1 - min(1, (1 - decay) *
    batch_size * ema_steps / epochs)``."""
    return 1.0 - min(1.0, (1.0 - decay) * batch_size * ema_steps / epochs)


class ExponentialMovingAverage:
    """A decay-averaged copy of a model's parameters (the JAX recipe's
    ``utils.ExponentialMovingAverage``): ``shadow = shadow * decay + p * (1
    - decay)`` at each ``update(model)``, in the shadow's type (the f32
    masters), by ``torch._foreach`` passes and no host synchronisation;
    ``state_dict()`` gives the averages by parameter name."""

    def __init__(self, model: nn.Module, decay: float = 0.9999):
        self.decay = decay
        self.names = [n for n, _ in model.named_parameters()]
        with torch.no_grad():
            self.shadow = [p.detach().clone() for p in model.parameters()]

    @torch.no_grad()
    def update(self, model: nn.Module) -> None:
        params = [p.detach().to(s.dtype)
                  for s, p in zip(self.shadow, model.parameters())]
        torch._foreach_mul_(self.shadow, self.decay)
        torch._foreach_add_(self.shadow,
                            torch._foreach_mul(params, 1.0 - self.decay))

    def state_dict(self) -> Dict[str, torch.Tensor]:
        return dict(zip(self.names, self.shadow))
