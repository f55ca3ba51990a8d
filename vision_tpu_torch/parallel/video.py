"""The video classification recipe's train side (counterpart of
``references/video_classification/train.py``): its optimizer and schedule
(l.132-145), and ``VideoAccuracy`` (l.33-57). The step is
``make_train_step`` on ``{"image": [N, 3, T, H, W] clips, "label": [N]}``:
f32 logits, a one-hot cross-entropy without label smoothing, and with
``compute_dtype=torch.bfloat16`` the recipe's ``--amp`` (parameters and
clips in bf16, batch statistics f32, f32 masters); the clips come from
``parallel.presets.VideoClassificationPresetTrain``.
"""

from __future__ import annotations

from typing import Dict, Sequence, Tuple

import torch
from torch import nn

__all__ = ["VideoAccuracy", "video_lr_lambda", "video_recipe_optimizer"]


def video_lr_lambda(steps_per_epoch: int, milestones: Sequence[int] = (20, 30, 40),
                    gamma: float = 0.1, warmup_epochs: int = 0,
                    warmup_decay: float = 0.001):
    """The factor of the learning rate at update ``step`` (0 for the first),
    as the JAX recipe's optax schedule gives it: ``warmup_epochs`` of linear
    warm-up from ``warmup_decay``, then ``gamma`` per milestone passed,
    the milestones counted in epochs *from the warm-up's end*
    (``optax.join_schedules`` restarts the step count of the schedule it
    joins)."""
    warm = warmup_epochs * steps_per_epoch
    bounds = sorted(m * steps_per_epoch for m in milestones)

    def factor(step: int) -> float:
        if step < warm:
            return warmup_decay + (1.0 - warmup_decay) * step / warm
        passed = sum(step - warm >= b for b in bounds)
        return gamma ** passed

    return factor


def video_recipe_optimizer(model: nn.Module, lr: float = 0.01,
                           momentum: float = 0.9, weight_decay: float = 1e-4,
                           steps_per_epoch: int = 100,
                           milestones: Sequence[int] = (20, 30, 40),
                           gamma: float = 0.1, warmup_epochs: int = 0,
                           warmup_decay: float = 0.001
                           ) -> Tuple[torch.optim.Optimizer,
                                      torch.optim.lr_scheduler.LambdaLR]:
    """The recipe's SGD (momentum, weight decay added to the gradient before
    the momentum: ``optax.add_decayed_weights`` then ``sgd``, which is
    ``torch.optim.SGD``'s own order) over the trainable parameters, with
    its defaults, and the ``video_lr_lambda`` schedule; step the scheduler
    once after each update."""
    params = [p for p in model.parameters() if p.requires_grad]
    optimizer = torch.optim.SGD(params, lr=lr, momentum=momentum,
                                weight_decay=weight_decay)
    scheduler = torch.optim.lr_scheduler.LambdaLR(
        optimizer, video_lr_lambda(steps_per_epoch, milestones, gamma,
                                   warmup_epochs, warmup_decay))
    return optimizer, scheduler


class VideoAccuracy:
    """Video-level accuracy: the softmaxes of a video's clips summed, then
    the argmax against its label. ``update`` reads its inputs on the host
    (one synchronisation a call)."""

    def __init__(self, num_classes: int):
        self.num_classes = num_classes
        self.scores: Dict[int, torch.Tensor] = {}
        self.labels: Dict[int, int] = {}

    def update(self, video_ids, probs, labels) -> None:
        probs = torch.as_tensor(probs).detach().float().cpu()
        for vid, p, y in zip(torch.as_tensor(video_ids).tolist(), probs,
                             torch.as_tensor(labels).tolist()):
            self.scores[vid] = self.scores.get(vid, 0) + p
            self.labels[vid] = int(y)

    def compute(self) -> float:
        if not self.scores:
            return 0.0
        correct = sum(int(int(torch.argmax(p)) == self.labels[v])
                      for v, p in self.scores.items())
        return correct / len(self.scores)
