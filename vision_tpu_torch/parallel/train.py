"""Train steps on one device: the classification step (counterpart of
``vision_tpu/parallel/train.py``: forward in training mode, cross-entropy
with label smoothing or soft labels, backward, one optimizer update) and
the two-stage detection step (counterpart of
``references/detection/engine.py:make_detection_train_step``). The mesh,
buffer donation and ``reduce_across_devices`` of the JAX package have no
counterpart here yet.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional

import torch
import torch.nn.functional as F
from torch import nn

__all__ = ["cross_entropy_loss", "make_detection_train_step",
           "make_train_step"]


def cross_entropy_loss(
    logits: torch.Tensor, labels: torch.Tensor, label_smoothing: float = 0.0
) -> torch.Tensor:
    """Mean cross-entropy; ``labels`` int ``[N]`` or soft ``[N, C]``
    (MixUp/CutMix). The softmax runs in f32 whatever the logits' type."""
    logits = logits.float()
    if labels.dim() == logits.dim() - 1:
        labels = F.one_hot(labels.long(), logits.shape[-1])
    labels = labels.to(logits.dtype)
    if label_smoothing > 0:
        n = logits.shape[-1]
        labels = labels * (1.0 - label_smoothing) + label_smoothing / n
    logp = F.log_softmax(logits, dim=-1)
    return -(labels * logp).sum(-1).mean()


def make_train_step(
    model: nn.Module,
    optimizer: torch.optim.Optimizer,
    label_smoothing: float = 0.0,
    compute_dtype: Optional[torch.dtype] = None,
) -> Callable[[Dict[str, torch.Tensor]], Dict[str, torch.Tensor]]:
    """Build ``step(batch) -> {"loss", "accuracy"}`` for
    ``batch = {"image": [N, 3, H, W], "label": [N] or [N, C]}`` on the
    model's device. The step puts the model in training mode, and updates
    its parameters (through ``optimizer``, which holds them) and its batch
    norm running statistics in place. ``accuracy`` is reported for integer
    labels only. The metrics stay on the device: reading them is the
    caller's synchronisation.

    ``compute_dtype=torch.bfloat16`` runs the forward and the backward pass
    in bf16: the parameters and the images are cast at the step boundary,
    while the master parameters, the optimizer state and the running
    statistics stay f32. The cast is differentiable, so the optimizer sees
    f32 gradients; bf16 has f32's exponent range, so no loss scaling is
    needed. The loss is computed in f32 either way.
    """

    def step(batch: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        images, labels = batch["image"], batch["label"]
        model.train()
        optimizer.zero_grad(set_to_none=True)
        if compute_dtype is None:
            logits = model(images)
        else:
            # buffers are not replaced: the running statistics stay f32
            cast = {
                name: p.to(compute_dtype) if p.is_floating_point() else p
                for name, p in model.named_parameters()
            }
            logits = torch.func.functional_call(
                model, cast, (images.to(compute_dtype),))
        loss = cross_entropy_loss(logits, labels, label_smoothing)
        loss.backward()
        optimizer.step()
        metrics = {"loss": loss.detach()}
        if labels.dim() == 1:
            hits = logits.detach().argmax(-1) == labels
            metrics["accuracy"] = hits.float().mean()
        return metrics

    return step


def make_detection_train_step(
    model: nn.Module,
    optimizer: torch.optim.Optimizer,
    compute_dtype: Optional[torch.dtype] = None,
) -> Callable[[Dict[str, torch.Tensor], torch.Generator],
              Dict[str, torch.Tensor]]:
    """Build ``step(batch, generator) -> {"loss", "loss_objectness",
    "loss_rpn_box_reg", "loss_classifier", "loss_box_reg"}`` for a
    two-stage detector with ``compute_loss`` (Faster R-CNN) and
    ``batch = {"image": [N, 3, H, W], "boxes": [N, G, 4], "labels": [N, G],
    "valid": [N, G]}``, boxes in the canvas's frame, on the model's device.
    The step puts the model in training mode, sums the losses in f32,
    runs the backward pass and one update through ``optimizer``; the
    samplers draw from ``generator`` (on the model's device). The losses
    stay on the device: reading them is the caller's synchronisation.

    f32 only: ``compute_dtype=torch.bfloat16`` raises, since the backward
    kernels of the window pool and RoIAlign have no bf16 variant yet
    (ROADMAP.md, queue 1: amp (bf16) detection training)."""
    if compute_dtype is not None and compute_dtype != torch.float32:
        raise NotImplementedError(
            f"detection training in {compute_dtype} is not ported yet "
            "(ROADMAP.md, queue 1: amp (bf16) detection training)")

    def step(batch: Dict[str, torch.Tensor],
             generator: torch.Generator) -> Dict[str, torch.Tensor]:
        model.train()
        optimizer.zero_grad(set_to_none=True)
        losses = model.compute_loss(batch["image"], batch["boxes"],
                                    batch["labels"], batch["valid"], generator)
        total = sum(v.float() for v in losses.values())
        total.backward()
        optimizer.step()
        return {"loss": total.detach(),
                **{k: v.detach() for k, v in losses.items()}}

    return step
