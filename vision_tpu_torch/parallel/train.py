"""Train steps on one device: the classification step (counterpart of
``vision_tpu/parallel/train.py``: forward in training mode, cross-entropy
with label smoothing or soft labels, backward, one optimizer update), the
detection step, two-stage or one-stage (counterpart of
``references/detection/engine.py:make_detection_train_step``, f32 or the
bf16 amp step), the semantic-segmentation step (counterpart of
``references/segmentation/train.py``'s) and the optical-flow step
(counterpart of ``references/optical_flow/train.py``'s). The mesh, buffer
donation and ``reduce_across_devices`` of the JAX package have no
counterpart here yet.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional

import torch
import torch.nn.functional as F
from torch import nn

from vision_tpu_torch.ops.misc import FrozenBatchNorm2d

__all__ = ["cross_entropy_loss", "make_detection_train_step",
           "make_flow_train_step", "make_segmentation_train_step",
           "make_train_step", "segmentation_criterion", "sequence_loss"]


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
    clip_grad_norm: Optional[float] = None,
) -> Callable[..., Dict[str, torch.Tensor]]:
    """Build ``step(batch, generator=None) -> {"loss", "accuracy"}`` for
    ``batch = {"image": [N, 3, H, W], "label": [N] or [N, C]}`` on the
    model's device. ``generator`` (a ``torch.Generator`` on the model's
    device) is handed to ``model(images, generator=generator)``, where the
    model's dropout and stochastic depth draw from it, as the JAX step
    hands its ``"dropout"`` key to the model; with None the model is called
    as ``model(images)`` and must draw nothing in training mode (a model
    with stochastic depth or dropout raises). The step puts the model in
    training mode, and updates its parameters (through ``optimizer``, which
    holds them) and its batch norm running statistics in place.
    ``accuracy`` is reported for integer labels only. The metrics stay on
    the device: reading them is the caller's synchronisation.

    ``compute_dtype=torch.bfloat16`` runs the forward and the backward pass
    in bf16: the parameters and the images are cast at the step boundary,
    while the master parameters, the optimizer state and the running
    statistics stay f32. The cast is differentiable, so the optimizer sees
    f32 gradients; bf16 has f32's exponent range, so no loss scaling is
    needed. The loss is computed in f32 either way.

    ``clip_grad_norm``: the gradients are scaled to at most that global
    norm before the update (``torch.nn.utils.clip_grad_norm_``, the JAX
    recipe's ``optax.clip_by_global_norm`` up to the 1e-6 torch adds to the
    norm), and the step also returns ``"grad_norm"``, the norm before
    clipping.
    """
    params = [p for group in optimizer.param_groups for p in group["params"]]

    def step(batch: Dict[str, torch.Tensor],
             generator: Optional[torch.Generator] = None
             ) -> Dict[str, torch.Tensor]:
        images, labels = batch["image"], batch["label"]
        model.train()
        optimizer.zero_grad(set_to_none=True)
        logits = _forward(model, images, generator, compute_dtype)
        loss = cross_entropy_loss(logits, labels, label_smoothing)
        loss.backward()
        metrics = {"loss": loss.detach()}
        if clip_grad_norm is not None:
            metrics["grad_norm"] = torch.nn.utils.clip_grad_norm_(
                params, clip_grad_norm)
        optimizer.step()
        if labels.dim() == 1:
            hits = logits.detach().argmax(-1) == labels
            metrics["accuracy"] = hits.float().mean()
        return metrics

    return step


def _forward(model: nn.Module, images: torch.Tensor,
             generator: Optional[torch.Generator],
             compute_dtype: Optional[torch.dtype]):
    """``model(images, generator=generator)`` (without the keyword where
    ``generator`` is None); with ``compute_dtype``, the parameters and the
    images cast to it at the call, the buffers (the running statistics)
    left as they are."""
    kwargs = {} if generator is None else {"generator": generator}
    if compute_dtype is None:
        return model(images, **kwargs)
    cast = {name: p.to(compute_dtype) if p.is_floating_point() else p
            for name, p in model.named_parameters()}
    return torch.func.functional_call(model, cast,
                                      (images.to(compute_dtype),), kwargs)


def segmentation_criterion(outputs: Dict[str, torch.Tensor],
                           target: torch.Tensor,
                           ignore_index: int = 255) -> torch.Tensor:
    """``references/segmentation/train.py:criterion``: the cross-entropy of
    ``outputs["out"]`` (``[N, C, H, W]`` logits, in f32) against ``target``
    (``[N, H, W]`` int), plus 0.5 times that of ``outputs["aux"]`` where
    there is one; each the mean over the pixels whose target is not
    ``ignore_index``, over at least one pixel (an all-ignored batch gives
    0, where ``F.cross_entropy`` gives NaN)."""
    valid = target != ignore_index
    tgt = torch.where(valid, target, torch.zeros_like(target)).long()
    count = valid.sum().clamp(min=1)
    losses = {}
    for name, logits in outputs.items():
        logp = F.log_softmax(logits.float(), dim=1)
        ce = -logp.gather(1, tgt[:, None])[:, 0]
        losses[name] = (ce * valid).sum() / count
    if "aux" in losses:
        return losses["out"] + 0.5 * losses["aux"]
    return losses["out"]


def make_segmentation_train_step(
    model: nn.Module,
    optimizer: torch.optim.Optimizer,
    compute_dtype: Optional[torch.dtype] = None,
    ignore_index: int = 255,
) -> Callable[..., Dict[str, torch.Tensor]]:
    """Build ``step(batch, generator=None) -> {"loss"}`` for a segmentation
    model (``model(images, generator=)`` returning ``{"out", "aux"}``
    logits) and ``batch = {"image": [N, 3, H, W], "target": [N, H, W]
    int64}`` on the model's device: the JAX recipe's step
    (``references/segmentation/train.py:250-290``). Training mode, the
    heads' dropout drawn from ``generator``, ``segmentation_criterion``,
    backward, one update through ``optimizer`` (the recipe's: SGD, momentum
    0.9, weight decay 1e-4 added to the gradient before the momentum,
    ``torch.optim.SGD``'s own order). ``compute_dtype=torch.bfloat16`` is
    the recipe's amp: parameters and image cast at the call, the batch-norm
    statistics and the outputs f32 before the loss, f32 masters. The loss
    stays on the device."""

    def step(batch: Dict[str, torch.Tensor],
             generator: Optional[torch.Generator] = None
             ) -> Dict[str, torch.Tensor]:
        model.train()
        optimizer.zero_grad(set_to_none=True)
        outputs = _forward(model, batch["image"], generator, compute_dtype)
        loss = segmentation_criterion(
            {k: v.float() for k, v in outputs.items()},
            batch["target"], ignore_index)
        loss.backward()
        optimizer.step()
        return {"loss": loss.detach()}

    return step


def sequence_loss(flow_preds, flow_gt: torch.Tensor,
                  valid_mask: Optional[torch.Tensor] = None,
                  gamma: float = 0.8, max_flow: float = 400.0
                  ) -> torch.Tensor:
    """``references/optical_flow/train.py:sequence_loss``: the sum over the
    N predictions (``[B, 2, H, W]``) of ``gamma^(N-1-i)`` times the mean
    L1 (summed over the two channels) over the pixels where ``|gt| <
    max_flow`` (and ``valid_mask``), over at least one pixel."""
    valid = flow_gt.pow(2).sum(1).sqrt() < max_flow
    if valid_mask is not None:
        valid = valid & valid_mask
    count = valid.sum().clamp(min=1)
    n = len(flow_preds)
    total = flow_gt.new_zeros(())
    for i, pred in enumerate(flow_preds):
        l1 = (pred.float() - flow_gt).abs().sum(1)
        total = total + gamma ** (n - 1 - i) * (l1 * valid).sum() / count
    return total


def make_flow_train_step(
    model: nn.Module,
    optimizer: torch.optim.Optimizer,
    num_flow_updates: int = 12,
    gamma: float = 0.8,
) -> Callable[..., Dict[str, torch.Tensor]]:
    """Build ``step(batch) -> {"loss"}`` for RAFT and ``batch = {"image1",
    "image2": [N, 3, H, W] in [-1, 1], "flow": [N, 2, H, W]}`` (and an
    optional ``"valid"`` ``[N, H, W]`` bool) on the model's device: the JAX
    recipe's step (``references/optical_flow/train.py:150-185``). Training
    mode (``raft_large``'s context encoder normalises by its batch),
    ``num_flow_updates`` updates, ``sequence_loss``, backward, every
    gradient clipped elementwise to [-1, 1] (the JAX recipe's; torchvision
    clips by norm), one update through ``optimizer`` (the recipe's: AdamW,
    lr 4e-4, weight decay 1e-4). f32 only: the JAX flow trainer has no
    amp. The loss stays on the device."""
    params = [p for group in optimizer.param_groups for p in group["params"]]

    def step(batch: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        model.train()
        optimizer.zero_grad(set_to_none=True)
        preds = model(batch["image1"], batch["image2"],
                      num_flow_updates=num_flow_updates)
        loss = sequence_loss(preds, batch["flow"], batch.get("valid"), gamma)
        loss.backward()
        for p in params:
            if p.grad is not None:
                p.grad.clamp_(-1.0, 1.0)
        optimizer.step()
        return {"loss": loss.detach()}

    return step


def make_detection_train_step(
    model: nn.Module,
    optimizer: torch.optim.Optimizer,
    compute_dtype: Optional[torch.dtype] = None,
    one_stage: bool = False,
) -> Callable[..., Dict[str, torch.Tensor]]:
    """Build ``step(batch, generator) -> {"loss", "loss_objectness",
    "loss_rpn_box_reg", "loss_classifier", "loss_box_reg"}`` for a
    two-stage detector with ``compute_loss`` (Faster R-CNN, Mask R-CNN,
    Keypoint R-CNN) and ``batch = {"image": [N, 3, H, W], "boxes": [N, G,
    4], "labels": [N, G], "valid": [N, G]}``, boxes in the canvas's frame,
    on the model's device. A batch for Mask R-CNN also carries ``"masks"``
    (``[N, G, H, W]``, canvas frame, padding rows zero), one for Keypoint
    R-CNN ``"keypoints"`` (``[N, G, K, 3]``, canvas frame); the step hands
    them to ``compute_loss``, and ``loss_mask`` or ``loss_keypoint`` joins
    the sum and the result. The step puts the model in training mode, sums
    the losses in f32, runs the backward pass and one update through ``optimizer``; the
    samplers draw from ``generator`` (on the model's device). The losses
    stay on the device: reading them is the caller's synchronisation.

    ``one_stage=True`` is the JAX recipe's one-stage convention
    (``engine.py:45-47``; RetinaNet): the forward first, then
    ``compute_loss(*outputs, gt_boxes, gt_labels, gt_valid)``; the step
    returns ``"loss"`` and the model's losses (``"classification"``,
    ``"bbox_regression"``), and takes no generator.

    ``compute_dtype=torch.bfloat16`` is the JAX recipe's amp step
    (``references/detection/engine.py:24-37``): the parameters, the frozen
    batch-norm constants and the image are cast at the step boundary, while
    the gt boxes, labels, masks and keypoints stay f32, so that all box
    arithmetic promotes to f32; the losses are summed in f32; the master
    parameters and the optimizer state stay f32 (the cast is
    differentiable, so the optimizer sees f32 gradients). The window pool
    and RoIAlign take their bf16 kernels forward and backward. A live batch
    norm (RetinaNet v2's trunk) keeps its running statistics f32 and
    updates them in place at every step, in every stage, trainable or not
    (``engine.py:49-55``: the recipe masks the updates of the parameters,
    not of the statistics)."""
    loss_of = _LossOf(model, one_stage)
    # the frozen batch-norm constants; no other buffer (a live batch norm's
    # running statistics stay f32, as in the JAX recipe)
    frozen = {f"{mod_name}.{name}"
              for mod_name, mod in loss_of.named_modules()
              if isinstance(mod, FrozenBatchNorm2d)
              for name, _ in mod.named_buffers(recurse=False)}

    def step(batch: Dict[str, torch.Tensor],
             generator: Optional[torch.Generator] = None
             ) -> Dict[str, torch.Tensor]:
        model.train()
        optimizer.zero_grad(set_to_none=True)
        extra = {f"gt_{k}": batch[k] for k in ("masks", "keypoints")
                 if k in batch}
        args = (batch["image"], batch["boxes"], batch["labels"],
                batch["valid"], generator)
        if compute_dtype is None or compute_dtype == torch.float32:
            losses = loss_of(*args, **extra)
        else:
            cast = {name: p.to(compute_dtype)
                    for name, p in loss_of.named_parameters()
                    if p.is_floating_point()}
            cast.update((name, b.to(compute_dtype))
                        for name, b in loss_of.named_buffers()
                        if name in frozen and b.is_floating_point())
            losses = torch.func.functional_call(
                loss_of, cast, (args[0].to(compute_dtype), *args[1:]), extra)
        total = sum(v.float() for v in losses.values())
        total.backward()
        optimizer.step()
        return {"loss": total.detach(),
                **{k: v.detach() for k, v in losses.items()}}

    return step


class _LossOf(nn.Module):
    """``model.compute_loss`` as a module's forward, so that
    ``torch.func.functional_call`` can swap the model's tensors for one
    call; for a one-stage model, of the forward's outputs."""

    def __init__(self, model: nn.Module, one_stage: bool = False):
        super().__init__()
        self.model = model
        self.one_stage = one_stage

    def forward(self, images, boxes, labels, valid, generator, **kwargs):
        if self.one_stage:
            return self.model.compute_loss(*self.model(images), boxes, labels,
                                           valid)
        return self.model.compute_loss(images, boxes, labels, valid,
                                       generator, **kwargs)
