"""The classification zoo's cells on the card: the JAX bench's zoo cells
(``bench.py:_bench_zoo_fwd``: EfficientNet-V2-S at 384 px, batch 32;
ConvNeXt-T and Swin-T at 224 px, batch 64), their seeded models and
inputs, the bf16 serving cast, one SGD step, and step 1 of a train step
held against the CPU (``step_against_cpu``), shared by ``chip_smoke.py``'s
zoo and dense phases and ``tools/profile_zoo.py``.

A model is built from its seed with torchvision's initialisation, then its
batch norms' running statistics are set from one seeded batch in training
mode (``calibrate_norms``), as a trained model's describe its inputs: with
the initial identity statistics an EfficientNet's eval-mode activations
shrink through every depthwise block, to logits of ~1e-14.
"""

from __future__ import annotations

import copy
import contextlib
from typing import Callable, Dict, List, Optional, Union

import torch
import torch.nn.functional as F

from vision_tpu_torch.models import get_model, get_model_weights
from vision_tpu_torch.models._api import resolve_device
from vision_tpu_torch.ops.misc import BatchNorm2d
from vision_tpu_torch.parallel import make_train_step

__all__ = ["CELLS", "LR", "TRAIN_BATCH", "batch_of", "calibrate_norms",
           "gmacs", "images", "relu_sides", "seeded_model", "sgd_step",
           "step_against_cpu", "to_bf16"]

# name -> (image size, batch)
CELLS = {
    "efficientnet_v2_s": (384, 32),
    "convnext_tiny": (224, 64),
    "swin_t": (224, 64),
}
TRAIN_BATCH = 32
LR = 0.1  # SGD, momentum 0.9, weight decay 1e-4
CALIBRATION_BATCH = 8

Device = Union[str, torch.device, None]


def gmacs(name: str) -> float:
    """GMACs a sample at the checkpoint's size (the weights' ``_ops``, the
    JAX bench's figure)."""
    return get_model_weights(name).DEFAULT.meta["_ops"]


def images(batch: int, size: int, seed: int = 0,
           device: Device = None) -> torch.Tensor:
    """Seeded normal ``[batch, 3, size, size]`` images, drawn on the CPU
    and moved to ``device`` (the card when None)."""
    x = torch.randn(batch, 3, size, size,
                    generator=torch.Generator().manual_seed(seed))
    return x.to(resolve_device(device))


@torch.no_grad()
def calibrate_norms(model: torch.nn.Module, call: Callable[[], object]) -> None:
    """Every batch norm's running statistics set to the batch statistics
    of ``call()``, one forward of ``model`` in training mode with momentum
    1; the model is left in eval mode."""
    norms = [m for m in model.modules() if isinstance(m, BatchNorm2d)]
    momenta = [m.momentum for m in norms]
    for m in norms:
        m.momentum = 1.0
    try:
        if norms:
            model.train()
            call()
    finally:
        for m, momentum in zip(norms, momenta):
            m.momentum = momentum
        model.eval()


def seeded_model(name: str, size: int, device: Device = None, seed: int = 0,
                 **kwargs) -> torch.nn.Module:
    """``get_model(name, seed=seed, **kwargs)`` on ``device``, its batch
    norms calibrated on ``CALIBRATION_BATCH`` seeded images of ``size``
    (seed 100)."""
    model = get_model(name, device=device, seed=seed, **kwargs)
    dev = next(model.parameters()).device
    gen = torch.Generator(device=dev).manual_seed(seed)
    x = images(CALIBRATION_BATCH, size, 100, dev)
    calibrate_norms(model, lambda: model(x, generator=gen))
    return model


def to_bf16(model: torch.nn.Module) -> torch.nn.Module:
    """``model`` in bf16 for serving, in place, its batch norms' running
    statistics kept f32 as the amp train step keeps them (the norm computes
    in f32 either way; rounding the statistics to bf16 doubles the bf16
    logits' distance from f32 in an EfficientNet-V2-S)."""
    kept = [(m, dict(m.named_buffers(recurse=False))) for m in model.modules()
            if isinstance(m, BatchNorm2d)]
    model.to(torch.bfloat16)
    for m, buffers in kept:
        for name, buf in buffers.items():
            setattr(m, name, buf)
    return model


def sgd_step(model: torch.nn.Module,
             compute_dtype: Optional[torch.dtype] = None):
    """``make_train_step`` with SGD (``LR``, momentum 0.9, weight decay
    1e-4)."""
    opt = torch.optim.SGD(model.parameters(), lr=LR, momentum=0.9,
                          weight_decay=1e-4)
    return make_train_step(model, opt, compute_dtype=compute_dtype)


def labels(batch: int, seed: int = 0, device: Device = None) -> torch.Tensor:
    return torch.randint(0, 1000, (batch,),
                         generator=torch.Generator().manual_seed(seed)).to(
        resolve_device(device))


def batch_of(batch: int, size: int, seed: int = 0,
             device: Device = None) -> Dict[str, torch.Tensor]:
    return {"image": images(batch, size, seed, device),
            "label": labels(batch, seed, device)}


@contextlib.contextmanager
def relu_sides(sides: List[torch.Tensor], switched: Optional[List[int]]):
    """``F.relu`` keeping each call's ``x > 0`` in ``sides`` (``switched``
    None), or applying the kept ones in call order: ``x`` times the mask,
    whose gradient is the mask, each element whose own side of 0 differs
    counted in ``switched[0]``."""
    plain, kept = F.relu, iter(list(sides))

    def relu(x: torch.Tensor, inplace: bool = False) -> torch.Tensor:
        if switched is None:
            sides.append(x.detach() > 0)
            return plain(x, inplace)
        keep = next(kept).to(x.device)
        if keep.shape != x.shape:
            raise RuntimeError("the replayed ReLU calls differ in shape")
        switched[0] += int(((x.detach() > 0) != keep).sum())
        return x * keep.to(x.dtype)

    F.relu = relu
    try:
        yield
    finally:
        F.relu = plain


def step_against_cpu(make: Callable[[], torch.nn.Module],
                     step_of: Callable, batch_of: Callable) -> Dict:
    """Step 1 of a train step on the card and on the CPU from the same
    weights (``make()``, on the card; ``step_of(model)`` the step;
    ``batch_of(device)`` its batch): the losses and every gradient the step
    leaves. The CPU's step takes each ReLU to the side the card's took: a
    randomly initialised network trained on batch statistics amplifies an
    f32 rounding through its depth (DeepLabV3-ResNet-50's pre-activations
    part by ~1e-4 of their scale at the head, on either device against
    f64), and the few ReLU inputs so near 0 that they switch side (~1e-5 of
    them) move its gradients by ~3e-2; taken to the same sides the two
    devices' gradients are compared as the same function's. The elements
    that would have switched are counted."""
    model, sides, switched, out = make(), [], [0], {}
    cpu = copy.deepcopy(model).cpu()
    for where, twin, hold in (("card", model, None), ("cpu", cpu, switched)):
        batch = batch_of(next(twin.parameters()).device)
        with relu_sides(sides, hold):
            loss = float(step_of(twin)(batch)["loss"])
        grads = torch.cat([p.grad.double().cpu().ravel()
                           for p in twin.parameters() if p.grad is not None])
        out[where] = (loss, grads)
    del model, cpu
    (loss, grads), (want, want_grads) = out["card"], out["cpu"]
    total = sum(s.numel() for s in sides)
    return {"loss_vs_cpu_rel_err": abs(loss - want) / abs(want),
            "grads_vs_cpu_frobenius_rel_err": float(
                (grads - want_grads).norm() / want_grads.norm()),
            "relu_outputs": total, "relu_switched": switched[0],
            "relu_switched_share": switched[0] / max(total, 1)}
