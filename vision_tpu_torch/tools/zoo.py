"""The classification zoo's cells on the card: the JAX bench's zoo cells
(``bench.py:_bench_zoo_fwd``: EfficientNet-V2-S at 384 px, batch 32;
ConvNeXt-T and Swin-T at 224 px, batch 64), their seeded models and
inputs, the bf16 serving cast and one SGD step, shared by
``chip_smoke.py``'s zoo phases and ``tools/profile_zoo.py``.

A model is built from its seed with torchvision's initialisation, then its
batch norms' running statistics are set from one seeded batch in training
mode (``calibrate_norms``), as a trained model's describe its inputs: with
the initial identity statistics an EfficientNet's eval-mode activations
shrink through every depthwise block, to logits of ~1e-14.
"""

from __future__ import annotations

from typing import Dict, Optional, Union

import torch

from vision_tpu_torch.models import (
    ConvNeXt_Tiny_Weights,
    EfficientNet_V2_S_Weights,
    Swin_T_Weights,
    get_model,
)
from vision_tpu_torch.models._api import resolve_device
from vision_tpu_torch.ops.misc import BatchNorm2d
from vision_tpu_torch.parallel import make_train_step

__all__ = ["CELLS", "LR", "TRAIN_BATCH", "batch_of", "calibrate_norms",
           "gmacs", "images", "seeded_model", "sgd_step", "to_bf16"]

# name -> (image size, batch, weights enum: GMACs a sample in its meta)
CELLS = {
    "efficientnet_v2_s": (384, 32, EfficientNet_V2_S_Weights),
    "convnext_tiny": (224, 64, ConvNeXt_Tiny_Weights),
    "swin_t": (224, 64, Swin_T_Weights),
}
TRAIN_BATCH = 32
LR = 0.1  # SGD, momentum 0.9, weight decay 1e-4
CALIBRATION_BATCH = 8

Device = Union[str, torch.device, None]


def gmacs(name: str) -> float:
    """A cell's GMACs a sample at its size (its weights' ``_ops``, the
    JAX bench's figure)."""
    return CELLS[name][2].DEFAULT.meta["_ops"]


def images(batch: int, size: int, seed: int = 0,
           device: Device = None) -> torch.Tensor:
    """Seeded normal ``[batch, 3, size, size]`` images, drawn on the CPU
    and moved to ``device`` (the card when None)."""
    x = torch.randn(batch, 3, size, size,
                    generator=torch.Generator().manual_seed(seed))
    return x.to(resolve_device(device))


@torch.no_grad()
def calibrate_norms(model: torch.nn.Module, x: torch.Tensor,
                    generator: torch.Generator) -> None:
    """Every batch norm's running statistics set to ``x``'s batch
    statistics through the model (one training-mode forward with momentum
    1); the model is left in eval mode."""
    norms = [m for m in model.modules() if isinstance(m, BatchNorm2d)]
    momenta = [m.momentum for m in norms]
    for m in norms:
        m.momentum = 1.0
    try:
        if norms:
            model.train()
            model(x, generator=generator)
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
    calibrate_norms(model, images(CALIBRATION_BATCH, size, 100, dev), gen)
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
