"""Pieces shared by the classification builders (counterpart of
``vision_tpu/models/_utils.py``): ``_make_divisible``, the weights entry of
a classification checkpoint, the builder's common body and the seeded
initialisation helpers.

A builder constructs its model on the meta device and materialises it
where it will run (``to_empty``), so a large model is never built on the
CPU first. Its random initialisation is drawn tensor by tensor from a CPU
``torch.Generator`` and copied in, so the same seed gives the same numbers
on every device.
"""

from __future__ import annotations

import functools
import math
from typing import Any, Callable, Dict, Optional, Union

import torch
from torch import nn

from vision_tpu_torch.models._api import Weights, resolve_device
from vision_tpu_torch.ops.misc import BatchNorm2d
from vision_tpu_torch.transforms._presets import ImageClassification

__all__ = ["build", "cls_weights", "eval_size", "init_norms"]

_URL = "https://download.pytorch.org/models/"
Device = Union[str, torch.device, None]


def _make_divisible(v: float, divisor: int,
                    min_value: Optional[int] = None) -> int:
    """``v`` rounded to a multiple of ``divisor``, never below
    ``min_value`` (default ``divisor``) nor more than 10% below ``v``."""
    if min_value is None:
        min_value = divisor
    new_v = max(min_value, int(v + divisor / 2) // divisor * divisor)
    if new_v < 0.9 * v:
        new_v += divisor
    return new_v


def cls_weights(file: str, acc1: float, acc5: float, num_params: int,
                ops: float, crop: int = 224, resize: int = 256,
                interp: str = "bilinear") -> Weights:
    """An ImageNet-1K checkpoint under torchvision's URL: its accuracies,
    parameter count, GMACs a sample at its eval size (``_ops``) and its
    ``ImageClassification`` preset."""
    return Weights(url=_URL + file, transforms=functools.partial(
        ImageClassification, crop_size=crop, resize_size=resize,
        interpolation=interp), meta={
        "num_params": num_params, "categories": "imagenet-1k", "_ops": ops,
        "_metrics": {"ImageNet-1K": {"acc@1": acc1, "acc@5": acc5}},
    })


def eval_size(weights: Any) -> int:
    """The crop a checkpoint was evaluated at (its preset's)."""
    return weights.transforms.keywords["crop_size"]


def build(make: Callable[[], nn.Module],
          init: Callable[[nn.Module, torch.Generator], None],
          weights: Any, device: Device, seed: int,
          hook: Optional[Callable[[Dict[str, torch.Tensor]],
                                  Dict[str, torch.Tensor]]] = None
          ) -> nn.Module:
    """``make()`` in eval mode on ``device`` (the card when None; raises
    without one; ``"meta"`` builds it without storage or initialisation).
    With ``weights`` the checkpoint's state dict (through ``hook``) is
    loaded; without, ``init`` draws the parameters from a CPU generator
    seeded with ``seed``."""
    device = resolve_device(device)
    with torch.device("meta"):
        model = make()
    if device.type == "meta":
        return model.eval()
    model = model.to_empty(device=device)
    if weights is not None:
        state = weights.get_state_dict()
        model.load_state_dict(hook(state) if hook else state)
    else:
        init(model, torch.Generator().manual_seed(seed))
    return model.eval()


# Initialisers: each draws on the CPU and copies into the tensor, wherever
# it lies.

def _copy(t: torch.Tensor, fill: Callable[[torch.Tensor], Any]) -> None:
    cpu = torch.empty(t.shape, dtype=t.dtype)
    fill(cpu)
    t.copy_(cpu)


def normal_(t: torch.Tensor, std: float, g: torch.Generator) -> None:
    _copy(t, lambda c: c.normal_(0.0, std, generator=g))


def trunc_normal_(t: torch.Tensor, std: float, g: torch.Generator,
                  a: float = -2.0, b: float = 2.0) -> None:
    _copy(t, lambda c: nn.init.trunc_normal_(c, std=std, a=a, b=b,
                                             generator=g))


def uniform_(t: torch.Tensor, bound: float, g: torch.Generator) -> None:
    _copy(t, lambda c: c.uniform_(-bound, bound, generator=g))


def fan_out_normal_(t: torch.Tensor, g: torch.Generator) -> None:
    """He-normal over the fan out (``kaiming_normal_(mode="fan_out")``)."""
    fan_out = t.shape[0] * t[0, 0].numel()
    normal_(t, math.sqrt(2.0 / fan_out), g)


def default_(m: nn.Module, g: torch.Generator) -> None:
    """PyTorch's own initialisation of a conv or Linear: weight and bias
    uniform in +-1/sqrt(fan in)."""
    bound = 1.0 / math.sqrt(m.weight[0].numel())
    uniform_(m.weight, bound, g)
    if m.bias is not None:
        uniform_(m.bias, bound, g)


def zero_bias_(m: nn.Module) -> None:
    if m.bias is not None:
        m.bias.zero_()


def init_norms(model: nn.Module) -> None:
    """Every norm layer to weight 1, bias 0, and a batch norm's running
    statistics to the identity."""
    for m in model.modules():
        if isinstance(m, (BatchNorm2d, nn.LayerNorm)):
            if m.weight is not None:
                m.weight.fill_(1.0)
                m.bias.zero_()
        if isinstance(m, BatchNorm2d):
            m.running_mean.zero_()
            m.running_var.fill_(1.0)
            m.num_batches_tracked.zero_()


def normal_linear(std: float) -> Callable[[nn.Linear, torch.Generator], None]:
    """A Linear's weight normal of std ``std``, its bias zero."""
    def init(m: nn.Linear, g: torch.Generator) -> None:
        normal_(m.weight, std, g)
        zero_bias_(m)
    return init


def fan_out_init(model: nn.Module, generator: torch.Generator,
                 linear: Callable[[nn.Linear, torch.Generator], None]) -> None:
    """The convolutional classifiers' initialisation in torchvision: convs
    He-normal over the fan out with zero bias, norms identity, each Linear
    by ``linear``."""
    init_norms(model)
    for m in model.modules():
        if isinstance(m, nn.Conv2d):
            fan_out_normal_(m.weight, generator)
            zero_bias_(m)
        elif isinstance(m, nn.Linear):
            linear(m, generator)
