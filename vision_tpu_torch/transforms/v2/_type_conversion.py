"""Type conversions (counterpart of
``vision_tpu/transforms/v2/_type_conversion.py``): ``ToImage``,
``PILToTensor``, ``ToPILImage`` and ``ToPureTensor``, each over every leaf
of a sample (a plain 4-d tensor too). Images are ``[C, H, W]``
(torchvision's layout: an ``(H, W, C)`` numpy array or PIL image is moved
to it). PIL is imported at the call (``functional._aliases``): where it is
missing, ``ToPILImage`` raises a ``ModuleNotFoundError`` that names it."""

from __future__ import annotations

from typing import Any

import numpy as np
import torch
import torch.utils._pytree as pytree

from vision_tpu_torch import tv_tensors
from vision_tpu_torch.transforms.v2._transform import Transform
from vision_tpu_torch.transforms.v2.functional._aliases import (
    _pil,
    is_pil_image,
    pil_to_tensor,
    to_image,
)

__all__ = ["PILToTensor", "ToImage", "ToPILImage", "ToPureTensor"]


def _map(fn, sample: Any) -> Any:
    return pytree.tree_map(fn, sample)


class ToImage(Transform):
    """Every numpy array and PIL image of the sample, and its first plain
    tensor where it holds no ``Image``, as an ``Image`` (``to_image``)."""

    def __call__(self, inputs: Any, generator=None) -> Any:
        flat, spec = pytree.tree_flatten(inputs)
        plain = not any(isinstance(x, tv_tensors.Image) for x in flat)
        out = []
        for x in flat:
            if isinstance(x, np.ndarray) or is_pil_image(x):
                x = to_image(x)
            elif plain and isinstance(x, torch.Tensor) and not isinstance(
                    x, tv_tensors.TVTensor):
                x, plain = to_image(x), False
            out.append(x)
        return pytree.tree_unflatten(out, spec)


class PILToTensor(Transform):
    """Every PIL image of the sample as a plain ``[C, H, W]`` tensor of its
    own type."""

    def __call__(self, inputs: Any, generator=None) -> Any:
        return _map(lambda x: pil_to_tensor(x) if is_pil_image(x) else x,
                    inputs)


class ToPILImage(Transform):
    """Every image of the sample (an ``Image``, a plain tensor or a numpy
    array, ``[C, H, W]`` or ``[H, W]``) as a PIL image, a float one scaled
    by 255 and truncated, as the JAX package's class does; on the host."""

    def __init__(self, mode=None):
        self.mode = mode

    def __call__(self, inputs: Any, generator=None) -> Any:
        image = _pil("ToPILImage")

        def conv(x):
            if isinstance(x, tv_tensors.TVTensor) and not isinstance(
                    x, tv_tensors.Image):
                return x
            if isinstance(x, torch.Tensor):
                x = x.as_subclass(torch.Tensor).detach().cpu().numpy()
            if not isinstance(x, np.ndarray) or x.ndim not in (2, 3):
                return x
            arr = x.transpose(1, 2, 0) if x.ndim == 3 else x
            if arr.ndim == 3 and arr.shape[-1] == 1:
                arr = arr[..., 0]
            if arr.dtype != np.uint8:
                arr = np.clip(arr * 255.0, 0, 255).astype(np.uint8)
            return (image.fromarray(arr, self.mode) if self.mode
                    else image.fromarray(arr))

        return _map(conv, inputs)


class ToPureTensor(Transform):
    """Every typed tensor of the sample as a plain one (no copy)."""

    def __call__(self, inputs: Any, generator=None) -> Any:
        return _map(lambda x: x.as_tensor() if isinstance(
            x, tv_tensors.TVTensor) else x, inputs)
