"""Transform base classes (counterpart of
``vision_tpu/transforms/v2/_transform.py``), for batches.

A transform takes a batch ``[N, C, H, W]``, or a tuple whose first element
is the batch (``(images, labels)``: the rest passes through unless the
transform says otherwise), and splits its work in two:

* ``draw(shape, generator)``: every random draw the call needs, from the
  explicit ``torch.Generator``, as tensors on the generator's device, one
  value a sample where the draw is per sample. ``shape`` is the batch's
  ``(N, C, H, W)``; no pixel is read.
* ``apply(inputs, params)``: the pixels, from those tensors alone. The draws
  may come from another device: ``to_device`` moves them, so that one
  batch's draws made on the card can be applied on the CPU, or handed to
  another library's functionals.

``__call__(inputs, generator)`` is ``apply(inputs, draw(shape,
generator))``. Nothing reads a drawn value on the host, so a call makes no
host synchronisation. This is the JAX package's split between its traced
``make_params`` and ``transform`` (and ``_auto_augment.py``'s ``draws`` and
``apply_ops_batched``); the draws are other numbers than JAX's, from the
same distributions.
"""

from __future__ import annotations

from typing import Any, Dict, Sequence, Tuple

import torch

__all__ = ["Transform", "rand", "to_device"]

Shape = Tuple[int, ...]


def rand(shape: Sequence[int], generator: torch.Generator) -> torch.Tensor:
    """Uniform [0, 1) f32 draws on the generator's device."""
    return torch.rand(tuple(shape), generator=generator, device=generator.device)


def to_device(params: Any, device) -> Any:
    """``params`` (tensors in nested dicts, lists and tuples) on ``device``."""
    if isinstance(params, torch.Tensor):
        return params.to(device)
    if isinstance(params, dict):
        return {k: to_device(v, device) for k, v in params.items()}
    if isinstance(params, (list, tuple)):
        return type(params)(to_device(v, device) for v in params)
    return params


def _images(inputs: Any) -> torch.Tensor:
    return inputs[0] if isinstance(inputs, (tuple, list)) else inputs


class Transform:
    """Base class. Subclasses implement ``transform(images, params)`` and,
    if they are random, ``draw(shape, generator)``; one that changes the
    images' size says so in ``output_shape``."""

    def output_shape(self, shape: Shape) -> Shape:
        return tuple(shape)

    def draw(self, shape: Shape, generator: torch.Generator) -> Dict[str, Any]:
        return {}

    def transform(self, images: torch.Tensor, params: Dict[str, Any]) -> torch.Tensor:
        raise NotImplementedError

    def apply(self, inputs: Any, params: Dict[str, Any]) -> Any:
        if isinstance(inputs, (tuple, list)):
            return (self.transform(inputs[0], params), *inputs[1:])
        return self.transform(inputs, params)

    def __call__(self, inputs: Any, generator: torch.Generator) -> Any:
        return self.apply(inputs, self.draw(tuple(_images(inputs).shape),
                                            generator))

    def __repr__(self) -> str:
        return f"{type(self).__name__}()"


class _RandomApplyTransform(Transform):
    """Applied to each image with probability ``p``: the draws add
    ``"applied"`` (``[N]`` bool, drawn first), and the images that were not
    picked come back as they were."""

    def __init__(self, p: float = 0.5):
        if not 0.0 <= p <= 1.0:
            raise ValueError(f"p must be in [0, 1], got {p}")
        self.p = p

    def draw_params(self, shape: Shape, generator: torch.Generator) -> Dict[str, Any]:
        return {}

    def draw(self, shape: Shape, generator: torch.Generator) -> Dict[str, Any]:
        applied = rand((shape[0],), generator) < self.p
        return {"applied": applied, **self.draw_params(shape, generator)}

    def transform(self, images: torch.Tensor, params: Dict[str, Any]) -> torch.Tensor:
        out = self.transform_all(images, params)
        applied = params["applied"].to(images.device).view(-1, 1, 1, 1)
        return torch.where(applied, out, images)

    def transform_all(self, images: torch.Tensor,
                      params: Dict[str, Any]) -> torch.Tensor:
        """The transform applied to every image of the batch."""
        raise NotImplementedError
