"""Stochastic depth (counterpart of ``vision_tpu/ops/stochastic_depth.py``):
whole residual branches zeroed at random, the survivors scaled by
``1 / (1 - p)``. The draws come from an explicit ``torch.Generator`` on the
input's device, or are handed in (``keep``)."""

from __future__ import annotations

from typing import Optional, Sequence

import torch

__all__ = ["stochastic_depth", "stochastic_depth_keep"]


def _check(p: float, mode: str) -> None:
    if p < 0.0 or p > 1.0:
        raise ValueError(f"drop probability must be in [0, 1], got {p}")
    if mode not in ("batch", "row"):
        raise ValueError(f"mode must be 'batch' or 'row', got {mode!r}")


def _noise_shape(shape: Sequence[int], mode: str):
    if mode == "row":
        return (shape[0],) + (1,) * (len(shape) - 1)
    return (1,) * len(shape)


def stochastic_depth_keep(shape: Sequence[int], p: float, mode: str,
                          generator: torch.Generator,
                          device=None) -> torch.Tensor:
    """The keep mask of ``stochastic_depth`` for an input of ``shape``:
    bool, one coin for the batch (``"batch"``) or one a row (``"row"``),
    each True with probability ``1 - p``, drawn from ``generator``."""
    _check(p, mode)
    size = _noise_shape(shape, mode)
    return torch.rand(size, generator=generator, device=device) < 1.0 - p


def stochastic_depth(input: torch.Tensor, p: float, mode: str,
                     training: bool = True, *,
                     generator: Optional[torch.Generator] = None,
                     keep: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``input * keep / (1 - p)`` in training mode (with ``p`` < 1), the
    input itself otherwise. ``keep`` (bool or 0/1, of the shape
    ``stochastic_depth_keep`` gives) is drawn from ``generator`` unless
    handed in; the arithmetic is the JAX function's, in the input's
    type."""
    _check(p, mode)
    if not training or p == 0.0:
        return input
    if keep is None:
        if generator is None:
            raise ValueError("stochastic_depth requires a generator in "
                             "training mode")
        keep = stochastic_depth_keep(input.shape, p, mode, generator,
                                     input.device)
    elif tuple(keep.shape) != _noise_shape(input.shape, mode):
        raise ValueError(f"keep has shape {tuple(keep.shape)}, expected "
                         f"{_noise_shape(input.shape, mode)}")
    survival = 1.0 - p
    noise = keep.to(device=input.device, dtype=input.dtype)
    if survival > 0.0:
        noise = noise / survival
    return input * noise
