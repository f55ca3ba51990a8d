"""DropBlock (counterpart of ``vision_tpu/ops/drop_block.py``), NCHW and
NCDHW. Seeds are drawn with probability ``gamma`` on the positions where a
whole ``block_size`` block fits, each seed grows into a block by a max-pool
(``reduce_window`` "SAME" in JAX: stride 1, ``(block_size - 1) // 2`` of
padding before, the rest after), the blocks are zeroed, and the rest is
scaled by ``numel / (eps + kept)``. The seeds come from an explicit
``torch.Generator`` on the input's device, or are handed in (``seeds``)."""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

__all__ = ["drop_block2d", "drop_block3d", "drop_block_seeds"]


def _plan(shape: Sequence[int], p: float, block_size: int
          ) -> Tuple[int, float, Tuple[int, ...]]:
    """The block size clipped to the map, ``gamma``, and the seeds' shape
    ``[N, C, *(size - block + 1)]``, as the JAX function computes them."""
    spatial = tuple(shape[2:])
    bs = min(block_size, *spatial)
    valid = [s - bs + 1 for s in spatial]
    num, prod_valid = p, 1
    for s, v in zip(spatial, valid):
        num *= s  # ((p * h) * w), in the JAX function's order
        prod_valid *= v
    gamma = num / ((bs ** len(spatial)) * prod_valid)
    return bs, gamma, tuple(shape[:2]) + tuple(valid)


def _check(input: torch.Tensor, p: float, dims: int) -> None:
    if p < 0.0 or p > 1.0:
        raise ValueError(f"drop probability must be in [0, 1], got {p}")
    if input.ndim != dims + 2:
        layout = "NCHW" if dims == 2 else "NCDHW"
        raise ValueError(f"expected {dims + 2}D ({layout}) input, got "
                         f"{input.ndim}D")


def drop_block_seeds(shape: Sequence[int], p: float, block_size: int,
                     generator: torch.Generator, device=None) -> torch.Tensor:
    """The block seeds of ``drop_block2d`` / ``drop_block3d`` for an input
    of ``shape``: bool ``[N, C, *(size - block + 1)]``, each True with
    probability ``gamma``, drawn from ``generator``."""
    _, gamma, seed_shape = _plan(shape, p, block_size)
    return torch.rand(seed_shape, generator=generator, device=device) < gamma


def _drop_block(input, p, block_size, inplace, eps, training, generator,
                seeds, dims):
    _check(input, p, dims)
    if not training or p == 0.0:
        return input
    bs, _, seed_shape = _plan(input.shape, p, block_size)
    if seeds is None:
        if generator is None:
            raise ValueError(f"drop_block{dims}d requires a generator in "
                             "training mode")
        seeds = drop_block_seeds(input.shape, p, block_size, generator,
                                 input.device)
    elif tuple(seeds.shape) != seed_shape:
        raise ValueError(f"seeds have shape {tuple(seeds.shape)}, expected "
                         f"{seed_shape}")
    noise = seeds.to(device=input.device, dtype=input.dtype)
    # seeds placed at block_size // 2 from the start; F.pad lists the last
    # dim first
    pads, same = [], []
    for full, seed in zip(reversed(input.shape[2:]), reversed(seed_shape[2:])):
        lo = bs // 2
        pads += [lo, full - seed - lo]
        same += [(bs - 1) // 2, bs - 1 - (bs - 1) // 2]
    # the max-pool's "SAME" padding: zeros are as good as -inf beside a
    # window that holds at least one value >= 0
    noise = F.pad(F.pad(noise, pads), same)
    pool = F.max_pool2d if dims == 2 else F.max_pool3d
    mask = 1.0 - pool(noise, bs, stride=1)
    kept = mask.sum()
    # a tensor over a tensor: ``numel / tensor`` would be torch's product
    # with the reciprocal, an ulp from JAX's quotient
    scale = torch.full_like(kept, mask.numel()) / (eps + kept)
    if inplace:
        return input.mul_(mask).mul_(scale)
    return input * mask * scale


def drop_block2d(input: torch.Tensor, p: float, block_size: int,
                 inplace: bool = False, eps: float = 1e-06,
                 training: bool = True, *,
                 generator: Optional[torch.Generator] = None,
                 seeds: Optional[torch.Tensor] = None) -> torch.Tensor:
    """DropBlock on NCHW ``input`` in training mode (with ``p`` > 0), the
    input itself otherwise. ``seeds`` (bool or 0/1, of the shape
    ``drop_block_seeds`` gives) are drawn from ``generator`` unless handed
    in; ``inplace`` scales ``input`` in place."""
    return _drop_block(input, p, block_size, inplace, eps, training,
                       generator, seeds, 2)


def drop_block3d(input: torch.Tensor, p: float, block_size: int,
                 inplace: bool = False, eps: float = 1e-06,
                 training: bool = True, *,
                 generator: Optional[torch.Generator] = None,
                 seeds: Optional[torch.Tensor] = None) -> torch.Tensor:
    """DropBlock on NCDHW ``input`` (``drop_block2d``'s contract)."""
    return _drop_block(input, p, block_size, inplace, eps, training,
                       generator, seeds, 3)
