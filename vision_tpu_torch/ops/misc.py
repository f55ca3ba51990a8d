"""Normalisation modules: ``FrozenBatchNorm2d`` (counterpart of
``vision_tpu/ops/misc.py``), the live ``BatchNorm2d`` of the
classification models and the v2 detection trunk (counterpart of
``flax.linen.BatchNorm`` as ``vision_tpu/models/resnet.py`` configures it,
and of its ``_BNAffine``), and ``GroupNorm`` (counterpart of
``flax.linen.GroupNorm``, in RetinaNet's v2 head)."""

from __future__ import annotations

from typing import Tuple

import torch
from torch import nn

__all__ = ["BatchNorm2d", "FrozenBatchNorm2d", "GroupNorm",
           "batch_mean_var"]


class FrozenBatchNorm2d(nn.Module):
    """BatchNorm2d with fixed statistics and affine terms, all four held as
    buffers (not parameters), under torchvision's names. The folded scale
    is ``weight * rsqrt(running_var + eps)``, as the JAX ``_FrozenBN``
    computes it (``vision_tpu/models/detection/backbone_utils.py:47-48``).
    Input NCHW."""

    def __init__(self, num_features: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.register_buffer("weight", torch.ones(num_features))
        self.register_buffer("bias", torch.zeros(num_features))
        self.register_buffer("running_mean", torch.zeros(num_features))
        self.register_buffer("running_var", torch.ones(num_features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        scale = self.weight * torch.rsqrt(self.running_var + self.eps)
        shift = self.bias - self.running_mean * scale
        return x * scale[None, :, None, None] + shift[None, :, None, None]


def batch_mean_var(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-channel mean and biased variance of NCHW ``x`` over N, H, W, in
    f32, the variance as ``max(0, E[x^2] - E[x]^2)`` (flax's
    ``use_fast_variance``)."""
    xf = x.float()
    mean = xf.mean((0, 2, 3))
    var = ((xf * xf).mean((0, 2, 3)) - mean * mean).clamp_(min=0.0)
    return mean, var


class BatchNorm2d(nn.Module):
    """Batch norm over NCHW input under ``torch.nn.BatchNorm2d``'s names
    (``weight``, ``bias``, ``running_mean``, ``running_var``,
    ``num_batches_tracked``) with the arithmetic of ``flax.linen.BatchNorm``,
    which the JAX package uses and the port is held against:

    * the statistics are f32 whatever the input type, the variance is
      ``max(0, E[x^2] - E[x]^2)``;
    * ``running_var`` is updated with that BIASED variance.
      ``torch.nn.BatchNorm2d`` updates it with the unbiased one, a factor
      ``M / (M - 1)``, so it is not used here;
    * ``y = (x - mean) * (rsqrt(var + eps) * weight) + bias`` in f32, cast
      to the promoted type of ``x``, ``weight`` and ``bias``.

    ``momentum`` follows torch's convention: 0.1 here is flax's 0.9.
    The running statistics are updated in place, outside autograd.
    """

    def __init__(self, num_features: int, eps: float = 1e-5,
                 momentum: float = 0.1):
        super().__init__()
        self.num_features = num_features
        self.eps = eps
        self.momentum = momentum
        self.weight = nn.Parameter(torch.ones(num_features))
        self.bias = nn.Parameter(torch.zeros(num_features))
        self.register_buffer("running_mean", torch.zeros(num_features))
        self.register_buffer("running_var", torch.ones(num_features))
        self.register_buffer("num_batches_tracked",
                             torch.zeros((), dtype=torch.long))

    @torch.no_grad()
    def _track(self, mean: torch.Tensor, var: torch.Tensor) -> None:
        m = self.momentum
        self.running_mean.copy_((1 - m) * self.running_mean + m * mean)
        self.running_var.copy_((1 - m) * self.running_var + m * var)
        self.num_batches_tracked += 1

    def affine_from_stats(
        self, mean: torch.Tensor, var: torch.Tensor
    ) -> Tuple[torch.Tensor, torch.Tensor]:
        """For batch statistics computed elsewhere (the fused 1x1-conv
        kernel's epilogue): update the running statistics when training and
        return f32 ``(inv, shift)`` with ``y_norm = y * inv + shift``
        (``vision_tpu/models/resnet.py:_BNAffine``)."""
        if self.training:
            self._track(mean, var)
        inv = torch.rsqrt(var + self.eps) * self.weight.float()
        return inv, self.bias.float() - mean * inv

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.training:
            mean, var = batch_mean_var(x)
            self._track(mean, var)
        else:
            mean, var = self.running_mean, self.running_var
        mul = torch.rsqrt(var + self.eps) * self.weight.float()
        y = (x.float() - mean[None, :, None, None]) * mul[None, :, None, None]
        y = y + self.bias.float()[None, :, None, None]
        out_dtype = torch.promote_types(
            x.dtype, torch.promote_types(self.weight.dtype, self.bias.dtype))
        return y.to(out_dtype)


class GroupNorm(nn.Module):
    """Group norm over NCHW input under ``torch.nn.GroupNorm``'s names
    (``weight``, ``bias``) with the arithmetic of ``flax.linen.GroupNorm``:
    each group's mean and variance over (C / G, H, W) in f32, the variance
    as ``max(0, E[x^2] - E[x]^2)`` (``torch.nn.GroupNorm`` takes Welford's);
    ``y = (x - mean) * (rsqrt(var + eps) * weight) + bias`` in f32, cast to
    the promoted type of ``x``, ``weight`` and ``bias``."""

    def __init__(self, num_groups: int, num_channels: int, eps: float = 1e-5):
        super().__init__()
        if num_channels % num_groups:
            raise ValueError(f"{num_groups} groups do not divide "
                             f"{num_channels} channels")
        self.num_groups = num_groups
        self.num_channels = num_channels
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(num_channels))
        self.bias = nn.Parameter(torch.zeros(num_channels))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        n, c = x.shape[:2]
        xf = x.float().reshape(n, self.num_groups, -1)
        mean = xf.mean(-1)
        var = ((xf * xf).mean(-1) - mean * mean).clamp(min=0.0)
        size = c // self.num_groups  # the groups' statistics to channels
        mean = mean.repeat_interleave(size, 1)[..., None]
        mul = torch.rsqrt(var + self.eps).repeat_interleave(size, 1)
        mul = (mul * self.weight.float())[..., None]
        y = (xf.reshape(n, c, -1) - mean) * mul + self.bias.float()[:, None]
        out_dtype = torch.promote_types(
            x.dtype, torch.promote_types(self.weight.dtype, self.bias.dtype))
        return y.reshape(x.shape).to(out_dtype)
