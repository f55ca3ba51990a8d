"""Counterpart of ``vision_tpu/ops/misc.py`` (FrozenBatchNorm2d only)."""

from __future__ import annotations

import torch
from torch import nn

__all__ = ["FrozenBatchNorm2d"]


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
