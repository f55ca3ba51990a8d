"""Module forms of the functional ops (counterpart of
``vision_tpu/ops/_wrappers.py``), as torchvision exports them beside the
functions: ``RoIAlign``, ``RoIPool``, ``PSRoIAlign``, ``PSRoIPool``,
``StochasticDepth``, ``DropBlock2d``, ``DropBlock3d``. They hold no
parameters. ``RoIAlign`` calls ``ops/roi_align.py``'s ``roi_align``, the
CUDA kernel on the card. The random ones act in training mode
(``module.training``) and draw from ``forward(x, generator=g)``."""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from vision_tpu_torch.ops.drop_block import drop_block2d, drop_block3d
from vision_tpu_torch.ops.ps_roi_align import ps_roi_align
from vision_tpu_torch.ops.ps_roi_pool import ps_roi_pool
from vision_tpu_torch.ops.roi_align import _pair, _Size, roi_align
from vision_tpu_torch.ops.roi_pool import roi_pool
from vision_tpu_torch.ops.stochastic_depth import stochastic_depth

__all__ = ["DropBlock2d", "DropBlock3d", "PSRoIAlign", "PSRoIPool",
           "RoIAlign", "RoIPool", "StochasticDepth"]


class RoIAlign(nn.Module):
    def __init__(self, output_size: _Size, spatial_scale: float = 1.0,
                 sampling_ratio: int = -1, aligned: bool = False):
        super().__init__()
        self.output_size = _pair(output_size)
        self.spatial_scale = spatial_scale
        self.sampling_ratio = sampling_ratio
        self.aligned = aligned

    def forward(self, input: torch.Tensor, rois: torch.Tensor) -> torch.Tensor:
        return roi_align(input, rois, self.output_size, self.spatial_scale,
                         self.sampling_ratio, self.aligned)

    def extra_repr(self) -> str:
        return (f"output_size={self.output_size}, "
                f"spatial_scale={self.spatial_scale}, "
                f"sampling_ratio={self.sampling_ratio}, aligned={self.aligned}")


class RoIPool(nn.Module):
    def __init__(self, output_size: _Size, spatial_scale: float = 1.0):
        super().__init__()
        self.output_size = _pair(output_size)
        self.spatial_scale = spatial_scale

    def forward(self, input: torch.Tensor, rois: torch.Tensor) -> torch.Tensor:
        return roi_pool(input, rois, self.output_size, self.spatial_scale)

    def extra_repr(self) -> str:
        return (f"output_size={self.output_size}, "
                f"spatial_scale={self.spatial_scale}")


class PSRoIAlign(nn.Module):
    def __init__(self, output_size: _Size, spatial_scale: float = 1.0,
                 sampling_ratio: int = -1):
        super().__init__()
        self.output_size = _pair(output_size)
        self.spatial_scale = spatial_scale
        self.sampling_ratio = sampling_ratio

    def forward(self, input: torch.Tensor, rois: torch.Tensor) -> torch.Tensor:
        return ps_roi_align(input, rois, self.output_size, self.spatial_scale,
                            self.sampling_ratio)

    def extra_repr(self) -> str:
        return (f"output_size={self.output_size}, "
                f"spatial_scale={self.spatial_scale}, "
                f"sampling_ratio={self.sampling_ratio}")


class PSRoIPool(RoIPool):
    def forward(self, input: torch.Tensor, rois: torch.Tensor) -> torch.Tensor:
        return ps_roi_pool(input, rois, self.output_size, self.spatial_scale)


class StochasticDepth(nn.Module):
    def __init__(self, p: float, mode: str):
        super().__init__()
        self.p = p
        self.mode = mode

    def forward(self, input: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        return stochastic_depth(input, self.p, self.mode, self.training,
                                generator=generator)

    def extra_repr(self) -> str:
        return f"p={self.p}, mode={self.mode}"


class DropBlock2d(nn.Module):
    def __init__(self, p: float, block_size: int, inplace: bool = False,
                 eps: float = 1e-06):
        super().__init__()
        self.p = p
        self.block_size = block_size
        self.inplace = inplace
        self.eps = eps

    def forward(self, input: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        return drop_block2d(input, self.p, self.block_size, self.inplace,
                            self.eps, self.training, generator=generator)

    def extra_repr(self) -> str:
        return (f"p={self.p}, block_size={self.block_size}, "
                f"inplace={self.inplace}")


class DropBlock3d(DropBlock2d):
    def forward(self, input: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        return drop_block3d(input, self.p, self.block_size, self.inplace,
                            self.eps, self.training, generator=generator)
