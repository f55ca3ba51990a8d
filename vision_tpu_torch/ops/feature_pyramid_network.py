"""Feature Pyramid Network, NCHW (counterpart of
``vision_tpu/ops/feature_pyramid_network.py``): 1x1 lateral convs,
top-down nearest upsampling, 3x3 smoothing, and an extra block on top:
``LastLevelMaxPool`` (the R-CNN family's "pool" level) or
``LastLevelP6P7`` (RetinaNet's P6 and P7). Module names are torchvision's
(``inner_blocks.{i}.0``, ``layer_blocks.{i}.0``, ``extra_blocks.p6``)."""

from __future__ import annotations

from collections import OrderedDict
from typing import Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

__all__ = ["ExtraFPNBlock", "FeaturePyramidNetwork", "LastLevelMaxPool",
           "LastLevelP6P7"]


class ExtraFPNBlock(nn.Module):
    """Levels added after the FPN's outputs: ``forward(results, x, names)``
    takes the FPN's outputs, the FPN's inputs and the outputs' names, and
    returns the outputs and names extended."""

    def forward(self, results: List[torch.Tensor], x: List[torch.Tensor],
                names: List[str]) -> Tuple[List[torch.Tensor], List[str]]:
        raise NotImplementedError


class LastLevelMaxPool(ExtraFPNBlock):
    """Adds a "pool" level: stride-2 subsampling of the last output (a 1x1
    max-pool)."""

    def forward(self, results, x, names):
        return results + [F.max_pool2d(results[-1], 1, 2, 0)], names + ["pool"]


class LastLevelP6P7(ExtraFPNBlock):
    """Adds "p6" and "p7": a stride-2 3x3 conv of P5 (``in_channels ==
    out_channels``, v1) or of C5 (v2), then a stride-2 3x3 conv of its
    ReLU."""

    def __init__(self, in_channels: int, out_channels: int):
        super().__init__()
        self.p6 = nn.Conv2d(in_channels, out_channels, 3, 2, 1)
        self.p7 = nn.Conv2d(out_channels, out_channels, 3, 2, 1)
        self.use_P5 = in_channels == out_channels

    def forward(self, results, x, names):
        p6 = self.p6(results[-1] if self.use_P5 else x[-1])
        p7 = self.p7(F.relu(p6))
        return results + [p6, p7], names + ["p6", "p7"]


class FeaturePyramidNetwork(nn.Module):
    """Takes an ordered dict of NCHW features, highest resolution first,
    and returns a dict with the same keys plus the extra block's
    (``LastLevelMaxPool`` unless given)."""

    def __init__(self, in_channels_list: List[int], out_channels: int,
                 extra_blocks: Optional[ExtraFPNBlock] = None):
        super().__init__()
        self.inner_blocks = nn.ModuleList(
            nn.Sequential(nn.Conv2d(c, out_channels, 1)) for c in in_channels_list
        )
        self.layer_blocks = nn.ModuleList(
            nn.Sequential(nn.Conv2d(out_channels, out_channels, 3, padding=1))
            for _ in in_channels_list
        )
        self.extra_blocks = (LastLevelMaxPool() if extra_blocks is None
                             else extra_blocks)

    def forward(self, x: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        names = list(x.keys())
        feats = list(x.values())
        laterals = [blk(f) for blk, f in zip(self.inner_blocks, feats)]
        last_inner = laterals[-1]
        results = [self.layer_blocks[-1](last_inner)]
        for i in range(len(laterals) - 2, -1, -1):
            up = F.interpolate(last_inner, size=laterals[i].shape[-2:],
                               mode="nearest")
            last_inner = laterals[i] + up
            results.insert(0, self.layer_blocks[i](last_inner))
        results, names = self.extra_blocks(results, feats, names)
        return OrderedDict(zip(names, results))
