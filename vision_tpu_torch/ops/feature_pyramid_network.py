"""Feature Pyramid Network, NCHW (counterpart of
``vision_tpu/ops/feature_pyramid_network.py``): 1x1 lateral convs,
top-down nearest upsampling, 3x3 smoothing, and the ``LastLevelMaxPool``
extra level. Module names are torchvision's (``inner_blocks.{i}.0``,
``layer_blocks.{i}.0``)."""

from __future__ import annotations

from collections import OrderedDict
from typing import Dict, List

import torch
import torch.nn.functional as F
from torch import nn

__all__ = ["FeaturePyramidNetwork", "LastLevelMaxPool"]


class LastLevelMaxPool(nn.Module):
    """Adds a "pool" level: stride-2 subsampling of the last output (a 1x1
    max-pool)."""

    def forward(self, results: List[torch.Tensor], names: List[str]):
        return results + [F.max_pool2d(results[-1], 1, 2, 0)], names + ["pool"]


class FeaturePyramidNetwork(nn.Module):
    """Takes an ordered dict of NCHW features, highest resolution first,
    and returns a dict with the same keys plus "pool"."""

    def __init__(self, in_channels_list: List[int], out_channels: int):
        super().__init__()
        self.inner_blocks = nn.ModuleList(
            nn.Sequential(nn.Conv2d(c, out_channels, 1)) for c in in_channels_list
        )
        self.layer_blocks = nn.ModuleList(
            nn.Sequential(nn.Conv2d(out_channels, out_channels, 3, padding=1))
            for _ in in_channels_list
        )
        self.extra_blocks = LastLevelMaxPool()

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
        results, names = self.extra_blocks(results, names)
        return OrderedDict(zip(names, results))
