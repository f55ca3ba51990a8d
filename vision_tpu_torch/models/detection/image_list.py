"""ImageList (counterpart of ``vision_tpu/models/detection/image_list.py``):
a padded batch and each image's size inside it."""

from __future__ import annotations

from typing import List, Tuple

import torch

__all__ = ["ImageList"]


class ImageList:
    def __init__(self, tensors: torch.Tensor, image_sizes: List[Tuple[int, int]]):
        self.tensors = tensors  # [N, C, H, W], padded
        self.image_sizes = image_sizes  # (h, w) of each image's region
