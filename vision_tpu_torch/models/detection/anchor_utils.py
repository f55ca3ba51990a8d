"""Anchor generation (counterpart of
``vision_tpu/models/detection/anchor_utils.py``)."""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch

__all__ = ["AnchorGenerator"]


class AnchorGenerator:
    """Per-level anchors ``[H*W*A, 4]`` (xyxy, image coordinates) in
    ``(h, w, a)`` order. Cell anchors are rounded with ``np.round`` as in
    the JAX package. The grid is built once per (image size, feature
    sizes, device) and cached on the device. No parameters or buffers."""

    def __init__(
        self,
        sizes: Sequence[Sequence[int]] = ((128, 256, 512),),
        aspect_ratios: Sequence[Sequence[float]] = ((0.5, 1.0, 2.0),),
    ):
        self.sizes = tuple(tuple(s) for s in sizes)
        self.aspect_ratios = tuple(tuple(a) for a in aspect_ratios)
        self.cell_anchors = [
            self._generate_anchors(s, a)
            for s, a in zip(self.sizes, self.aspect_ratios)
        ]
        self._cache: Dict[tuple, List[torch.Tensor]] = {}

    @staticmethod
    def _generate_anchors(scales, aspect_ratios) -> np.ndarray:
        scales = np.asarray(scales, dtype=np.float32)
        aspect_ratios = np.asarray(aspect_ratios, dtype=np.float32)
        h_ratios = np.sqrt(aspect_ratios)
        w_ratios = 1.0 / h_ratios
        ws = (w_ratios[:, None] * scales[None, :]).reshape(-1)
        hs = (h_ratios[:, None] * scales[None, :]).reshape(-1)
        return np.round(np.stack([-ws, -hs, ws, hs], axis=1) / 2)

    def num_anchors_per_location(self) -> List[int]:
        return [len(s) * len(a) for s, a in zip(self.sizes, self.aspect_ratios)]

    def __call__(
        self,
        image_size: Tuple[int, int],
        feature_map_sizes: Sequence[Tuple[int, int]],
        device: torch.device,
    ) -> List[torch.Tensor]:
        key = (tuple(image_size), tuple(map(tuple, feature_map_sizes)),
               str(device))
        cached = self._cache.get(key)
        if cached is None:
            cached = [
                torch.as_tensor(a, dtype=torch.float32, device=device)
                for a in self._grid(image_size, feature_map_sizes)
            ]
            self._cache[key] = cached
        return cached

    def _grid(self, image_size, feature_map_sizes) -> List[np.ndarray]:
        img_h, img_w = image_size
        out = []
        for (fh, fw), cell in zip(feature_map_sizes, self.cell_anchors):
            shifts_x = np.arange(fw, dtype=np.float32) * (img_w // fw)
            shifts_y = np.arange(fh, dtype=np.float32) * (img_h // fh)
            sy, sx = np.meshgrid(shifts_y, shifts_x, indexing="ij")
            sx, sy = sx.reshape(-1), sy.reshape(-1)
            shifts = np.stack([sx, sy, sx, sy], axis=1)  # [H*W, 4]
            out.append((shifts[:, None, :] + cell[None]).reshape(-1, 4))
        return out
