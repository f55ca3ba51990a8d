"""Anchor generation (counterpart of
``vision_tpu/models/detection/anchor_utils.py``): ``AnchorGenerator``
(the R-CNNs', RetinaNet's and FCOS's) and ``DefaultBoxGenerator`` (the
SSDs' default boxes)."""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

__all__ = ["AnchorGenerator", "DefaultBoxGenerator"]


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


class DefaultBoxGenerator:
    """SSD's default boxes: for each feature map ``k``, at every location
    (centres ``(j + 0.5) / step``, ``step`` the map's size or ``img /
    steps[k]``) a box of scale ``s_k``, one of ``sqrt(s_k s_{k+1})`` and a
    pair ``(s_k sqrt(r), s_k / sqrt(r))``, ``(s_k / sqrt(r), s_k sqrt(r))``
    for each aspect ratio ``r`` of ``aspect_ratios[k]``; widths and heights
    clipped to [0, 1] when ``clip``. Scales run linearly from ``min_ratio``
    to ``max_ratio`` over the maps (then 1.0) unless ``scales`` are given.
    ``__call__`` returns one ``[sum(H*W*A), 4]`` xyxy tensor in image
    coordinates, boxes a-major within a location, computed in f32 numpy as
    the JAX package computes them, so the two agree bit for bit; cached per
    (image size, map sizes, device)."""

    def __init__(
        self,
        aspect_ratios: Sequence[Sequence[int]],
        min_ratio: float = 0.15,
        max_ratio: float = 0.9,
        scales: Optional[Sequence[float]] = None,
        steps: Optional[Sequence[int]] = None,
        clip: bool = True,
    ):
        self.aspect_ratios = [list(r) for r in aspect_ratios]
        self.steps = steps
        self.clip = clip
        k = len(aspect_ratios)
        if scales is None:
            if k > 1:
                self.scales = [min_ratio + (max_ratio - min_ratio) * i / (k - 1.0)
                               for i in range(k)] + [1.0]
            else:
                self.scales = [min_ratio, max_ratio]
        else:
            self.scales = list(scales)
        self._wh_pairs = [self._wh(i) for i in range(k)]
        self._cache: Dict[tuple, torch.Tensor] = {}

    def _wh(self, k: int) -> np.ndarray:
        s_k = self.scales[k]
        s_prime = math.sqrt(self.scales[k] * self.scales[k + 1])
        pairs = [[s_k, s_k], [s_prime, s_prime]]
        for ar in self.aspect_ratios[k]:
            sq = math.sqrt(ar)
            pairs += [[s_k * sq, s_k / sq], [s_k / sq, s_k * sq]]
        return np.asarray(pairs, dtype=np.float32)

    def num_anchors_per_location(self) -> List[int]:
        return [2 + 2 * len(r) for r in self.aspect_ratios]

    def __call__(
        self,
        image_size: Tuple[int, int],
        feature_map_sizes: Sequence[Tuple[int, int]],
        device: torch.device,
    ) -> torch.Tensor:
        key = (tuple(image_size), tuple(map(tuple, feature_map_sizes)),
               str(device))
        cached = self._cache.get(key)
        if cached is None:
            cached = torch.as_tensor(self._boxes(image_size, feature_map_sizes),
                                     dtype=torch.float32, device=device)
            self._cache[key] = cached
        return cached

    def _boxes(self, image_size, feature_map_sizes) -> np.ndarray:
        img_h, img_w = image_size
        out = []
        for k, (fh, fw) in enumerate(feature_map_sizes):
            if self.steps is not None:
                x_step, y_step = img_w / self.steps[k], img_h / self.steps[k]
            else:
                x_step, y_step = float(fw), float(fh)
            shifts_x = ((np.arange(fw) + 0.5) / x_step).astype(np.float32)
            shifts_y = ((np.arange(fh) + 0.5) / y_step).astype(np.float32)
            sy, sx = np.meshgrid(shifts_y, shifts_x, indexing="ij")
            sx, sy = sx.reshape(-1), sy.reshape(-1)
            wh = np.clip(self._wh_pairs[k], 0, 1) if self.clip else self._wh_pairs[k]
            a = wh.shape[0]
            out.append(np.stack([np.repeat(sx, a), np.repeat(sy, a),
                                 np.tile(wh[:, 0], sx.shape[0]),
                                 np.tile(wh[:, 1], sx.shape[0])], axis=1))
        d = np.concatenate(out, axis=0)
        return np.stack([(d[:, 0] - 0.5 * d[:, 2]) * img_w,
                         (d[:, 1] - 0.5 * d[:, 3]) * img_h,
                         (d[:, 0] + 0.5 * d[:, 2]) * img_w,
                         (d[:, 1] + 0.5 * d[:, 3]) * img_h], axis=1)
