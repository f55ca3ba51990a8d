"""Aspect-ratio grouped batching (the port's copy of the repo's
``references/detection/group_by_aspect_ratio.py``; reference
``references/detection/group_by_aspect_ratio.py:1-196``): batches whose
images share an aspect-ratio bin, in the base sampler's order. The ratios
of a COCO dataset are read from its index, never by decoding images.
``group_canvas_sizes`` is the JAX recipe's canvas of each group; the
port's trainer pads every batch to its transform's canvas instead."""

from __future__ import annotations

import bisect
import math
from collections import defaultdict
from itertools import chain, repeat
from typing import List, Optional, Sequence

import numpy as np

__all__ = [
    "GroupedBatchSampler",
    "compute_aspect_ratios",
    "create_aspect_ratio_groups",
    "group_canvas_sizes",
]


def _repeat_to_at_least(iterable, n):
    times = math.ceil(n / len(iterable))
    return list(chain.from_iterable(repeat(iterable, times)))


class GroupedBatchSampler:
    """Wraps a sampler (any iterable of dataset indices) to yield
    mini-batches whose elements share a group id, staying as close as
    possible to the base sampler's order; tail batches are filled by
    repeating seen samples from the same group so the epoch length is
    deterministic (reference ``GroupedBatchSampler``)."""

    def __init__(self, sampler, group_ids: Sequence[int], batch_size: int):
        self.sampler = sampler
        self.group_ids = np.asarray(group_ids)
        self.batch_size = batch_size

    def __iter__(self):
        buffer_per_group = defaultdict(list)
        samples_per_group = defaultdict(list)
        num_batches = 0
        for idx in self.sampler:
            gid = int(self.group_ids[idx])
            buffer_per_group[gid].append(idx)
            samples_per_group[gid].append(idx)
            if len(buffer_per_group[gid]) == self.batch_size:
                yield buffer_per_group[gid]
                num_batches += 1
                del buffer_per_group[gid]

        expected = len(self)
        remaining = expected - num_batches
        if remaining > 0:
            for gid, _ in sorted(
                buffer_per_group.items(), key=lambda kv: len(kv[1]),
                reverse=True,
            ):
                need = self.batch_size - len(buffer_per_group[gid])
                refill = _repeat_to_at_least(samples_per_group[gid], need)
                buffer_per_group[gid].extend(refill[:need])
                yield buffer_per_group[gid]
                remaining -= 1
                if remaining == 0:
                    break
        assert remaining == 0

    def __len__(self):
        return len(self.sampler) // self.batch_size


def _aspect_ratios_coco(dataset, indices):
    # the index's width and height, never a decode
    return [
        dataset.coco.imgs[dataset.ids[i]]["width"]
        / dataset.coco.imgs[dataset.ids[i]]["height"]
        for i in indices
    ]


def compute_aspect_ratios(dataset, indices: Optional[Sequence[int]] = None):
    """Per-sample w/h. Fast paths (no image decode): CocoDetection
    (annotation metadata), datasets exposing ``get_height_and_width``;
    otherwise loads each image (reference ``_compute_aspect_ratios_slow``)."""
    if indices is None:
        indices = range(len(dataset))
    if hasattr(dataset, "coco") and hasattr(dataset, "ids"):
        return _aspect_ratios_coco(dataset, indices)
    if hasattr(dataset, "get_height_and_width"):
        return [
            (lambda hw: hw[1] / hw[0])(dataset.get_height_and_width(i))
            for i in indices
        ]
    out = []
    for i in indices:
        h, w = dataset[i][0].shape[-2:]  # a CHW image
        out.append(w / h)
    return out


def _quantize(values, bins):
    bins = sorted(bins)
    return [bisect.bisect_right(bins, v) for v in values]


def create_aspect_ratio_groups(dataset, k: int = 0) -> List[int]:
    """reference ``create_aspect_ratio_groups``: 2k+1 log-spaced bins in
    [1/2, 2]; k=0 means a single group (grouping disabled)."""
    aspect_ratios = compute_aspect_ratios(dataset)
    bins = (2 ** np.linspace(-1, 1, 2 * k + 1)).tolist() if k > 0 else [1.0]
    groups = _quantize(aspect_ratios, bins)
    counts = np.unique(groups, return_counts=True)[1]
    fbins = [0.0] + bins + [np.inf]
    print(f"Using {fbins} as bins for aspect ratio quantization")
    print(f"Count of instances per bin: {counts}")
    return groups


def group_canvas_sizes(k: int, short_side: int = 800, long_side: int = 1333):
    """The JAX recipe's static canvas (H, W) for each of the 2k+2 groups.
    Group g covers aspect ratios in (bins[g-1], bins[g]]; its canvas is the
    tightest (short, long)-constrained box holding that range, rounded up
    to a multiple of 32 (the FPN divisibility rule,
    reference ``detection/transform.py:237``)."""
    bins = (2 ** np.linspace(-1, 1, 2 * k + 1)).tolist() if k > 0 else [1.0]
    edges = [0.5] + bins + [2.0]
    sizes = []
    for g in range(len(bins) + 1):
        ar = edges[min(g + 1, len(edges) - 1)]  # widest ratio in the group
        if ar >= 1:  # landscape: height = short side
            h = short_side
            w = min(int(round(short_side * ar)), long_side)
        else:  # portrait
            w = short_side
            h = min(int(round(short_side / ar)), long_side)
        rnd = lambda v: int(math.ceil(v / 32.0) * 32)
        sizes.append((rnd(h), rnd(w)))
    return sizes
