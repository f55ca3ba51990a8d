"""Sharding, collation and host-side batching (the JAX contract of
``vision_tpu/datasets/samplers.py:23, 135, 152``, on ``torch.utils.data``).

* :class:`DistributedSampler` shards indices as the JAX one does: one
  ``numpy`` permutation of ``seed + epoch`` on every process, padded with
  wrap-around duplicates to equal shards, a strided slice each (the torch
  sampler's own permutation draws from a ``torch.Generator`` and would
  shard differently from the JAX loader and ``DeviceJpegLoader``);
* :func:`default_collate` stacks tensors, arrays and numbers with
  ``torch.utils.data.default_collate`` and keeps tuples tuples and other
  objects lists, as the JAX one does;
* :class:`DataLoader` loads the samples of a batch on a pool of threads:
  the codecs release the interpreter lock in their ctypes calls, and a
  process that holds the card must not fork (``torch.utils.data``'s
  DataLoader workers are processes).

The clip samplers wait for the video datasets.
"""

from __future__ import annotations

import math
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Callable, Iterator, List, Optional

import numpy as np
import torch
import torch.utils.data

__all__ = ["DataLoader", "DistributedSampler", "default_collate"]


class DistributedSampler(torch.utils.data.Sampler):
    """Shards ``range(len(dataset))`` over ``num_replicas`` processes, pads
    to equal length, reshuffles each epoch after :meth:`set_epoch`
    (``vision_tpu/datasets/samplers.py:23``). ``num_replicas`` / ``rank``
    default to ``torch.distributed``'s where it is initialised, else 1 / 0."""

    def __init__(self, dataset, num_replicas: Optional[int] = None,
                 rank: Optional[int] = None, shuffle: bool = True,
                 seed: int = 0, drop_last: bool = False):
        dist = torch.distributed
        live = dist.is_available() and dist.is_initialized()
        if num_replicas is None:
            num_replicas = dist.get_world_size() if live else 1
        if rank is None:
            rank = dist.get_rank() if live else 0
        if rank >= num_replicas or rank < 0:
            raise ValueError(f"invalid rank {rank} for {num_replicas} replicas")
        self.dataset = dataset
        self.num_replicas = num_replicas
        self.rank = rank
        self.shuffle = shuffle
        self.seed = seed
        self.drop_last = drop_last
        n = len(dataset)
        if drop_last and n % num_replicas != 0:
            self.num_samples = n // num_replicas
        else:
            self.num_samples = math.ceil(n / num_replicas)
        self.total_size = self.num_samples * num_replicas
        self.epoch = 0

    def set_epoch(self, epoch: int) -> None:
        self.epoch = epoch

    def __iter__(self) -> Iterator[int]:
        n = len(self.dataset)
        if self.shuffle:
            indices = np.random.RandomState(self.seed + self.epoch).permutation(n).tolist()
        else:
            indices = list(range(n))
        if not self.drop_last:
            pad = self.total_size - len(indices)
            indices += indices[:pad] if pad <= len(indices) else (
                indices * math.ceil(pad / max(len(indices), 1)))[:pad]
        else:
            indices = indices[:self.total_size]
        return iter(indices[self.rank:self.total_size:self.num_replicas])

    def __len__(self) -> int:
        return self.num_samples


def default_collate(batch: List[Any]):
    """A list of samples as one batch (``vision_tpu/datasets/samplers.py:
    135``): tensors, arrays and numbers stacked by
    ``torch.utils.data.default_collate`` (ints to int64, floats to
    float64), tuples and lists field by field into their own type, dicts
    key by key; anything else is returned as the list."""
    elem = batch[0]
    if isinstance(elem, (torch.Tensor, np.ndarray, int, float, np.integer,
                         np.floating)) and not isinstance(elem, bool):
        return torch.utils.data.default_collate(batch)
    if isinstance(elem, (tuple, list)):
        return type(elem)(default_collate(list(s)) for s in zip(*batch))
    if isinstance(elem, dict):
        return {k: default_collate([d[k] for d in batch]) for k in elem}
    return batch


class DataLoader:
    """Batches of a dataset loaded on a pool of ``num_workers`` threads (0:
    on the caller's thread), in the order of ``sampler``, or shuffled by a
    ``numpy`` permutation of ``seed + epoch``, or in order
    (``vision_tpu/datasets/samplers.py:152``). Feed the batches to the card
    with ``io.prefetch_to_device``."""

    def __init__(self, dataset, batch_size: int = 1, shuffle: bool = False,
                 sampler: Optional[Any] = None, num_workers: int = 0,
                 collate_fn: Optional[Callable] = None, drop_last: bool = False,
                 seed: int = 0):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.sampler = sampler
        self.num_workers = num_workers
        self.collate_fn = collate_fn or default_collate
        self.drop_last = drop_last
        self.seed = seed
        self._epoch = 0

    def set_epoch(self, epoch: int) -> None:
        self._epoch = epoch
        if self.sampler is not None and hasattr(self.sampler, "set_epoch"):
            self.sampler.set_epoch(epoch)

    def _indices(self) -> List[int]:
        if self.sampler is not None:
            return list(self.sampler)
        n = len(self.dataset)
        if self.shuffle:
            return np.random.RandomState(self.seed + self._epoch).permutation(n).tolist()
        return list(range(n))

    def __iter__(self):
        indices = self._indices()
        batches = [indices[i:i + self.batch_size]
                   for i in range(0, len(indices), self.batch_size)]
        if self.drop_last and batches and len(batches[-1]) < self.batch_size:
            batches.pop()
        if self.num_workers <= 0:
            for batch_idx in batches:
                yield self.collate_fn([self.dataset[i] for i in batch_idx])
            return
        with ThreadPoolExecutor(self.num_workers,
                                thread_name_prefix="data-loader") as pool:
            ahead = None
            for batch_idx in batches + [None]:
                nxt = (None if batch_idx is None
                       else [pool.submit(self.dataset.__getitem__, i)
                             for i in batch_idx])
                if ahead is not None:  # the next batch loads meanwhile
                    yield self.collate_fn([f.result() for f in ahead])
                ahead = nxt

    def __len__(self) -> int:
        n = len(self.sampler) if self.sampler is not None else len(self.dataset)
        if self.drop_last:
            return n // self.batch_size
        return math.ceil(n / self.batch_size)
