"""Load the JAX package's flax variables into a port module.

The inverse of ``vision_tpu/_torch_convert.py`` for the modules of the
port, working on nested dicts of numpy arrays (so this module needs no
JAX): conv kernels HWIO -> OIHW, dense kernels IO -> OI, batch norm
``scale`` -> ``weight``, the ``batch_stats`` collection (``mean``, ``var``)
-> ``running_mean``, ``running_var``, the ``frozen`` collection -> the
frozen-BN buffers, and the Faster R-CNN renames (FPN
``inner_blocks_{i}`` -> ``inner_blocks.{i}.0``, and ``fc6`` from the JAX
HWC flatten of the pooled features to torch's CHW flatten).
"""

from __future__ import annotations

import re
from typing import Any, Iterator, Mapping, Tuple

import numpy as np
import torch
from torch import nn

__all__ = ["load_jax_variables"]


def _leaves(tree: Mapping[str, Any], prefix: Tuple[str, ...] = ()
            ) -> Iterator[Tuple[Tuple[str, ...], Any]]:
    for k, v in tree.items():
        if isinstance(v, Mapping):
            yield from _leaves(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def _torch_name(collection: str, path: Tuple[str, ...]) -> str:
    *mods, leaf = path
    base = ".".join(mods)
    base = re.sub(r"\b(inner_blocks|layer_blocks)_(\d+)", r"\1.\2.0", base)
    if collection == "params":
        leaf = {"kernel": "weight", "scale": "weight"}.get(leaf, leaf)
    elif collection == "batch_stats":
        leaf = {"mean": "running_mean", "var": "running_var"}[leaf]
    elif collection != "frozen":
        raise KeyError(f"cannot map collection {collection!r}")
    return f"{base}.{leaf}"


def _to_torch_layout(name: str, arr: np.ndarray, target: torch.Tensor,
                     module: nn.Module) -> np.ndarray:
    if arr.ndim == 4:  # HWIO -> OIHW
        arr = arr.transpose(3, 2, 0, 1)
    elif arr.ndim == 2:  # IO -> OI
        arr = arr.T
        if name.endswith("box_head.fc6.weight"):
            ph, pw = module.roi_heads.box_roi_pool.output_size
            out, flat = arr.shape
            arr = arr.reshape(out, ph, pw, flat // (ph * pw)).transpose(0, 3, 1, 2)
            arr = arr.reshape(out, flat)
    if tuple(arr.shape) != tuple(target.shape):
        raise ValueError(f"{name}: JAX shape {arr.shape} vs torch "
                         f"{tuple(target.shape)}")
    return arr


@torch.no_grad()
def load_jax_variables(module: nn.Module, variables: Mapping[str, Any]) -> None:
    """Copy every leaf of ``variables`` (``{"params": ..., "batch_stats":
    ..., "frozen": ...}`` as nested dicts of arrays) into ``module``'s
    parameters and buffers. Raises unless every leaf has a target and every
    tensor of the module a source (``num_batches_tracked`` counters have
    none in JAX and are left alone)."""
    targets = dict(module.named_parameters())
    targets.update(module.named_buffers())
    loaded = set()
    for collection, tree in variables.items():
        for path, value in _leaves(tree):
            name = _torch_name(collection, path)
            if name not in targets:
                raise KeyError(f"{collection}/{'/'.join(path)} -> {name}: no "
                               "such parameter or buffer")
            arr = _to_torch_layout(name, np.asarray(value), targets[name], module)
            targets[name].copy_(torch.as_tensor(np.array(arr)))
            loaded.add(name)
    missing = sorted(n for n in set(targets) - loaded
                     if not n.endswith("num_batches_tracked"))
    if missing:
        raise KeyError(f"not in the JAX variables ({len(missing)}): {missing[:10]}")
