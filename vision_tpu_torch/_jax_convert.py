"""Load the JAX package's flax variables into a port module.

The inverse of ``vision_tpu/_torch_convert.py`` for the modules of the
port, working on nested dicts of numpy arrays (so this module needs no
JAX): conv kernels HWIO -> OIHW (3-D: DHWIO -> OIDHW), dense kernels IO -> OI, batch norm
``scale`` -> ``weight``, the ``batch_stats`` collection (``mean``, ``var``)
-> ``running_mean``, ``running_var``, the ``frozen`` collection -> the
frozen-BN buffers, and the Faster R-CNN renames (FPN
``inner_blocks_{i}`` -> ``inner_blocks.{i}.0``, v2's ``inner_norm_{i}``
-> ``inner_blocks.{i}.1`` and ``layer_norm_{i}`` -> ``layer_blocks.{i}.1``,
and a Linear whose JAX counterpart reads an HWC flatten where the port
flattens CHW, reordered: a parent module names such children in its
``jax_hwc_inputs``, child name -> ``(h, w)`` of the map: Faster R-CNN's
``box_head.fc6`` or v2's ``box_head.5``, AlexNet's ``classifier.1``, VGG's
``classifier.0``, GoogLeNet's ``aux{1,2}.fc1``). ConvNeXt's ``layer_scale``
(``(dim,)`` in JAX) takes torchvision's ``(dim, 1, 1)``; the 2-D
``relative_position_bias_table`` of Swin and MaxViT is not a Dense kernel
and keeps its ``[offsets, heads]`` layout, as do the video Swin's 3-D
one and MViT's ``rel_pos_{h,w,t}`` and ``pos_encoding.spatial_pos`` /
``temporal_pos`` tables. A port module with a
``jax_names`` dict (``ops.misc.MLP``) renames its children by it. flax
``GroupNorm``'s ``scale`` is a ``weight`` as batch norm's is; RetinaNet's
extra blocks, ``backbone/extra_blocks/p6`` beside the JAX FPN, go to
torchvision's ``backbone.fpn.extra_blocks.p6``; its towers' names
(``head.classification_head.conv.{i}.0``, ``.cls_logits``,
``regression_head.bbox_reg``) are the port's as they stand. ViT's flax
names already hold dots (``encoder.layers.encoder_layer_{i}``, ``mlp.0``,
``heads.head``) and join as they are; its top-level ``class_token`` and
``encoder.pos_embedding`` carry across unchanged; its attention's ``in_proj``
Dense (``[D, 3D]``, columns q, k, v) is torch's ``in_proj_weight`` (``[3D,
D]``, the row blocks in the same order) and ``in_proj_bias``. The last
detectors load as they stand: FCOS's towers (``conv.{3i}`` convolutions,
``conv.{3i+1}`` GroupNorms) and its P6/P7 (inside the JAX FPN too);
SSD's ``backbone.scale_weight`` (a top-level parameter of the extractor)
and ``features.N`` / ``extra.N``; SSDlite's batch statistics (the
``batch_stats`` collection), and the second half of its split C4 block,
which JAX numbers from 0 and the port, as torchvision, from 1
(``ssdlite._C4Rest.jax_names``); the MobileNet FPN trunk's frozen norms
(``frozen``, ``backbone.body.N``).

Transposed convolutions (the Mask R-CNN and Keypoint R-CNN predictors'
``conv5_mask`` and ``kps_score_lowres``): a flax ``nn.ConvTranspose``
kernel is ``(kh, kw, in, out)`` and, with flax's default
``transpose_kernel=False``, is applied without a spatial flip, where
``torch.nn.ConvTranspose2d`` scatters with its ``(in, out, kh, kw)``
weight as it lies. So the kernel maps to the weight transposed to
``(in, out, kh, kw)`` and flipped along both spatial axes; flax's
``"SAME"`` padding at stride 2 is torch's ``padding=(k - 2) // 2`` (0
for the 2x2 kernel, 1 for the 4x4), which the port's modules set
(``tests/test_torch_mask_rcnn.py`` pins both with kernels that are not
symmetric).
"""

from __future__ import annotations

import re
from typing import Any, Dict, Iterator, Mapping, Tuple

import numpy as np
import torch
from torch import nn

__all__ = ["jax_placements", "load_jax_variables"]


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
    # the v2 FPN's norms: the second child of torchvision's block
    base = re.sub(r"\b(inner|layer)_norm_(\d+)", r"\1_blocks.\2.1", base)
    # RetinaNet's P6 and P7 sit beside the JAX FPN, inside torchvision's
    base = re.sub(r"^backbone\.extra_blocks\.", "backbone.fpn.extra_blocks.", base)
    if collection == "params":
        leaf = {"kernel": "weight", "scale": "weight"}.get(leaf, leaf)
    elif collection == "batch_stats":
        leaf = {"mean": "running_mean", "var": "running_var"}[leaf]
    elif collection != "frozen":
        raise KeyError(f"cannot map collection {collection!r}")
    name = f"{base}.{leaf}" if base else leaf
    # ViT's packed attention projection: a flax Dense, torch's
    # nn.MultiheadAttention parameters
    return re.sub(r"\.in_proj\.(weight|bias)$", r".in_proj_\1", name)


def _hwc_input(module: nn.Module, name: str):
    """``(h, w)`` of the map that the Linear owning ``name`` flattens,
    where the JAX model flattens it HWC: its parent declares it in a
    ``jax_hwc_inputs`` dict, child name -> ``(h, w)``."""
    path = name.rsplit(".", 1)[0]
    parent, _, child = path.rpartition(".")
    owner = module.get_submodule(parent) if parent else module
    return getattr(owner, "jax_hwc_inputs", {}).get(child)


# 2-D parameters that are tables, not Dense kernels: their layout is the
# same in both libraries
_TABLES = ("relative_position_bias_table", "rel_pos_h", "rel_pos_w",
           "rel_pos_t", "spatial_pos", "temporal_pos")


def _to_torch_layout(name: str, arr: np.ndarray, target: torch.Tensor,
                     module: nn.Module) -> np.ndarray:
    if arr.ndim == 4 and isinstance(
            module.get_submodule(name.rsplit(".", 1)[0]), nn.ConvTranspose2d):
        arr = arr.transpose(2, 3, 0, 1)[:, :, ::-1, ::-1]  # -> (in, out, kh, kw)
    elif arr.ndim == 4 and target.ndim == 5 and arr.shape[:2] == (1, 1):
        # S3D's classifier: a 2-D 1x1 kernel in JAX, a 1x1x1 Conv3d here
        arr = arr.transpose(3, 2, 0, 1)[:, :, None]
    elif arr.ndim == 4:  # HWIO -> OIHW
        arr = arr.transpose(3, 2, 0, 1)
    elif arr.ndim == 5:  # DHWIO -> OIDHW
        arr = arr.transpose(4, 3, 0, 1, 2)
    elif arr.ndim == 2 and not name.endswith(_TABLES):
        hw = _hwc_input(module, name)
        if hw is None:
            arr = arr.T  # IO -> OI
        else:  # IO over the JAX HWC flatten -> OI over torch's CHW flatten
            (ph, pw), (flat, out) = hw, arr.shape
            arr = arr.reshape(ph, pw, flat // (ph * pw), out)
            arr = arr.transpose(3, 2, 0, 1).reshape(out, flat)
    elif arr.ndim == 1 and target.ndim == 3 and name.endswith("layer_scale"):
        arr = arr.reshape(target.shape)  # ConvNeXt's (dim,) -> (dim, 1, 1)
    if tuple(arr.shape) != tuple(target.shape):
        raise ValueError(f"{name}: JAX shape {arr.shape} vs torch "
                         f"{tuple(target.shape)}")
    return arr


def jax_placements(module: nn.Module, variables: Mapping[str, Any]
                   ) -> Dict[str, np.ndarray]:
    """Every leaf of ``variables`` (``{"params": ..., "batch_stats": ...,
    "frozen": ...}`` as nested dicts of arrays) under the name of its
    parameter or buffer in ``module``, in that tensor's layout and shape.
    Raises unless every leaf has a target of its shape and every tensor of
    the module a source (``num_batches_tracked`` counters have none in JAX
    and are left out). Only shapes are read from ``module``: it may lie
    on the meta device."""
    targets = dict(module.named_parameters())
    targets.update(module.named_buffers())
    renames = {f"{prefix}." if prefix else "": m.jax_names
               for prefix, m in module.named_modules()
               if isinstance(getattr(m, "jax_names", None), dict)}
    placed: Dict[str, np.ndarray] = {}
    for collection, tree in variables.items():
        for path, value in _leaves(tree):
            name = _torch_name(collection, path)
            for prefix, names in renames.items():
                head, _, rest = name[len(prefix):].partition(".")
                if name.startswith(prefix) and head in names:
                    name = f"{prefix}{names[head]}.{rest}"
                    break
            if name not in targets:
                raise KeyError(f"{collection}/{'/'.join(path)} -> {name}: no "
                               "such parameter or buffer")
            placed[name] = _to_torch_layout(name, np.asarray(value),
                                            targets[name], module)
    missing = sorted(n for n in set(targets) - set(placed)
                     if not n.endswith("num_batches_tracked"))
    if missing:
        raise KeyError(f"not in the JAX variables ({len(missing)}): {missing[:10]}")
    return placed


@torch.no_grad()
def load_jax_variables(module: nn.Module, variables: Mapping[str, Any]) -> None:
    """Copy every leaf of ``variables`` into ``module``'s parameters and
    buffers, as ``jax_placements`` places them (and raises as it does)."""
    targets = dict(module.named_parameters())
    targets.update(module.named_buffers())
    for name, arr in jax_placements(module, variables).items():
        targets[name].copy_(torch.as_tensor(np.array(arr)))
