"""The engine behind ``RandAugment.batched`` (counterpart of
``vision_tpu/transforms/v2/_batch_augment.py``): each image of a uint8
batch gets its own op at its own magnitude, with no host synchronisation.

The JAX engine is built around the TPU, where a gather is a scalar load: a
barrel shifter of static slices for the shears and translations, a
three-shear approximation of Rotate (within one source pixel), and colour
branches run on static-capacity buckets of the samples that drew them. On
the card a gather is cheap, so this engine computes what the JAX package's
per-sample functionals compute, on the same draws:

* the five geometric ops are one warp of the whole batch, each image by its
  own inverse affine matrix (``functional.affine_grid_sample``; the
  identity for an image whose op is not geometric, whose warp is then
  discarded), exactly as ``F.affine`` / ``F.rotate`` sample: Rotate is
  exact, not a three-shear;
* each colour op runs on the whole batch and is selected where it was
  drawn: the batch is computed 9 times over, which the card does in less
  time than the host would take to gather the samples that drew each op
  without waiting for the draws. The factors are formed in float64 as the
  per-sample functional's Python floats are.

The JAX engine's ``max_shift_bound`` (the barrel's static reach) has no
counterpart: nothing here is bounded by it.
"""

from __future__ import annotations

from typing import Sequence

import torch

from vision_tpu_torch.transforms.v2.functional import _color as C
from vision_tpu_torch.transforms.v2.functional._geometry import (
    _RAD,
    affine_grid_sample,
    inverse_affine_matrix,
)

__all__ = ["apply_ops_batched"]

_GEOMETRIC = ("ShearX", "ShearY", "TranslateX", "TranslateY", "Rotate")


def apply_ops_batched(
    images: torch.Tensor,
    op_idx: torch.Tensor,
    magnitude: torch.Tensor,
    names: Sequence[str],
    interpolation: str = "nearest",
    fill=None,
) -> torch.Tensor:
    """Apply to each image of ``images`` (``[N, C, H, W]`` uint8) the op
    ``names[op_idx[n]]`` at the signed magnitude ``magnitude[n]`` (float64,
    ``[N]``; Posterize's bits as a float of an int). An op name outside the
    geometric and colour ops below raises."""
    if images.dtype != torch.uint8:
        raise NotImplementedError(
            "batched auto-augment runs on uint8 images (before ToDtype)")
    unknown = set(names) - set(_GEOMETRIC) - set(_COLOUR) - {"Identity"}
    if unknown:
        raise ValueError(f"no batched form of {sorted(unknown)}")
    h, w = images.shape[-2:]
    op_idx = op_idx.to(images.device)
    mag = magnitude.to(images.device, torch.float64)
    drew = {name: op_idx == k for k, name in enumerate(names)}
    none = torch.zeros_like(op_idx, dtype=torch.bool)

    def where(name, value):
        return torch.where(drew.get(name, none), value, 0.0)

    out = images
    if any(name in drew for name in _GEOMETRIC):
        shear = drew.get("ShearX", none) | drew.get("ShearY", none)
        matrix = inverse_affine_matrix(
            torch.where(shear, -w * 0.5, 0.0), torch.where(shear, -h * 0.5, 0.0),
            where("Rotate", -mag),
            where("TranslateX", torch.trunc(mag)),
            where("TranslateY", torch.trunc(mag)), 1.0,
            where("ShearX", torch.atan(mag) / _RAD),
            where("ShearY", torch.atan(mag) / _RAD))
        warped = affine_grid_sample(images, matrix, interpolation, fill)
        geometric = torch.zeros_like(none)
        for name in _GEOMETRIC:
            geometric = geometric | drew.get(name, none)
        out = torch.where(geometric.view(-1, 1, 1, 1), warped, out)
    for name, op in _COLOUR.items():
        if name in drew:
            out = torch.where(drew[name].view(-1, 1, 1, 1), op(images, mag), out)
    return out


_COLOUR = {
    "Brightness": lambda x, m: C.adjust_brightness(x, 1.0 + m),
    "Color": lambda x, m: C.adjust_saturation(x, 1.0 + m),
    "Contrast": lambda x, m: C.adjust_contrast(x, 1.0 + m),
    "Sharpness": lambda x, m: C.adjust_sharpness(x, 1.0 + m),
    "Posterize": lambda x, m: C.posterize(x, m),
    "Solarize": lambda x, m: C.solarize(x, m),
    "AutoContrast": lambda x, m: C.autocontrast(x),
    "Equalize": lambda x, m: C.equalize(x),
}
