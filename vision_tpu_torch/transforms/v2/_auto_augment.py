"""RandAugment (counterpart of ``vision_tpu/transforms/v2/_auto_augment.py``,
its ``RandAugment`` and ``batched`` form; the policy tables of AutoAugment,
TrivialAugmentWide and AugMix are not ported)."""

from __future__ import annotations

import functools
from typing import Any, Dict, Tuple

import numpy as np
import torch

from vision_tpu_torch.transforms.v2._batch_augment import apply_ops_batched
from vision_tpu_torch.transforms.v2._transform import Shape, Transform, rand

__all__ = ["RandAugment"]


@functools.lru_cache(maxsize=32)
def _table(values: Tuple[float, ...], device: torch.device) -> torch.Tensor:
    """``values`` as a float64 tensor on ``device``, made once: a copy from
    the host at every call would wait for the card."""
    with torch.inference_mode(False):
        return torch.tensor(values, dtype=torch.float64).to(device)


class RandAugment(Transform):
    """``num_ops`` ops an image, each uniform over the 14 of
    ``_augmentation_space`` (Identity first), at bin ``magnitude`` of
    ``num_magnitude_bins``, negated with probability one half where the op
    is signed (Cubuk et al. 2019; torchvision's ``RandAugment``).

    ``draw`` gives ``op`` (``[N, num_ops]`` int64, an index into the
    space's names) and ``sign`` (``[N, num_ops]``, -1 or 1, drawn for every
    op as the JAX package draws it); ``transform`` runs the ops in turn
    through ``apply_ops_batched`` on a uint8 batch."""

    def __init__(self, num_ops: int = 2, magnitude: int = 9,
                 num_magnitude_bins: int = 31, interpolation: str = "nearest",
                 fill=None):
        self.num_ops = num_ops
        self.magnitude = magnitude
        self.num_magnitude_bins = num_magnitude_bins
        self.interpolation = interpolation
        self.fill = fill

    def _augmentation_space(self, num_bins: int, image_size):
        h, w = image_size
        return {
            "Identity": (np.array(0.0), False),
            "ShearX": (np.linspace(0.0, 0.3, num_bins), True),
            "ShearY": (np.linspace(0.0, 0.3, num_bins), True),
            "TranslateX": (np.linspace(0.0, 150.0 / 331.0 * w, num_bins), True),
            "TranslateY": (np.linspace(0.0, 150.0 / 331.0 * h, num_bins), True),
            "Rotate": (np.linspace(0.0, 30.0, num_bins), True),
            "Brightness": (np.linspace(0.0, 0.9, num_bins), True),
            "Color": (np.linspace(0.0, 0.9, num_bins), True),
            "Contrast": (np.linspace(0.0, 0.9, num_bins), True),
            "Sharpness": (np.linspace(0.0, 0.9, num_bins), True),
            "Posterize": (
                8 - (np.arange(num_bins) / ((num_bins - 1) / 4)).round(),
                False,
            ),
            "Solarize": (np.linspace(255.0, 0.0, num_bins), False),
            "AutoContrast": (np.array(0.0), False),
            "Equalize": (np.array(0.0), False),
        }

    def magnitudes(self, image_size) -> Dict[str, Tuple[float, bool]]:
        """Each op's unsigned magnitude at ``self.magnitude`` and whether it
        is signed, for images of ``image_size``."""
        space = self._augmentation_space(self.num_magnitude_bins, image_size)
        return {name: (float(tab[self.magnitude]) if tab.ndim > 0 else 0.0,
                       signed)
                for name, (tab, signed) in space.items()}

    def draw(self, shape: Shape, generator: torch.Generator) -> Dict[str, Any]:
        n, k = shape[0], len(self.magnitudes(shape[-2:]))
        op = torch.randint(0, k, (n, self.num_ops), generator=generator,
                           device=generator.device)
        sign = torch.where(rand((n, self.num_ops), generator) > 0.5, -1.0, 1.0)
        return {"op": op, "sign": sign}

    def transform(self, images, params):
        table = self.magnitudes(tuple(images.shape[-2:]))
        names = list(table)
        values = _table(tuple(v for v, _ in table.values()), images.device)
        signed = _table(tuple(float(s) for _, s in table.values()), images.device)
        op = params["op"].to(images.device)
        sign = params["sign"].to(images.device, torch.float64)
        for s in range(self.num_ops):
            mag = values[op[:, s]] * torch.where(signed[op[:, s]] > 0,
                                                 sign[:, s], 1.0)
            images = apply_ops_batched(images, op[:, s], mag, names,
                                       self.interpolation, self.fill)
        return images

    def batched(self, images: torch.Tensor, generator: torch.Generator):
        """The JAX package's ``batched``: the whole uint8 batch."""
        return self(images, generator)

    def __repr__(self) -> str:
        return (f"RandAugment(num_ops={self.num_ops}, magnitude="
                f"{self.magnitude}, interpolation={self.interpolation!r})")
