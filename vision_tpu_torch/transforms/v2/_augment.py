"""Augmentation transforms (counterpart of
``vision_tpu/transforms/v2/_augment.py``): ``RandomErasing`` and the batch
mixes ``MixUp`` and ``CutMix``, with the JAX package's traced draws; and
``JPEG``, a sample transform."""

from __future__ import annotations

import math
from typing import Any, Dict, Optional

import torch
import torch.nn.functional as F

from vision_tpu_torch import tv_tensors
from vision_tpu_torch.transforms.v2._transform import (
    Shape,
    Transform,
    _RandomApplyTransform,
    rand,
    randint,
    uniform,
)
from vision_tpu_torch.transforms.v2._utils import query_size
from vision_tpu_torch.transforms.v2.functional._augment import erase, jpeg

__all__ = ["CutMix", "JPEG", "MixUp", "RandomErasing"]

_CANDIDATES = 10


class RandomErasing(_RandomApplyTransform):
    """Erase a box of random area (a share in ``scale``) and aspect
    (log-uniform in ``ratio``) in each picked image, filled with ``value``.
    The draw is the JAX package's traced one: ten candidates, the first
    that fits strictly inside the image, else nothing is erased."""

    def __init__(self, p: float = 0.5, scale=(0.02, 0.33), ratio=(0.3, 3.3),
                 value: float = 0.0):
        super().__init__(p)
        if scale[0] > scale[1] or ratio[0] > ratio[1]:
            raise ValueError("scale/ratio must be ordered ranges")
        self.scale = tuple(scale)
        self.ratio = tuple(ratio)
        self.value = value

    def draw_params(self, shape: Shape, generator: torch.Generator) -> Dict[str, Any]:
        n, img_h, img_w = shape[0], shape[-2], shape[-1]
        log_lo, log_hi = math.log(self.ratio[0]), math.log(self.ratio[1])
        u = self.scale[0] + rand((n, _CANDIDATES), generator) * (
            self.scale[1] - self.scale[0])
        aspect = torch.exp(log_lo + rand((n, _CANDIDATES), generator)
                           * (log_hi - log_lo))
        area = img_h * img_w
        hs = torch.round(torch.sqrt(area * u * aspect))
        ws = torch.round(torch.sqrt(area * u / aspect))
        valid = (hs < img_h) & (ws < img_w)
        first = valid.int().argmax(1, keepdim=True)
        any_valid = valid.any(1)
        h = torch.where(any_valid, hs.gather(1, first)[:, 0], 0.0)
        w = torch.where(any_valid, ws.gather(1, first)[:, 0], 0.0)
        return {"i": torch.floor(rand((n,), generator) * (img_h - h + 1.0)),
                "j": torch.floor(rand((n,), generator) * (img_w - w + 1.0)),
                "h": h, "w": w}

    def transform_all(self, images, params):
        return erase(images, params["i"], params["j"], params["h"],
                     params["w"], self.value)

    _transformed_types = (tv_tensors.Image, tv_tensors.Video, torch.Tensor)

    def make_params(self, flat_inputs, generator):
        """A sample's box: the JAX package's eager draw, ten attempts, the
        first strictly inside the image; ``v`` the fill (``value`` None:
        standard normal noise ``[C, h, w]``), or no box (``h`` 0)."""
        img_h, img_w = query_size(flat_inputs)
        channels = next((x.shape[-3] for x in flat_inputs
                         if isinstance(x, torch.Tensor) and x.ndim >= 3
                         and not isinstance(x, (tv_tensors.Mask,
                                                tv_tensors.BoundingBoxes,
                                                tv_tensors.KeyPoints))), 3)
        log_ratio = (math.log(self.ratio[0]), math.log(self.ratio[1]))
        for _ in range(_CANDIDATES):
            erase_area = img_h * img_w * uniform(generator, *self.scale)
            aspect = math.exp(uniform(generator, *log_ratio))
            h = int(round(math.sqrt(erase_area * aspect)))
            w = int(round(math.sqrt(erase_area / aspect)))
            if not (h < img_h and w < img_w):
                continue
            if self.value is None:
                v = torch.randn((channels, h, w), generator=generator)
            elif isinstance(self.value, (list, tuple)):
                v = torch.tensor(self.value, dtype=torch.float32)[:, None, None]
            else:
                v = float(self.value)
            return dict(i=randint(generator, 0, img_h - h + 1),
                        j=randint(generator, 0, img_w - w + 1), h=h, w=w, v=v)
        return dict(i=0, j=0, h=0, w=0, v=None)

    def transform_sample(self, inpt, params):
        if params["v"] is None or params["h"] == 0:
            return inpt
        i, j, h, w = (params[k] for k in "ijhw")
        out = inpt.as_subclass(torch.Tensor).clone()
        v = params["v"]
        out[..., i:i + h, j:j + w] = (v.to(out.device, out.dtype)
                                      if isinstance(v, torch.Tensor) else v)
        if isinstance(inpt, tv_tensors.TVTensor):
            return tv_tensors.wrap(out, like=inpt)
        return out

    def __repr__(self) -> str:
        return f"RandomErasing(p={self.p}, value={self.value})"


def _beta(alpha: float, generator: torch.Generator) -> torch.Tensor:
    """One Beta(alpha, alpha) draw (f32, 0-d): ``x / (x + y)`` of two
    Gamma(alpha) draws, taken in float64 so that neither underflows."""
    conc = torch.full((2,), alpha, dtype=torch.float64, device=generator.device)
    x = torch._standard_gamma(conc, generator=generator)
    return (x[0] / (x[0] + x[1])).float()


class _BaseMixUpCutMix(Transform):
    """A mix of each image of ``(images, labels)`` with the one before it
    (the batch rolled by one). Integer labels become one-hot rows of
    ``num_classes``; the labels come back soft, weighted by
    ``lam_adjusted``."""

    def __init__(self, alpha: float = 1.0, num_classes: Optional[int] = None):
        self.alpha = float(alpha)
        self.num_classes = num_classes

    def apply(self, inputs, params):
        images, labels = inputs
        if labels.dim() == 1:
            if self.num_classes is None:
                raise ValueError("num_classes required for integer labels")
            labels = F.one_hot(labels.long(), self.num_classes)
        labels = labels.float()
        lam = params["lam_adjusted"].to(labels.device)
        mixed = labels * lam + labels.roll(1, 0) * (1.0 - lam)
        return self.mix_images(images, params), mixed

    def mix_images(self, images: torch.Tensor, params) -> torch.Tensor:
        raise NotImplementedError

    def __repr__(self) -> str:
        return f"{type(self).__name__}(alpha={self.alpha})"


class MixUp(_BaseMixUpCutMix):
    """``lam * x + (1 - lam) * roll(x)``, ``lam`` from Beta(alpha, alpha)."""

    def draw(self, shape: Shape, generator: torch.Generator) -> Dict[str, Any]:
        lam = _beta(self.alpha, generator)
        return {"lam": lam, "lam_adjusted": lam}

    def mix_images(self, images, params):
        lam = params["lam"].to(images.device)
        x = images.float()
        return (x * lam + x.roll(1, 0) * (1.0 - lam)).to(images.dtype)


class CutMix(_BaseMixUpCutMix):
    """Paste a box of the rolled batch into each image: its centre uniform
    over the pixels, its half sides ``floor(0.5 * sqrt(1 - lam) * side)``
    (``lam`` from Beta(alpha, alpha)), clipped to the image; the labels'
    weight is one less the box's area share."""

    def draw(self, shape: Shape, generator: torch.Generator) -> Dict[str, Any]:
        h, w = shape[-2], shape[-1]
        lam = _beta(self.alpha, generator)
        dev = generator.device
        r_x = torch.randint(0, w, (), generator=generator, device=dev)
        r_y = torch.randint(0, h, (), generator=generator, device=dev)
        r = 0.5 * torch.sqrt(1.0 - lam)
        r_w_half = torch.floor(r * w).long()
        r_h_half = torch.floor(r * h).long()
        x1 = (r_x - r_w_half).clamp(min=0)
        y1 = (r_y - r_h_half).clamp(min=0)
        x2 = (r_x + r_w_half).clamp(max=w)
        y2 = (r_y + r_h_half).clamp(max=h)
        lam_adjusted = 1.0 - (x2 - x1) * (y2 - y1) / (w * h)
        return {"box": torch.stack([x1, y1, x2, y2]), "lam_adjusted": lam_adjusted}

    def mix_images(self, images, params):
        x1, y1, x2, y2 = params["box"].to(images.device)
        ys = torch.arange(images.shape[-2], device=images.device)
        xs = torch.arange(images.shape[-1], device=images.device)
        inside = (((ys >= y1) & (ys < y2))[:, None]
                  & ((xs >= x1) & (xs < x2))[None, :])
        return torch.where(inside, images.roll(1, 0), images)


class JPEG(Transform):
    """The JPEG round trip (``functional.jpeg``) at a quality uniform over
    the integers of ``quality`` (one number: that quality), through the
    port's host codec: one host synchronisation a call for an image on
    the card."""

    _transformed_types = (tv_tensors.Image, tv_tensors.Video, torch.Tensor)

    def __init__(self, quality):
        if isinstance(quality, int):
            quality = [quality, quality]
        if not 1 <= quality[0] <= quality[1] <= 100:
            raise ValueError(f"quality must be in [1, 100], got {quality}")
        self.quality = list(quality)

    def make_params(self, flat_inputs, generator):
        return dict(quality=randint(generator, self.quality[0],
                                    self.quality[1] + 1))

    def transform_sample(self, inpt, params):
        return jpeg(inpt, params["quality"])
