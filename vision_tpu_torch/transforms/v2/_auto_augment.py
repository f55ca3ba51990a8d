"""The auto-augment policies (counterpart of
``vision_tpu/transforms/v2/_auto_augment.py``): ``RandAugment`` for
batches (its ``batched`` form) and samples, and ``AutoAugment`` (its three
policies, l.113-275), ``TrivialAugmentWide`` (l.422) and ``AugMix`` (l.542)
for samples. The policy tables are the published ones (Cubuk et al. 2018
and 2019; Muller and Hutter 2021; Hendrycks et al. 2020).

A sample's params name the ops it takes: ``{"ops": [(name, signed
magnitude), ...]}`` (AugMix: ``{"mix_weight", "weights", "chains"}``), so
that the JAX package's draws can be handed across as the ops it applied.
The ops run on the sample's images and videos through the per-sample
functionals, as the JAX package's ``_apply_op`` does."""

from __future__ import annotations

import enum
import functools
import math
from typing import Any, Dict, Tuple

import numpy as np
import torch

from vision_tpu_torch import tv_tensors
from vision_tpu_torch.transforms.v2 import functional as F
from vision_tpu_torch.transforms.v2._batch_augment import apply_ops_batched
from vision_tpu_torch.transforms.v2._transform import (
    Shape,
    Transform,
    rand,
    randint,
    uniform,
)
from vision_tpu_torch.transforms.v2._utils import query_size
from vision_tpu_torch.transforms.v2.functional._geometry import (
    affine_image,
    rotate_image,
)

__all__ = ["AugMix", "AutoAugment", "AutoAugmentPolicy", "RandAugment",
           "TrivialAugmentWide"]

_IMAGE_TYPES = (tv_tensors.Image, tv_tensors.Video, torch.Tensor)


class AutoAugmentPolicy(str, enum.Enum):
    IMAGENET = "imagenet"
    CIFAR10 = "cifar10"
    SVHN = "svhn"


def apply_op(img: torch.Tensor, op_name: str, magnitude: float,
             interpolation: str = "nearest", fill=None) -> torch.Tensor:
    """One op of the policies on ``[..., C, H, W]`` at a signed
    ``magnitude`` (the JAX package's ``_apply_op``)."""
    if op_name in ("ShearX", "ShearY"):
        shear = math.degrees(math.atan(magnitude))
        return affine_image(img, 0.0, [0, 0], 1.0,
                            [shear, 0.0] if op_name == "ShearX" else [0.0, shear],
                            interpolation, fill, center=[0, 0])
    if op_name == "TranslateX":
        return affine_image(img, 0.0, [int(magnitude), 0], 1.0, [0.0, 0.0],
                            interpolation, fill)
    if op_name == "TranslateY":
        return affine_image(img, 0.0, [0, int(magnitude)], 1.0, [0.0, 0.0],
                            interpolation, fill)
    if op_name == "Rotate":
        return rotate_image(img, magnitude, interpolation, fill=fill)
    if op_name == "Brightness":
        return F.adjust_brightness(img, 1.0 + magnitude)
    if op_name == "Color":
        return F.adjust_saturation(img, 1.0 + magnitude)
    if op_name == "Contrast":
        return F.adjust_contrast(img, 1.0 + magnitude)
    if op_name == "Sharpness":
        return F.adjust_sharpness(img, 1.0 + magnitude)
    if op_name == "Posterize":
        return F.posterize(img, int(magnitude))
    if op_name == "Solarize":
        return F.solarize(img, magnitude if not img.dtype.is_floating_point
                          else magnitude / 255.0)
    if op_name == "AutoContrast":
        return F.autocontrast(img)
    if op_name == "Equalize":
        return F.equalize(img)
    if op_name == "Invert":
        return F.invert(img)
    if op_name == "Identity":
        return img
    raise ValueError(f"unknown op {op_name}")


class _AutoAugmentBase(Transform):
    """A sample's images and videos through ``params["ops"]`` in turn."""

    _transformed_types = _IMAGE_TYPES

    def __init__(self, interpolation: str = "nearest", fill=None):
        self.interpolation = interpolation
        self.fill = fill

    def _ops(self, img: torch.Tensor, ops) -> torch.Tensor:
        for name, magnitude in ops:
            img = apply_op(img, name, magnitude, self.interpolation, self.fill)
        return img

    def _plain(self, inpt, fn):
        if isinstance(inpt, tv_tensors.TVTensor):
            return tv_tensors.wrap(fn(inpt.as_tensor()), like=inpt)
        return fn(inpt)

    def transform_sample(self, inpt, params):
        return self._plain(inpt, lambda x: self._ops(x, params["ops"]))


@functools.lru_cache(maxsize=32)
def _table(values: Tuple[float, ...], device: torch.device) -> torch.Tensor:
    """``values`` as a float64 tensor on ``device``, made once: a copy from
    the host at every call would wait for the card."""
    with torch.inference_mode(False):
        return torch.tensor(values, dtype=torch.float64).to(device)


class RandAugment(_AutoAugmentBase):
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

    def make_params(self, flat_inputs, generator):
        """``num_ops`` ops, each uniform over the space, negated where
        signed with probability one half (a sign drawn for every op)."""
        table = self.magnitudes(query_size(flat_inputs))
        names, ops = list(table), []
        for _ in range(self.num_ops):
            name = names[randint(generator, 0, len(names))]
            magnitude, signed = table[name]
            if uniform(generator) > 0.5 and signed:
                magnitude = -magnitude
            ops.append((name, magnitude))
        return {"ops": ops}

    def __repr__(self) -> str:
        return (f"RandAugment(num_ops={self.num_ops}, magnitude="
                f"{self.magnitude}, interpolation={self.interpolation!r})")


def _imagenet_policy():
    return [
        (("Posterize", 0.4, 8), ("Rotate", 0.6, 9)),
        (("Solarize", 0.6, 5), ("AutoContrast", 0.6, None)),
        (("Equalize", 0.8, None), ("Equalize", 0.6, None)),
        (("Posterize", 0.6, 7), ("Posterize", 0.6, 6)),
        (("Equalize", 0.4, None), ("Solarize", 0.2, 4)),
        (("Equalize", 0.4, None), ("Rotate", 0.8, 8)),
        (("Solarize", 0.6, 3), ("Equalize", 0.6, None)),
        (("Posterize", 0.8, 5), ("Equalize", 1.0, None)),
        (("Rotate", 0.2, 3), ("Solarize", 0.6, 8)),
        (("Equalize", 0.6, None), ("Posterize", 0.4, 6)),
        (("Rotate", 0.8, 8), ("Color", 0.4, 0)),
        (("Rotate", 0.4, 9), ("Equalize", 0.6, None)),
        (("Equalize", 0.0, None), ("Equalize", 0.8, None)),
        (("Invert", 0.6, None), ("Equalize", 1.0, None)),
        (("Color", 0.6, 4), ("Contrast", 1.0, 8)),
        (("Rotate", 0.8, 8), ("Color", 1.0, 2)),
        (("Color", 0.8, 8), ("Solarize", 0.8, 7)),
        (("Sharpness", 0.4, 7), ("Invert", 0.6, None)),
        (("ShearX", 0.6, 5), ("Equalize", 1.0, None)),
        (("Color", 0.4, 0), ("Equalize", 0.6, None)),
        (("Equalize", 0.4, None), ("Solarize", 0.2, 4)),
        (("Solarize", 0.6, 5), ("AutoContrast", 0.6, None)),
        (("Invert", 0.6, None), ("Equalize", 1.0, None)),
        (("Color", 0.6, 4), ("Contrast", 1.0, 8)),
        (("Equalize", 0.8, None), ("Equalize", 0.6, None)),
    ]


def _cifar10_policy():
    return [
        (("Invert", 0.1, None), ("Contrast", 0.2, 6)),
        (("Rotate", 0.7, 2), ("TranslateX", 0.3, 9)),
        (("Sharpness", 0.8, 1), ("Sharpness", 0.9, 3)),
        (("ShearY", 0.5, 8), ("TranslateY", 0.7, 9)),
        (("AutoContrast", 0.5, None), ("Equalize", 0.9, None)),
        (("ShearY", 0.2, 7), ("Posterize", 0.3, 7)),
        (("Color", 0.4, 3), ("Brightness", 0.6, 7)),
        (("Sharpness", 0.3, 9), ("Brightness", 0.7, 9)),
        (("Equalize", 0.6, None), ("Equalize", 0.5, None)),
        (("Contrast", 0.6, 7), ("Sharpness", 0.6, 5)),
        (("Color", 0.7, 7), ("TranslateX", 0.5, 8)),
        (("Equalize", 0.3, None), ("AutoContrast", 0.4, None)),
        (("TranslateY", 0.4, 3), ("Sharpness", 0.2, 6)),
        (("Brightness", 0.9, 6), ("Color", 0.2, 8)),
        (("Solarize", 0.5, 2), ("Invert", 0.0, None)),
        (("Equalize", 0.2, None), ("AutoContrast", 0.6, None)),
        (("Equalize", 0.2, None), ("Equalize", 0.6, None)),
        (("Color", 0.9, 9), ("Equalize", 0.6, None)),
        (("AutoContrast", 0.8, None), ("Solarize", 0.2, 8)),
        (("Brightness", 0.1, 3), ("Color", 0.7, 0)),
        (("Solarize", 0.4, 5), ("AutoContrast", 0.9, None)),
        (("TranslateY", 0.9, 9), ("TranslateY", 0.7, 9)),
        (("AutoContrast", 0.9, None), ("Solarize", 0.8, 3)),
        (("Equalize", 0.8, None), ("Invert", 0.1, None)),
        (("TranslateY", 0.7, 9), ("AutoContrast", 0.9, None)),
    ]


def _svhn_policy():
    return [
        (("ShearX", 0.9, 4), ("Invert", 0.2, None)),
        (("ShearY", 0.9, 8), ("Invert", 0.7, None)),
        (("Equalize", 0.6, None), ("Solarize", 0.6, 6)),
        (("Invert", 0.9, None), ("Equalize", 0.6, None)),
        (("Equalize", 0.6, None), ("Rotate", 0.9, 3)),
        (("ShearX", 0.9, 4), ("AutoContrast", 0.8, None)),
        (("ShearY", 0.9, 8), ("Invert", 0.4, None)),
        (("ShearY", 0.9, 5), ("Solarize", 0.2, 6)),
        (("Invert", 0.9, None), ("AutoContrast", 0.8, None)),
        (("Equalize", 0.6, None), ("Rotate", 0.9, 3)),
        (("ShearX", 0.9, 4), ("Solarize", 0.3, 3)),
        (("ShearY", 0.8, 8), ("Invert", 0.7, None)),
        (("Equalize", 0.9, None), ("TranslateY", 0.6, 6)),
        (("ShearX", 0.9, 4), ("AutoContrast", 0.8, None)),
        (("ShearY", 0.8, 8), ("Solarize", 0.7, 2)),
        (("Invert", 0.7, None), ("TranslateY", 0.6, 6)),
        (("ShearY", 0.6, 7), ("Solarize", 0.4, 8)),
        (("Invert", 0.8, None), ("TranslateY", 0.0, 2)),
        (("ShearY", 0.7, 6), ("Solarize", 0.4, 8)),
        (("Invert", 0.6, None), ("Rotate", 0.8, 4)),
        (("ShearY", 0.3, 7), ("TranslateX", 0.9, 3)),
        (("ShearX", 0.1, 6), ("Invert", 0.6, None)),
        (("Solarize", 0.7, 2), ("TranslateY", 0.6, 7)),
        (("ShearY", 0.8, 4), ("Invert", 0.8, None)),
        (("ShearX", 0.7, 9), ("TranslateY", 0.8, 3)),
    ]


_POLICIES = {"imagenet": _imagenet_policy, "cifar10": _cifar10_policy,
             "svhn": _svhn_policy}


class AutoAugment(_AutoAugmentBase):
    """One of the policy's 25 sub-policies (uniform), each of its two ops
    applied with its probability at its magnitude bin of 10, negated with
    probability one half where signed."""

    def __init__(self, policy: str = "imagenet", interpolation: str = "nearest",
                 fill=None):
        super().__init__(interpolation, fill)
        self.policy = AutoAugmentPolicy(policy).value
        self._policies = _POLICIES[self.policy]()

    @staticmethod
    def _augmentation_space(num_bins: int, image_size):
        h, w = image_size
        return {
            "ShearX": (np.linspace(0.0, 0.3, num_bins), True),
            "ShearY": (np.linspace(0.0, 0.3, num_bins), True),
            "TranslateX": (np.linspace(0.0, 150.0 / 331.0 * w, num_bins), True),
            "TranslateY": (np.linspace(0.0, 150.0 / 331.0 * h, num_bins), True),
            "Rotate": (np.linspace(0.0, 30.0, num_bins), True),
            "Brightness": (np.linspace(0.0, 0.9, num_bins), True),
            "Color": (np.linspace(0.0, 0.9, num_bins), True),
            "Contrast": (np.linspace(0.0, 0.9, num_bins), True),
            "Sharpness": (np.linspace(0.0, 0.9, num_bins), True),
            "Posterize": (8 - (np.arange(num_bins) / ((num_bins - 1) / 4)).round(),
                          False),
            "Solarize": (np.linspace(255.0, 0.0, num_bins), False),
            "AutoContrast": (np.array(0.0), False),
            "Equalize": (np.array(0.0), False),
            "Invert": (np.array(0.0), False),
        }

    def make_params(self, flat_inputs, generator):
        space = self._augmentation_space(10, query_size(flat_inputs))
        policy = self._policies[randint(generator, 0, len(self._policies))]
        ops = []
        for name, p, bin_id in policy:
            u_apply, u_sign = uniform(generator), uniform(generator)
            if u_apply > p:
                continue
            magnitudes, signed = space[name]
            magnitude = (float(magnitudes[bin_id])
                         if bin_id is not None and magnitudes.ndim > 0 else 0.0)
            if signed and u_sign > 0.5:
                magnitude = -magnitude
            ops.append((name, magnitude))
        return {"ops": ops}

    def __repr__(self) -> str:
        return f"AutoAugment(policy={self.policy!r})"


class TrivialAugmentWide(_AutoAugmentBase):
    """One op, uniform over the wide space, at a uniform bin of
    ``num_magnitude_bins``, negated with probability one half where
    signed."""

    def __init__(self, num_magnitude_bins: int = 31,
                 interpolation: str = "nearest", fill=None):
        super().__init__(interpolation, fill)
        self.num_magnitude_bins = num_magnitude_bins

    @staticmethod
    def _augmentation_space(num_bins: int):
        return {
            "Identity": (np.array(0.0), False),
            "ShearX": (np.linspace(0.0, 0.99, num_bins), True),
            "ShearY": (np.linspace(0.0, 0.99, num_bins), True),
            "TranslateX": (np.linspace(0.0, 32.0, num_bins), True),
            "TranslateY": (np.linspace(0.0, 32.0, num_bins), True),
            "Rotate": (np.linspace(0.0, 135.0, num_bins), True),
            "Brightness": (np.linspace(0.0, 0.99, num_bins), True),
            "Color": (np.linspace(0.0, 0.99, num_bins), True),
            "Contrast": (np.linspace(0.0, 0.99, num_bins), True),
            "Sharpness": (np.linspace(0.0, 0.99, num_bins), True),
            "Posterize": (8 - (np.arange(num_bins) / ((num_bins - 1) / 6)).round(),
                          False),
            "Solarize": (np.linspace(255.0, 0.0, num_bins), False),
            "AutoContrast": (np.array(0.0), False),
            "Equalize": (np.array(0.0), False),
        }

    def make_params(self, flat_inputs, generator):
        space = self._augmentation_space(self.num_magnitude_bins)
        names = list(space)
        name = names[randint(generator, 0, len(names))]
        bin_id = randint(generator, 0, self.num_magnitude_bins)
        negate = uniform(generator) > 0.5
        magnitudes, signed = space[name]
        magnitude = (float(magnitudes[min(bin_id, len(magnitudes) - 1)])
                     if magnitudes.ndim > 0 else 0.0)
        return {"ops": [(name, -magnitude if signed and negate else magnitude)]}


def _gammas(alpha: float, n: int, generator) -> torch.Tensor:
    conc = torch.full((n,), float(alpha), dtype=torch.float64)
    return torch._standard_gamma(conc, generator=generator)


class AugMix(_AutoAugmentBase):
    """``mixture_width`` chains of 1-3 ops (or ``chain_depth``), each op
    uniform over the space at a uniform bin below ``severity``, mixed by
    Dirichlet(alpha) weights and blended with the image by a
    Beta(alpha, alpha) weight, in f32; an integer image is rounded back."""

    def __init__(self, severity: int = 3, mixture_width: int = 3,
                 chain_depth: int = -1, alpha: float = 1.0,
                 all_ops: bool = True, interpolation: str = "bilinear",
                 fill=None):
        super().__init__(interpolation, fill)
        if not 1 <= severity <= 10:
            raise ValueError(f"severity must be in [1, 10], got {severity}")
        self.severity = severity
        self.mixture_width = mixture_width
        self.chain_depth = chain_depth
        self.alpha = alpha
        self.all_ops = all_ops

    def _augmentation_space(self, num_bins: int, image_size):
        h, w = image_size
        s = {
            "ShearX": (np.linspace(0.0, 0.3, num_bins), True),
            "ShearY": (np.linspace(0.0, 0.3, num_bins), True),
            "TranslateX": (np.linspace(0.0, w / 3.0, num_bins), True),
            "TranslateY": (np.linspace(0.0, h / 3.0, num_bins), True),
            "Rotate": (np.linspace(0.0, 30.0, num_bins), True),
            "Posterize": (4 - (np.arange(num_bins) / ((num_bins - 1) / 4)).round(),
                          False),
            "Solarize": (np.linspace(255.0, 0.0, num_bins), False),
            "AutoContrast": (np.array(0.0), False),
            "Equalize": (np.array(0.0), False),
        }
        if self.all_ops:
            s.update({
                "Brightness": (np.linspace(0.0, 0.9, num_bins), True),
                "Color": (np.linspace(0.0, 0.9, num_bins), True),
                "Contrast": (np.linspace(0.0, 0.9, num_bins), True),
                "Sharpness": (np.linspace(0.0, 0.9, num_bins), True),
            })
        return s

    def make_params(self, flat_inputs, generator):
        space = self._augmentation_space(11, query_size(flat_inputs))
        names = list(space)
        beta = _gammas(self.alpha, 2, generator)
        mix_weight = float(beta[0] / beta.sum())
        g = _gammas(self.alpha, self.mixture_width, generator)
        weights = (g / g.sum()).float().tolist()
        chains = []
        for _ in range(self.mixture_width):
            depth = (self.chain_depth if self.chain_depth > 0
                     else randint(generator, 1, 4))
            chain = []
            for _ in range(depth):
                name = names[randint(generator, 0, len(names))]
                bin_id = randint(generator, 0, self.severity)
                negate = uniform(generator) > 0.5
                magnitudes, signed = space[name]
                magnitude = (float(magnitudes[bin_id]) if magnitudes.ndim > 0
                             else 0.0)
                chain.append((name, -magnitude if signed and negate
                              else magnitude))
            chains.append(chain)
        return {"mix_weight": mix_weight, "weights": weights, "chains": chains}

    def transform_sample(self, inpt, params):
        def mix(img):
            mw = params["mix_weight"]
            out = mw * img.float()
            for weight, chain in zip(params["weights"], params["chains"]):
                aug = self._ops(img, chain)
                out = out + ((1.0 - mw) * float(weight)) * aug.float()
            if not img.dtype.is_floating_point:
                out = torch.round(out).clamp(0, 255)
            return out.to(img.dtype)

        return self._plain(inpt, mix)
