"""Colour transforms (counterpart of ``vision_tpu/transforms/v2/_color.py``)
for samples (``_transform.py``): they change images and videos, and
nothing else of a sample. Their draws are the JAX package's eager ones;
``GaussianNoise`` draws a seed, and its normals on the image's device
from it."""

from __future__ import annotations

from typing import Tuple

import torch

from vision_tpu_torch import tv_tensors
from vision_tpu_torch.transforms.v2 import functional as F
from vision_tpu_torch.transforms.v2._transform import (
    Transform,
    _RandomApplyTransform,
    permutation,
    randint,
    uniform,
)

__all__ = [
    "ColorJitter",
    "GaussianBlur",
    "GaussianNoise",
    "Grayscale",
    "RGB",
    "RandomAdjustSharpness",
    "RandomAutocontrast",
    "RandomChannelPermutation",
    "RandomEqualize",
    "RandomGrayscale",
    "RandomInvert",
    "RandomPhotometricDistort",
    "RandomPosterize",
    "RandomSolarize",
]

_IMAGE_TYPES = (tv_tensors.Image, tv_tensors.Video, torch.Tensor)


def _num_channels(flat_inputs) -> int:
    for x in flat_inputs:
        if isinstance(x, (tv_tensors.Image, tv_tensors.Video)) or (
                isinstance(x, torch.Tensor)
                and not isinstance(x, tv_tensors.TVTensor) and x.ndim >= 3):
            return int(x.shape[-3])
    return 3


class Grayscale(Transform):
    _transformed_types = _IMAGE_TYPES

    def __init__(self, num_output_channels: int = 1):
        self.num_output_channels = num_output_channels

    def transform_sample(self, inpt, params):
        return F.rgb_to_grayscale(inpt, self.num_output_channels)


class RGB(Transform):
    _transformed_types = _IMAGE_TYPES

    def transform_sample(self, inpt, params):
        return F.grayscale_to_rgb(inpt)


class RandomGrayscale(_RandomApplyTransform):
    _transformed_types = _IMAGE_TYPES

    def __init__(self, p: float = 0.1):
        super().__init__(p)

    def transform_sample(self, inpt, params):
        return F.rgb_to_grayscale(inpt, F.get_num_channels(inpt))


class ColorJitter(Transform):
    """Brightness, contrast, saturation and hue factors, each uniform in its
    range, applied in a random order."""

    _transformed_types = _IMAGE_TYPES

    def __init__(self, brightness=None, contrast=None, saturation=None,
                 hue=None):
        self.brightness = self._check(brightness, "brightness")
        self.contrast = self._check(contrast, "contrast")
        self.saturation = self._check(saturation, "saturation")
        self.hue = self._check(hue, "hue", center=0.0, bound=(-0.5, 0.5))

    @staticmethod
    def _check(value, name, center=1.0, bound=(0.0, float("inf"))):
        if value is None:
            return None
        if isinstance(value, (int, float)):
            if value < 0:
                raise ValueError(f"{name} must be non-negative if scalar")
            value = (center - value, center + value)
            value = (max(value[0], bound[0]), min(value[1], bound[1]))
        else:
            value = tuple(float(v) for v in value)
        if value[0] == value[1] == center:
            return None
        return value

    def make_params(self, flat_inputs, generator):
        def draw(rng):
            return None if rng is None else uniform(generator, *rng)

        return dict(fn_idx=permutation(generator, 4),
                    brightness_factor=draw(self.brightness),
                    contrast_factor=draw(self.contrast),
                    saturation_factor=draw(self.saturation),
                    hue_factor=draw(self.hue))

    def transform_sample(self, inpt, params):
        ops = ((F.adjust_brightness, "brightness_factor"),
               (F.adjust_contrast, "contrast_factor"),
               (F.adjust_saturation, "saturation_factor"),
               (F.adjust_hue, "hue_factor"))
        out = inpt
        for fn_id in params["fn_idx"]:
            fn, key = ops[fn_id]
            if params[key] is not None:
                out = fn(out, params[key])
        return out


class RandomPhotometricDistort(Transform):
    """SSD's photometric distortion: each of brightness, contrast (before or
    after the rest, even odds), saturation, hue and a channel permutation
    with probability ``p``."""

    _transformed_types = _IMAGE_TYPES

    def __init__(self, brightness: Tuple[float, float] = (0.875, 1.125),
                 contrast: Tuple[float, float] = (0.5, 1.5),
                 saturation: Tuple[float, float] = (0.5, 1.5),
                 hue: Tuple[float, float] = (-0.05, 0.05), p: float = 0.5):
        self.brightness = brightness
        self.contrast = contrast
        self.saturation = saturation
        self.hue = hue
        self.p = p

    def make_params(self, flat_inputs, generator):
        def maybe(rng):
            factor = uniform(generator, *rng)
            return factor if uniform(generator) < self.p else None

        params = dict(brightness_factor=maybe(self.brightness),
                      contrast_factor=maybe(self.contrast),
                      contrast_before=uniform(generator) < 0.5,
                      saturation_factor=maybe(self.saturation),
                      hue_factor=maybe(self.hue))
        perm = permutation(generator, _num_channels(flat_inputs))
        params["channel_permutation"] = (perm if uniform(generator) < self.p
                                         else None)
        return params

    def transform_sample(self, inpt, params):
        out = inpt
        if params["brightness_factor"] is not None:
            out = F.adjust_brightness(out, params["brightness_factor"])
        if params["contrast_before"] and params["contrast_factor"] is not None:
            out = F.adjust_contrast(out, params["contrast_factor"])
        if params["saturation_factor"] is not None:
            out = F.adjust_saturation(out, params["saturation_factor"])
        if params["hue_factor"] is not None:
            out = F.adjust_hue(out, params["hue_factor"])
        if not params["contrast_before"] and params["contrast_factor"] is not None:
            out = F.adjust_contrast(out, params["contrast_factor"])
        if params["channel_permutation"] is not None:
            out = F.permute_channels(out, params["channel_permutation"])
        return out


class RandomEqualize(_RandomApplyTransform):
    _transformed_types = _IMAGE_TYPES

    def transform_sample(self, inpt, params):
        return F.equalize(inpt)


class RandomPosterize(_RandomApplyTransform):
    _transformed_types = _IMAGE_TYPES

    def __init__(self, bits: int, p: float = 0.5):
        super().__init__(p)
        self.bits = bits

    def transform_sample(self, inpt, params):
        return F.posterize(inpt, self.bits)


class RandomSolarize(_RandomApplyTransform):
    _transformed_types = _IMAGE_TYPES

    def __init__(self, threshold: float, p: float = 0.5):
        super().__init__(p)
        self.threshold = threshold

    def transform_sample(self, inpt, params):
        return F.solarize(inpt, self.threshold)


class RandomAutocontrast(_RandomApplyTransform):
    _transformed_types = _IMAGE_TYPES

    def transform_sample(self, inpt, params):
        return F.autocontrast(inpt)


class RandomAdjustSharpness(_RandomApplyTransform):
    _transformed_types = _IMAGE_TYPES

    def __init__(self, sharpness_factor: float, p: float = 0.5):
        super().__init__(p)
        if sharpness_factor < 0:
            raise ValueError("sharpness_factor must be >= 0")
        self.sharpness_factor = sharpness_factor

    def transform_sample(self, inpt, params):
        return F.adjust_sharpness(inpt, self.sharpness_factor)


class RandomInvert(_RandomApplyTransform):
    _transformed_types = _IMAGE_TYPES

    def transform_sample(self, inpt, params):
        return F.invert(inpt)


class RandomChannelPermutation(Transform):
    _transformed_types = _IMAGE_TYPES

    def make_params(self, flat_inputs, generator):
        return dict(permutation=permutation(generator, _num_channels(flat_inputs)))

    def transform_sample(self, inpt, params):
        return F.permute_channels(inpt, params["permutation"])


class GaussianBlur(Transform):
    """``gaussian_blur`` at a sigma uniform in ``sigma`` (one for both
    axes)."""

    _transformed_types = _IMAGE_TYPES

    def __init__(self, kernel_size, sigma=(0.1, 2.0)):
        self.kernel_size = kernel_size
        if isinstance(sigma, (int, float)):
            sigma = (float(sigma), float(sigma))
        self.sigma = tuple(sigma)

    def make_params(self, flat_inputs, generator):
        sigma = uniform(generator, *self.sigma)
        return dict(sigma=[sigma, sigma])

    def transform_sample(self, inpt, params):
        return F.gaussian_blur(inpt, self.kernel_size, params["sigma"])


class GaussianNoise(Transform):
    """``gaussian_noise`` of images and videos. The params are one seed,
    drawn from the sample's CPU generator (so a ``Record`` keeps it); the
    normals come from a generator on the image's device seeded with it.
    They are torch's normals, not the JAX package's (which draws them
    from its key): the same seed gives the same noise on one device, and
    the card's differ from the CPU's."""

    _transformed_types = _IMAGE_TYPES

    def __init__(self, mean: float = 0.0, sigma: float = 0.1, clip: bool = True):
        self.mean = mean
        self.sigma = sigma
        self.clip = clip

    def make_params(self, flat_inputs, generator):
        return dict(seed=randint(generator, 0, 2 ** 62))

    def transform_sample(self, inpt, params):
        g = torch.Generator(device=inpt.device)
        g.manual_seed(params["seed"])
        return F.gaussian_noise(inpt, self.mean, self.sigma, self.clip,
                                generator=g)
