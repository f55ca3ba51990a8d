"""Geometry transforms (counterpart of
``vision_tpu/transforms/v2/_geometry.py``). For batches: ``RandomResizedCrop``
(the JAX package's traced draw and its ``batched`` resample, with the
horizontal flip folded in), ``RandomHorizontalFlip`` and
``RandomVerticalFlip``. For samples (``_transform.py``), every class here,
moving boxes, masks and keypoints with the image: the JAX package's eager
draws, as Python numbers from the sample's CPU generator (and
``ElasticTransform``'s displacement field, drawn and blurred on the host).
The others take a plain 4-d tensor as one sample, one draw for all its
images."""

from __future__ import annotations

import math
from typing import Any, Dict, List, Optional, Sequence, Union

import torch

from vision_tpu_torch import tv_tensors
from vision_tpu_torch.ops.boxes import box_iou
from vision_tpu_torch.transforms.v2 import functional as F
from vision_tpu_torch.transforms.v2._transform import (
    Shape,
    Transform,
    _RandomApplyTransform,
    rand,
    randint,
    uniform,
)
from vision_tpu_torch.transforms.v2._utils import query_size
from vision_tpu_torch.transforms.v2.functional._geometry import (
    _parse_pad,
    horizontal_flip_image,
    resized_crop_flip_batch,
    vertical_flip_image,
)
from vision_tpu_torch.transforms.v2.functional._misc import gaussian_blur_image

__all__ = ["CenterCrop", "ElasticTransform", "FiveCrop", "Pad",
           "RandomAffine", "RandomCrop", "RandomHorizontalFlip",
           "RandomIoUCrop", "RandomPerspective", "RandomResize",
           "RandomResizedCrop", "RandomRotation", "RandomShortestSize",
           "RandomVerticalFlip", "RandomZoomOut", "Resize", "ScaleJitter",
           "TenCrop"]

_CANDIDATES = 10


class RandomHorizontalFlip(_RandomApplyTransform):
    """Mirror each image (a sample: everything in it) with probability
    ``p``. ``keypoint_flip_indices`` (COCO person's 17-entry left/right
    map) re-orders ``KeyPoints`` after the mirror, so that a mirrored left
    shoulder is labelled the right one."""

    def __init__(self, p: float = 0.5,
                 keypoint_flip_indices: Optional[Sequence[int]] = None):
        super().__init__(p)
        self.keypoint_flip_indices = (
            None if keypoint_flip_indices is None
            else tuple(int(i) for i in keypoint_flip_indices))

    def transform_all(self, images, params):
        return horizontal_flip_image(images)

    def transform_sample(self, inpt, params):
        return F.horizontal_flip(inpt, self.keypoint_flip_indices)


class RandomVerticalFlip(_RandomApplyTransform):
    def transform_all(self, images, params):
        return vertical_flip_image(images)

    def transform_sample(self, inpt, params):
        return F.vertical_flip(inpt)


class RandomResizedCrop(Transform):
    """A crop of random area (a share in ``scale`` of the image's) and
    aspect (log-uniform in ``ratio``) resized to ``size``, one an image.

    The draw is the JAX package's traced one (``_make_params_traced``):
    ten candidates an image, the first whose rounded width and height fit
    the image is taken, its top-left corner uniform over the places it
    fits; an image with none takes the centre crop at the nearest aspect
    in range. ``draw(..., flip_p=p)`` also draws a mirror flag an image
    (RandomHorizontalFlip's), which the resample folds in. The resample is
    ``resized_crop_flip_batch``: bilinear, without antialias, as the JAX
    package's ``batched`` form (``interpolation`` and ``antialias`` are
    kept for its signature)."""

    def __init__(
        self,
        size: Union[int, Sequence[int]],
        scale=(0.08, 1.0),
        ratio=(3.0 / 4.0, 4.0 / 3.0),
        interpolation: str = "bilinear",
        antialias: bool = True,
    ):
        self.size = (size, size) if isinstance(size, int) else tuple(size)
        self.scale = tuple(scale)
        self.ratio = tuple(ratio)
        self.interpolation = interpolation
        self.antialias = antialias

    def output_shape(self, shape: Shape) -> Shape:
        return (*shape[:-2], *self.size)

    def draw(self, shape: Shape, generator: torch.Generator,
             flip_p: Optional[float] = None) -> Dict[str, Any]:
        """``top``, ``left``, ``height``, ``width``: ``[N]`` f32 pixels; with
        ``flip_p``, ``flip``: ``[N]`` bool."""
        n, height, width = shape[0], shape[-2], shape[-1]
        log_lo, log_hi = math.log(self.ratio[0]), math.log(self.ratio[1])
        u_scale = rand((n, _CANDIDATES), generator)
        u_scale = self.scale[0] + u_scale * (self.scale[1] - self.scale[0])
        aspect = torch.exp(log_lo + rand((n, _CANDIDATES), generator)
                           * (log_hi - log_lo))
        target_area = height * width * u_scale
        ws = torch.round(torch.sqrt(target_area * aspect))
        hs = torch.round(torch.sqrt(target_area / aspect))
        valid = (ws > 0) & (ws <= width) & (hs > 0) & (hs <= height)
        first = valid.int().argmax(1, keepdim=True)  # the first that fits
        any_valid = valid.any(1)
        # the centre crop at an in-range aspect (host numbers)
        in_ratio = width / height
        if in_ratio < self.ratio[0]:
            fw, fh = width, round(width / self.ratio[0])
        elif in_ratio > self.ratio[1]:
            fh, fw = height, round(height * self.ratio[1])
        else:
            fw, fh = width, height
        w = torch.where(any_valid, ws.gather(1, first)[:, 0], float(fw))
        h = torch.where(any_valid, hs.gather(1, first)[:, 0], float(fh))
        top = torch.where(any_valid, torch.floor(rand((n,), generator)
                                                 * (height - h + 1.0)),
                          torch.floor((height - h) / 2))
        left = torch.where(any_valid, torch.floor(rand((n,), generator)
                                                  * (width - w + 1.0)),
                           torch.floor((width - w) / 2))
        params = {"top": top, "left": left, "height": h, "width": w}
        if flip_p is not None:
            params["flip"] = rand((n,), generator) < flip_p
        return params

    def transform(self, images, params):
        return resized_crop_flip_batch(images, params["top"], params["left"],
                                       params["height"], params["width"],
                                       self.size, params.get("flip"))

    def batched(self, images: torch.Tensor, generator: torch.Generator,
                flip_p: Optional[float] = None) -> torch.Tensor:
        """The JAX package's ``batched``: crop (and, with ``flip_p``, flip)
        a whole batch."""
        return self.transform(images, self.draw(tuple(images.shape),
                                                generator, flip_p))

    def make_params(self, flat_inputs, generator):
        """The JAX package's eager draw: ten attempts, each a uniform area
        share and a log-uniform aspect, rounded; the first that fits takes
        a uniform corner; else the centre crop at an in-range aspect."""
        height, width = query_size(flat_inputs)
        area = height * width
        log_ratio = (math.log(self.ratio[0]), math.log(self.ratio[1]))
        for _ in range(_CANDIDATES):
            target_area = area * uniform(generator, *self.scale)
            aspect = math.exp(uniform(generator, *log_ratio))
            w = int(round(math.sqrt(target_area * aspect)))
            h = int(round(math.sqrt(target_area / aspect)))
            if 0 < w <= width and 0 < h <= height:
                return dict(top=randint(generator, 0, height - h + 1),
                            left=randint(generator, 0, width - w + 1),
                            height=h, width=w)
        in_ratio = width / height
        if in_ratio < self.ratio[0]:
            w, h = width, int(round(width / self.ratio[0]))
        elif in_ratio > self.ratio[1]:
            h, w = height, int(round(height * self.ratio[1]))
        else:
            w, h = width, height
        return dict(top=(height - h) // 2, left=(width - w) // 2, height=h,
                    width=w)

    def transform_sample(self, inpt, params):
        return F.resized_crop(inpt, params["top"], params["left"],
                              params["height"], params["width"], self.size,
                              self.interpolation, self.antialias)

    def __repr__(self) -> str:
        return (f"RandomResizedCrop(size={self.size}, scale={self.scale}, "
                f"ratio={self.ratio})")


class Resize(Transform):
    def __init__(self, size, interpolation: str = "bilinear",
                 max_size: Optional[int] = None, antialias: bool = True):
        self.size = size
        self.interpolation = interpolation
        self.max_size = max_size
        self.antialias = antialias

    def transform_sample(self, inpt, params):
        return F.resize(inpt, self.size, self.interpolation, self.max_size,
                        self.antialias)


class CenterCrop(Transform):
    def __init__(self, size):
        self.size = size

    def transform_sample(self, inpt, params):
        return F.center_crop(inpt, self.size)


class Pad(Transform):
    def __init__(self, padding, fill=0, padding_mode: str = "constant"):
        self.padding = padding
        self.fill = fill
        self.padding_mode = padding_mode

    def transform_sample(self, inpt, params):
        return F.pad(inpt, self.padding, self.fill, self.padding_mode)


class RandomCrop(Transform):
    """A ``size`` crop at a uniform corner, after ``padding``; with
    ``pad_if_needed`` a side shorter than the crop is padded on both ends
    by the shortfall first (the JAX package's rule, which the detection
    recipe's ``lsj`` policy takes as torchvision's ``FixedSizeCrop``)."""

    def __init__(self, size, padding=None, pad_if_needed: bool = False,
                 fill=0, padding_mode: str = "constant"):
        self.size = (size, size) if isinstance(size, int) else tuple(size)
        self.padding = padding
        self.pad_if_needed = pad_if_needed
        self.fill = fill
        self.padding_mode = padding_mode

    def make_params(self, flat_inputs, generator):
        h, w = query_size(flat_inputs)
        if self.padding is not None:
            left, top, right, bottom = _parse_pad(self.padding)
            h, w = h + top + bottom, w + left + right
        th, tw = self.size
        pad_extra = [0, 0, 0, 0]  # left, top, right, bottom
        if self.pad_if_needed:
            if w < tw:
                pad_extra[0] = pad_extra[2] = tw - w
                w += 2 * (tw - w)
            if h < th:
                pad_extra[1] = pad_extra[3] = th - h
                h += 2 * (th - h)
        if h < th or w < tw:
            raise ValueError(f"crop size {self.size} larger than input ({h}, {w})")
        return dict(top=randint(generator, 0, h - th + 1),
                    left=randint(generator, 0, w - tw + 1), pad_extra=pad_extra)

    def transform_sample(self, inpt, params):
        out = inpt
        if self.padding is not None:
            out = F.pad(out, self.padding, self.fill, self.padding_mode)
        if any(params["pad_extra"]):
            out = F.pad(out, params["pad_extra"], self.fill, self.padding_mode)
        return F.crop(out, params["top"], params["left"], *self.size)


class _RandomResizeBase(Transform):
    def __init__(self, interpolation: str = "bilinear", antialias: bool = True):
        self.interpolation = interpolation
        self.antialias = antialias

    def transform_sample(self, inpt, params):
        return F.resize(inpt, params["size"], self.interpolation,
                        antialias=self.antialias)


class ScaleJitter(_RandomResizeBase):
    """Resize by ``min(target_h / H, target_w / W)`` times a uniform factor
    in ``scale_range``."""

    def __init__(self, target_size, scale_range=(0.1, 2.0),
                 interpolation: str = "bilinear", antialias: bool = True):
        super().__init__(interpolation, antialias)
        self.target_size = target_size
        self.scale_range = scale_range

    def make_params(self, flat_inputs, generator):
        orig_h, orig_w = query_size(flat_inputs)
        scale = self.scale_range[0] + uniform(generator) * (
            self.scale_range[1] - self.scale_range[0])
        r = min(self.target_size[1] / orig_h,
                self.target_size[0] / orig_w) * scale
        return dict(size=(int(orig_h * r), int(orig_w * r)))


class RandomShortestSize(_RandomResizeBase):
    """The short side to one of ``min_size`` (uniform), the long side kept
    within ``max_size``."""

    def __init__(self, min_size, max_size: Optional[int] = None,
                 interpolation: str = "bilinear", antialias: bool = True):
        super().__init__(interpolation, antialias)
        self.min_size = [min_size] if isinstance(min_size, int) else list(min_size)
        self.max_size = max_size

    def make_params(self, flat_inputs, generator):
        orig_h, orig_w = query_size(flat_inputs)
        min_size = self.min_size[randint(generator, 0, len(self.min_size))]
        r = min_size / min(orig_h, orig_w)
        if self.max_size is not None:
            r = min(r, self.max_size / max(orig_h, orig_w))
        return dict(size=(int(orig_h * r), int(orig_w * r)))


class RandomResize(_RandomResizeBase):
    """The short side to a uniform integer in [min_size, max_size)."""

    def __init__(self, min_size: int, max_size: int,
                 interpolation: str = "bilinear", antialias: bool = True):
        super().__init__(interpolation, antialias)
        self.min_size = min_size
        self.max_size = max_size

    def make_params(self, flat_inputs, generator):
        return dict(size=[randint(generator, self.min_size, self.max_size)])


class RandomZoomOut(_RandomApplyTransform):
    """With probability ``p``, the sample on a canvas ``r`` times its size
    (``r`` uniform in ``side_range``) filled with ``fill``, at a uniform
    place."""

    def __init__(self, fill=0, side_range=(1.0, 4.0), p: float = 0.5):
        super().__init__(p)
        if side_range[0] < 1.0 or side_range[0] > side_range[1]:
            raise ValueError(f"invalid side range {side_range}")
        self.fill = fill
        self.side_range = side_range

    def make_params(self, flat_inputs, generator):
        orig_h, orig_w = query_size(flat_inputs)
        r = self.side_range[0] + uniform(generator) * (
            self.side_range[1] - self.side_range[0])
        canvas_w, canvas_h = int(orig_w * r), int(orig_h * r)
        left = int(uniform(generator) * (canvas_w - orig_w))
        top = int(uniform(generator) * (canvas_h - orig_h))
        return dict(padding=[left, top, canvas_w - (left + orig_w),
                             canvas_h - (top + orig_h)])

    def transform_sample(self, inpt, params):
        return F.pad(inpt, params["padding"], self.fill)


class RandomIoUCrop(Transform):
    """SSD's crop: an overlap floor drawn from ``sampler_options`` (1.0: no
    crop), then up to ``trials`` crops of a uniform scale in [min_scale,
    max_scale] of each side, an aspect in range, at a uniform place, until
    one holds a box's centre and overlaps one such box by at least the
    floor; a sample with no box passes through. Sanitise the boxes after
    (``SanitizeBoundingBoxes``), as the recipe does. The draws read the
    boxes on the host: one host synchronisation a call for boxes on the
    card."""

    def __init__(self, min_scale: float = 0.3, max_scale: float = 1.0,
                 min_aspect_ratio: float = 0.5, max_aspect_ratio: float = 2.0,
                 sampler_options: Optional[List[float]] = None,
                 trials: int = 40):
        self.min_scale = min_scale
        self.max_scale = max_scale
        self.min_aspect_ratio = min_aspect_ratio
        self.max_aspect_ratio = max_aspect_ratio
        self.options = sampler_options or [0.0, 0.1, 0.3, 0.5, 0.7, 0.9, 1.0]
        self.trials = trials

    def make_params(self, flat_inputs, generator):
        orig_h, orig_w = query_size(flat_inputs)
        boxes = next((x for x in flat_inputs
                      if isinstance(x, tv_tensors.BoundingBoxes)), None)
        if boxes is None:
            return {}
        xyxy = F.convert_bounding_box_format(
            boxes, new_format="XYXY").as_tensor().float().cpu()
        cx = 0.5 * (xyxy[:, 0] + xyxy[:, 2])
        cy = 0.5 * (xyxy[:, 1] + xyxy[:, 3])
        while True:
            floor = self.options[randint(generator, 0, len(self.options))]
            if floor >= 1.0:
                return {}
            for _ in range(self.trials):
                r = self.min_scale + uniform(generator) * (
                    self.max_scale - self.min_scale)
                new_w, new_h = int(orig_w * r), int(orig_h * r)
                if not (self.min_aspect_ratio <= new_w / max(new_h, 1)
                        <= self.max_aspect_ratio):
                    continue
                left = int(uniform(generator) * (orig_w - new_w))
                top = int(uniform(generator) * (orig_h - new_h))
                right, bottom = left + new_w, top + new_h
                within = (left < cx) & (cx < right) & (top < cy) & (cy < bottom)
                if not bool(within.any()):
                    continue
                crop = torch.tensor([[left, top, right, bottom]],
                                    dtype=torch.float32)
                if float(box_iou(crop, xyxy[within]).max()) < floor:
                    continue
                return dict(top=top, left=left, height=new_h, width=new_w,
                            is_within_crop_area=within)

    def transform_sample(self, inpt, params):
        if not params:
            return inpt
        return F.crop(inpt, params["top"], params["left"], params["height"],
                      params["width"])


def _setup_range(value, name: str, center: float = 0.0):
    if isinstance(value, (int, float)):
        if value < 0:
            raise ValueError(f"{name} must be non-negative if scalar")
        return (center - value, center + value)
    return tuple(float(v) for v in value)


class RandomRotation(Transform):
    """A rotation by an angle uniform in ``degrees`` (a number ``d``: [-d,
    d]), about ``center``; with ``expand`` the canvas grows to hold it."""

    def __init__(self, degrees, interpolation: str = "nearest",
                 expand: bool = False, center=None, fill=0):
        self.degrees = _setup_range(degrees, "degrees")
        self.interpolation = interpolation
        self.expand = expand
        self.center = center
        self.fill = fill

    def make_params(self, flat_inputs, generator):
        return dict(angle=uniform(generator, *self.degrees))

    def transform_sample(self, inpt, params):
        return F.rotate(inpt, params["angle"], self.interpolation, self.expand,
                        self.center, self.fill)


class RandomAffine(Transform):
    """A rotation by an angle uniform in ``degrees``, a translation of up to
    ``translate`` (shares of the width and height, rounded to pixels), a
    scale uniform in ``scale`` and a shear uniform in ``shear`` (a number
    ``s``: x in [-s, s]; four numbers: x and y ranges)."""

    def __init__(self, degrees, translate=None, scale=None, shear=None,
                 interpolation: str = "nearest", fill=0, center=None):
        self.degrees = _setup_range(degrees, "degrees")
        self.translate = translate
        self.scale_range = scale
        self.shear = shear
        self.interpolation = interpolation
        self.fill = fill
        self.center = center

    def make_params(self, flat_inputs, generator):
        height, width = query_size(flat_inputs)
        angle = uniform(generator, *self.degrees)
        translations = [0, 0]
        if self.translate is not None:
            max_dx = self.translate[0] * width
            max_dy = self.translate[1] * height
            translations = [int(round(uniform(generator, -max_dx, max_dx))),
                            int(round(uniform(generator, -max_dy, max_dy)))]
        scale = 1.0
        if self.scale_range is not None:
            scale = uniform(generator, *self.scale_range)
        shear_x = shear_y = 0.0
        if self.shear is not None:
            shear = self.shear
            if isinstance(shear, (int, float)):
                shear = (-shear, shear)
            shear_x = uniform(generator, shear[0], shear[1])
            if len(shear) == 4:
                shear_y = uniform(generator, shear[2], shear[3])
        return dict(angle=angle, translate=translations, scale=scale,
                    shear=[shear_x, shear_y])

    def transform_sample(self, inpt, params):
        return F.affine(inpt, params["angle"], params["translate"],
                        params["scale"], params["shear"], self.interpolation,
                        self.fill, self.center)


class RandomPerspective(_RandomApplyTransform):
    """With probability ``p``, the four corners moved inwards by up to
    ``distortion_scale`` of half the width and height, each by uniform
    integers, and the image warped by the homography between."""

    def __init__(self, distortion_scale: float = 0.5, p: float = 0.5,
                 interpolation: str = "bilinear", fill=0):
        super().__init__(p)
        if not 0 <= distortion_scale <= 1:
            raise ValueError("distortion_scale must be in [0, 1]")
        self.distortion_scale = distortion_scale
        self.interpolation = interpolation
        self.fill = fill

    def make_params(self, flat_inputs, generator):
        height, width = query_size(flat_inputs)
        d = self.distortion_scale
        bound_h = int(d * (height // 2)) + 1
        bound_w = int(d * (width // 2)) + 1

        def ri(n):
            return randint(generator, 0, n)

        topleft = [ri(bound_w), ri(bound_h)]
        topright = [width - ri(bound_w) - 1, ri(bound_h)]
        botright = [width - ri(bound_w) - 1, height - ri(bound_h) - 1]
        botleft = [ri(bound_w), height - ri(bound_h) - 1]
        startpoints = [[0, 0], [width - 1, 0], [width - 1, height - 1],
                       [0, height - 1]]
        return dict(startpoints=startpoints,
                    endpoints=[topleft, topright, botright, botleft])

    def transform_sample(self, inpt, params):
        return F.perspective(inpt, params["startpoints"], params["endpoints"],
                             self.interpolation, self.fill)


class ElasticTransform(Transform):
    """A smooth random displacement field: ``[1, H, W, 2]`` uniform draws in
    [-1, 1) from the sample's CPU generator, each of x and y blurred
    (``gaussian_blur_image``, kernel ``8 sigma + 1`` made odd) and scaled by
    ``alpha`` over the width or height, on the host, so that a ``Record``
    keeps it and a ``Replay`` can hand the JAX package's across. It goes to
    the sample's device once a call, from pinned memory."""

    def __init__(self, alpha=50.0, sigma=5.0, interpolation: str = "bilinear",
                 fill=0):
        self.alpha = ((float(alpha),) * 2 if isinstance(alpha, (int, float))
                      else tuple(float(a) for a in alpha))
        self.sigma = ((float(sigma),) * 2 if isinstance(sigma, (int, float))
                      else tuple(float(s) for s in sigma))
        self.interpolation = interpolation
        self.fill = fill

    def make_params(self, flat_inputs, generator):
        h, w = query_size(flat_inputs)
        fields = []
        for alpha, sigma, extent in zip(self.alpha, self.sigma, (w, h)):
            d = torch.rand((1, 1, h, w), generator=generator) * 2.0 - 1.0
            if sigma > 0.0:
                ks = int(8 * sigma + 1)
                ks += 1 - ks % 2
                d = gaussian_blur_image(d, ks, sigma)
            fields.append(d * alpha / extent)
        return dict(displacement=torch.cat(fields, 1).permute(0, 2, 3, 1)
                    .contiguous())

    def prepare(self, params, flat_inputs):
        field = params["displacement"]
        dev = next((x.device for x in flat_inputs
                    if isinstance(x, torch.Tensor)), field.device)
        if field.device == dev:
            return params
        if dev.type == "cuda" and field.device.type == "cpu":
            field = field.pin_memory().to(dev, non_blocking=True)
        else:
            field = field.to(dev)
        return dict(params, displacement=field)

    def transform_sample(self, inpt, params):
        return F.elastic(inpt, params["displacement"], self.interpolation,
                         self.fill)


class FiveCrop(Transform):
    """The five ``size`` crops of each image or video (``five_crop``): the
    leaf becomes a tuple of five. Masks, boxes and keypoints pass
    through."""

    _transformed_types = (tv_tensors.Image, tv_tensors.Video, torch.Tensor)

    def __init__(self, size):
        self.size = size

    def transform_sample(self, inpt, params):
        return F.five_crop(inpt, self.size)


class TenCrop(Transform):
    """``FiveCrop`` of each image or video and of its mirror: a tuple of
    ten."""

    _transformed_types = (tv_tensors.Image, tv_tensors.Video, torch.Tensor)

    def __init__(self, size, vertical_flip: bool = False):
        self.size = size
        self.vertical_flip = vertical_flip

    def transform_sample(self, inpt, params):
        return F.ten_crop(inpt, self.size, self.vertical_flip)
