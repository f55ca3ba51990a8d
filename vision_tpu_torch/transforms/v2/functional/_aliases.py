"""The v1 functional names and the per-type kernel names (counterpart of
``vision_tpu/transforms/v2/functional/_aliases.py``): ``hflip``,
``to_tensor``, ``get_image_size``, ``<op>_video``, ``get_size_mask`` and the
rest. torchvision exports one ``<op>_<type>`` kernel a type; here, as in the
JAX package, a per-type name is the functional that dispatches on the
input's type (a plain tensor is an image, a ``Video`` has its frames as one
more leading axis).

PIL is imported where a function takes or makes a PIL image, never with the
module: on a machine without it, ``to_pil_image`` raises a
``ModuleNotFoundError`` that names it, and nothing else notices.
"""

from __future__ import annotations

import importlib
import sys
from typing import List

import numpy as np
import torch

from vision_tpu_torch import tv_tensors
from vision_tpu_torch.transforms.v2.functional import _color, _geometry
from vision_tpu_torch.transforms.v2.functional._meta import (
    get_num_channels,
    get_num_frames,
    get_size,
)
from vision_tpu_torch.transforms.v2.functional._misc import _index, to_dtype

__all__ = [
    "convert_image_dtype",
    "elastic_transform",
    "get_dimensions",
    "get_image_num_channels",
    "get_image_size",
    "grayscale_to_rgb_image",
    "hflip",
    "pil_to_tensor",
    "sanitize_keypoints",
    "to_grayscale",
    "to_image",
    "to_pil_image",
    "to_tensor",
    "uniform_temporal_subsample",
    "uniform_temporal_subsample_video",
    "vflip",
]

hflip = _geometry.horizontal_flip
vflip = _geometry.vertical_flip
elastic_transform = _geometry.elastic
grayscale_to_rgb_image = _color.grayscale_to_rgb


def _pil(what: str):
    """``PIL.Image``, or a ``ModuleNotFoundError`` that names ``what``."""
    try:
        return importlib.import_module("PIL.Image")
    except ModuleNotFoundError as e:
        raise ModuleNotFoundError(f"{what} needs PIL (Pillow), which is not "
                                  "installed", name="PIL") from e


def is_pil_image(x) -> bool:
    """Whether ``x`` is a PIL image (False wherever PIL was never loaded)."""
    mod = sys.modules.get("PIL.Image")
    return mod is not None and isinstance(x, mod.Image)


def _pil_array(pic) -> np.ndarray:
    arr = np.asarray(pic)
    return arr[..., None] if arr.ndim == 2 else arr


def convert_image_dtype(image, dtype: torch.dtype = torch.float32):
    """The v1 ``convert_image_dtype``: ``to_dtype(..., scale=True)``."""
    return to_dtype(image, dtype, scale=True)


def get_dimensions(inpt) -> List[int]:
    """[C, H, W]."""
    return [get_num_channels(inpt), *get_size(inpt)]


def get_image_size(inpt) -> List[int]:
    """The v1 ``get_image_size``: [W, H]."""
    h, w = get_size(inpt)
    return [w, h]


def get_image_num_channels(inpt) -> int:
    return get_num_channels(inpt)


def pil_to_tensor(pic) -> torch.Tensor:
    """A PIL image as a ``[C, H, W]`` tensor of its own type."""
    return torch.from_numpy(np.ascontiguousarray(
        _pil_array(pic).transpose(2, 0, 1)))


def to_image(inpt) -> tv_tensors.Image:
    """An ``Image``: a numpy ``(H, W[, C])`` array or a PIL image as ``[C,
    H, W]``, a tensor as it is."""
    if isinstance(inpt, tv_tensors.Image):
        return inpt
    if isinstance(inpt, np.ndarray):
        return tv_tensors.Image(torch.from_numpy(np.ascontiguousarray(
            np.atleast_3d(inpt).transpose(2, 0, 1))))
    if is_pil_image(inpt):
        return tv_tensors.Image(pil_to_tensor(inpt))
    if isinstance(inpt, torch.Tensor):
        return tv_tensors.Image(inpt.as_subclass(torch.Tensor))
    raise TypeError(f"to_image takes a tensor, a numpy array or a PIL image, "
                    f"got {type(inpt).__name__}")


def to_pil_image(pic, mode=None):
    """A ``[C, H, W]`` (or ``[H, W]``) tensor or array as a PIL image; a
    float one scaled by 255, rounded and clipped first."""
    image = _pil("to_pil_image")
    if isinstance(pic, torch.Tensor):
        arr = pic.as_subclass(torch.Tensor).detach().cpu().numpy()
    else:
        arr = np.asarray(pic)
    if arr.ndim == 3:
        arr = arr.transpose(1, 2, 0)
    if arr.dtype != np.uint8:
        arr = np.clip(arr * 255.0 + 0.5, 0, 255).astype(np.uint8)
    if arr.ndim == 3 and arr.shape[-1] == 1:
        arr = arr[..., 0]
    return image.fromarray(arr, mode) if mode else image.fromarray(arr)


def to_tensor(pic) -> torch.Tensor:
    """The v1 ``to_tensor``: a numpy ``(H, W[, C])`` array or a PIL image as
    an f32 ``[C, H, W]`` tensor, integers scaled into [0, 1] by 1/255
    (torchvision's layout; the JAX package keeps ``(H, W, C)``)."""
    if isinstance(pic, torch.Tensor):
        raise TypeError("to_tensor takes a numpy array or a PIL image, got a "
                        "tensor")
    arr = _pil_array(pic) if is_pil_image(pic) else np.asarray(pic)
    if arr.ndim == 2:
        arr = arr[..., None]
    out = torch.from_numpy(np.ascontiguousarray(arr.transpose(2, 0, 1)))
    if not out.is_floating_point():
        return out.to(torch.float32) / 255.0
    return out.to(torch.float32)


def to_grayscale(inpt, num_output_channels: int = 1):
    """The v1 ``to_grayscale``: ``rgb_to_grayscale``, typed as the input."""
    if isinstance(inpt, tv_tensors.TVTensor):
        return tv_tensors.wrap(_color.rgb_to_grayscale(
            inpt.as_tensor(), num_output_channels), like=inpt)
    return _color.rgb_to_grayscale(inpt, num_output_channels)


def uniform_temporal_subsample(video, num_samples: int):
    """``num_samples`` frames of ``video`` (``[..., T, C, H, W]``) at the f32
    points of ``linspace(0, T - 1, num_samples)`` rounded (the JAX
    package's functional; its class, ``UniformTemporalSubsample``,
    truncates)."""
    t = video.shape[-4]
    idx = torch.linspace(0, t - 1, num_samples, dtype=torch.float32).round()
    index = _index(tuple(int(i) for i in idx.tolist()), video.device)
    if isinstance(video, tv_tensors.TVTensor):
        return tv_tensors.wrap(video.as_tensor().index_select(-4, index),
                               like=video)
    return video.index_select(-4, index)


uniform_temporal_subsample_video = uniform_temporal_subsample


def sanitize_keypoints(keypoints, canvas_size=None):
    """(keypoints, valid): ``valid`` ``[N]`` marks each group (the first
    axis) whose every point lies inside the canvas, ``0 <= x < W`` and ``0
    <= y < H``. The keypoints come back as they were."""
    if canvas_size is None:
        canvas_size = keypoints.canvas_size
    h, w = canvas_size
    pts = (keypoints.as_tensor() if isinstance(keypoints, tv_tensors.TVTensor)
           else keypoints)
    inside = ((pts[..., 0] >= 0) & (pts[..., 0] < w)
              & (pts[..., 1] >= 0) & (pts[..., 1] < h))
    return keypoints, inside.reshape(inside.shape[0], -1).all(-1)


# the per-type names, each the functional that dispatches (the JAX
# package's ``_alias_per_type`` and ``_get_size_aliases``)
PER_TYPE = {
    "image": ["adjust_brightness", "adjust_contrast", "adjust_gamma",
              "adjust_hue", "adjust_saturation", "adjust_sharpness",
              "autocontrast", "equalize", "erase", "five_crop",
              "gaussian_noise", "rgb_to_grayscale", "invert", "jpeg",
              "permute_channels", "posterize", "solarize", "ten_crop"],
    "video": ["adjust_brightness", "adjust_contrast", "adjust_gamma",
              "adjust_hue", "adjust_saturation", "adjust_sharpness", "affine",
              "autocontrast", "center_crop", "crop", "elastic", "equalize",
              "erase", "five_crop", "gaussian_blur", "gaussian_noise",
              "horizontal_flip", "invert", "jpeg", "normalize", "pad",
              "permute_channels", "perspective", "posterize", "resize",
              "resized_crop", "rotate", "solarize", "ten_crop", "to_dtype",
              "vertical_flip"],
    "mask": ["center_crop", "elastic", "pad", "resized_crop"],
    "bounding_boxes": ["center_crop", "elastic", "pad", "resized_crop"],
    "keypoints": ["center_crop", "elastic", "pad", "perspective",
                  "resized_crop", "rotate"],
}
SIZE_ALIASES = {
    **{f"get_size_{t}": get_size for t in
       ("image", "video", "mask", "bounding_boxes", "keypoints")},
    "get_num_channels_image": get_num_channels,
    "get_num_channels_video": get_num_channels,
    "get_num_frames_video": get_num_frames,
    "get_dimensions_image": get_dimensions,
    "get_dimensions_video": get_dimensions,
}


def add_aliases(ns: dict) -> List[str]:
    """Put the per-type names into namespace ``ns`` (the functional
    package's), where it has the functional and not the name already;
    returns the names added."""
    added = []
    for suffix, ops in PER_TYPE.items():
        for op in ops:
            name = f"{op}_{suffix}"
            if name not in ns and op in ns:
                ns[name] = ns[op]
                added.append(name)
    for name, fn in SIZE_ALIASES.items():
        ns[name] = fn
        added.append(name)
    return added
