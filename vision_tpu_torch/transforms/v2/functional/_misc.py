"""Value functionals (counterpart of
``vision_tpu/transforms/v2/functional/_misc.py``): ``normalize_image``,
``to_dtype_image`` and ``gaussian_blur_image`` on ``(..., C, H, W)``
tensors, ``normalize``, ``to_dtype``, ``gaussian_blur`` and
``gaussian_noise`` on typed ones, and ``sanitize_bounding_boxes``."""

from __future__ import annotations

import functools
from typing import Optional, Sequence, Tuple, Union

import torch
import torch.nn.functional as F

from vision_tpu_torch import tv_tensors
from vision_tpu_torch.ops.boxes import box_convert

__all__ = ["gaussian_blur", "gaussian_blur_image", "gaussian_noise",
           "normalize", "normalize_image", "sanitize_bounding_boxes",
           "to_dtype", "to_dtype_image"]

_VALUE_BITS = {
    torch.uint8: 8,
    torch.int8: 7,
    torch.int16: 15,
    torch.uint16: 16,
    torch.int32: 31,
    torch.int64: 63,
}


@functools.lru_cache(maxsize=64)
def _channel_values(values: Tuple[float, ...], dtype: torch.dtype,
                    device: torch.device) -> torch.Tensor:
    """``values`` as a ``[C, 1, 1]`` tensor on ``device``, made once: a list
    copied to the card on every call would hold the host until the card's
    stream drains. Never an inference tensor, so that autograd may save it."""
    with torch.inference_mode(False):
        return torch.tensor(values, dtype=dtype).to(device)[:, None, None]


@functools.lru_cache(maxsize=64)
def _index(values: Tuple[int, ...], device: torch.device) -> torch.Tensor:
    """``values`` as an int64 index tensor on ``device``, made once (an
    index list copied to the card at every call would wait for it)."""
    with torch.inference_mode(False):
        host = torch.tensor(values, dtype=torch.int64)
        if device.type == "cuda":
            return host.pin_memory().to(device, non_blocking=True)
        return host.to(device)


def normalize_image(image: torch.Tensor, mean: Sequence[float],
                    std: Sequence[float]) -> torch.Tensor:
    """``(x - mean) / std`` over the channel axis (-3) of a float image."""
    if not image.is_floating_point():
        raise TypeError(f"normalize expects float input, got {image.dtype}")
    mean = _channel_values(tuple(float(m) for m in mean), image.dtype, image.device)
    std = _channel_values(tuple(float(s) for s in std), image.dtype, image.device)
    return (image - mean) / std


def to_dtype_image(image: torch.Tensor, dtype: torch.dtype = torch.float32,
                   scale: bool = False) -> torch.Tensor:
    """Convert ``image`` to ``dtype``; with ``scale``, map the value range
    of one type onto the other's (integers to [0, 1] by the reciprocal of
    the type's maximum; [0, 1] floats to integers by ``max + 1 - 1e-3``,
    truncated; integers to integers by bit shifts)."""
    if image.dtype == dtype:
        return image
    if not scale:
        return image.to(dtype)
    if image.is_floating_point():
        if dtype.is_floating_point:
            return image.to(dtype)
        if image.dtype == torch.float32 and dtype in (torch.int32, torch.int64):
            raise RuntimeError(
                f"conversion {image.dtype} -> {dtype} cannot be performed safely")
        max_value = float(torch.iinfo(dtype).max)
        return (image * (max_value + 1.0 - 1e-3)).to(dtype)
    if dtype.is_floating_point:
        return image.to(dtype) * (1.0 / float(torch.iinfo(image.dtype).max))
    in_bits, out_bits = _VALUE_BITS[image.dtype], _VALUE_BITS[dtype]
    if in_bits > out_bits:
        return (image >> (in_bits - out_bits)).to(dtype)
    return image.to(dtype) << (out_bits - in_bits)


def _image_like(inpt) -> bool:
    return isinstance(inpt, (tv_tensors.Image, tv_tensors.Video)) or not (
        isinstance(inpt, tv_tensors.TVTensor))


def to_dtype(inpt, dtype: torch.dtype = torch.float32, scale: bool = False):
    """Images, videos and plain tensors through ``to_dtype_image``; masks,
    boxes and keypoints cast as they are."""
    if not isinstance(inpt, tv_tensors.TVTensor):
        return to_dtype_image(inpt, dtype, scale)
    if _image_like(inpt):
        out = to_dtype_image(inpt.as_tensor(), dtype, scale)
    else:
        out = inpt.as_tensor().to(dtype)
    return tv_tensors.wrap(out, like=inpt)


def normalize(inpt, mean: Sequence[float], std: Sequence[float]):
    if not _image_like(inpt):
        raise TypeError(f"normalize takes images and videos, got "
                        f"{type(inpt).__name__}")
    if isinstance(inpt, tv_tensors.TVTensor):
        return tv_tensors.wrap(normalize_image(inpt.as_tensor(), mean, std),
                               like=inpt)
    return normalize_image(inpt, mean, std)


def sanitize_bounding_boxes(boxes, format=None,
                            canvas_size: Optional[Tuple[int, int]] = None,
                            min_size: float = 1.0, min_area: float = 1.0):
    """(boxes, valid): ``valid`` ``[N]`` marks the boxes at least
    ``min_size`` wide and high, of area at least ``min_area``, and inside
    the canvas at every coordinate (a box that sticks out is dropped:
    clamp first to keep it). The boxes come back as they were;
    ``format`` and ``canvas_size`` go with a plain tensor only."""
    if isinstance(boxes, tv_tensors.BoundingBoxes):
        if format is not None or canvas_size is not None:
            raise ValueError("format and canvas_size must not be passed with "
                             "BoundingBoxes")
        fmt, (h, w) = boxes.format.value.lower(), boxes.canvas_size
        data = boxes.as_tensor()
    else:
        if format is None or canvas_size is None:
            raise ValueError("format and canvas_size are required for plain "
                             "tensors")
        fmt = (format.value if isinstance(format, tv_tensors.BoundingBoxFormat)
               else str(format)).lower()
        (h, w), data = canvas_size, boxes
    xyxy = box_convert(data.float(), fmt, "xyxy")
    ws = xyxy[..., 2] - xyxy[..., 0]
    hs = xyxy[..., 3] - xyxy[..., 1]
    valid = (ws >= min_size) & (hs >= min_size) & (ws * hs >= min_area)
    valid &= (xyxy >= 0).all(-1)
    valid &= (xyxy[..., 0] <= w) & (xyxy[..., 2] <= w)
    valid &= (xyxy[..., 1] <= h) & (xyxy[..., 3] <= h)
    return boxes, valid


def _pad_index(n: int, before: int, after: int, mode: str,
               device) -> torch.Tensor:
    """Source index of each padded position along an axis of ``n``: edge
    copies, or the periodic reflection numpy's ``reflect`` and
    ``symmetric`` pads make however wide the pad."""
    i = torch.arange(-before, n + after, device=device)
    if mode == "edge":
        return i.clamp(0, n - 1)
    period = 2 * n - (2 if mode == "reflect" else 0)
    if period <= 0:
        return torch.zeros_like(i)
    i = torch.remainder(i, period)
    if mode == "reflect":
        return torch.where(i < n, i, period - i)
    if mode == "symmetric":
        return torch.where(i < n, i, period - 1 - i)
    raise ValueError(f"unknown padding_mode {mode!r}")


def _gaussian_kernel1d(kernel_size: int, sigma: float, device) -> torch.Tensor:
    """The normalised gaussian of ``kernel_size`` taps at ``sigma``, in f64
    then f32, made on ``device`` (the JAX package's numpy arithmetic;
    made there, no copy from the host waits for the card)."""
    half = (kernel_size - 1) * 0.5
    x = torch.linspace(-half, half, kernel_size, dtype=torch.float64,
                       device=device)
    pdf = torch.exp(-0.5 * (x / sigma) ** 2)
    return (pdf / pdf.sum()).float()


def _blur_params(kernel_size, sigma):
    if isinstance(kernel_size, int):
        kernel_size = [kernel_size, kernel_size]
    if len(kernel_size) == 1:
        kernel_size = [kernel_size[0], kernel_size[0]]
    for ks in kernel_size:
        if ks <= 0 or ks % 2 == 0:
            raise ValueError(f"kernel_size must be positive odd, got {kernel_size}")
    if sigma is None:
        sigma = [ks * 0.15 + 0.35 for ks in kernel_size]
    elif isinstance(sigma, (int, float)):
        sigma = [float(sigma), float(sigma)]
    elif len(sigma) == 1:
        sigma = [float(sigma[0]), float(sigma[0])]
    return [int(k) for k in kernel_size], [float(s) for s in sigma]


def gaussian_blur_image(image: torch.Tensor,
                        kernel_size: Union[int, Sequence[int]],
                        sigma: Optional[Union[float, Sequence[float]]] = None
                        ) -> torch.Tensor:
    """Separable gaussian blur of ``(..., C, H, W)`` images, reflect-padded:
    a depthwise ``conv2d`` (``groups=C``) down the rows, then one along
    them, f32 sums, an integer image rounded and clamped back. As in the
    JAX package, ``kernel_size[0]`` and ``sigma[0]`` are the vertical
    pass's (torchvision's first entries are the horizontal one's)."""
    (ky_size, kx_size), (sy, sx) = _blur_params(kernel_size, sigma)
    c, h, w = image.shape[-3:]
    dev = image.device
    x = image.float().reshape(-1, c, h, w)
    py, px = ky_size // 2, kx_size // 2
    x = x.index_select(-2, _pad_index(h, py, py, "reflect", dev))
    x = x.index_select(-1, _pad_index(w, px, px, "reflect", dev))
    ky = _gaussian_kernel1d(ky_size, sy, dev)
    kx = _gaussian_kernel1d(kx_size, sx, dev)
    x = F.conv2d(x, ky.view(1, 1, -1, 1).repeat(c, 1, 1, 1), groups=c)
    x = F.conv2d(x, kx.view(1, 1, 1, -1).repeat(c, 1, 1, 1), groups=c)
    out = x.reshape(image.shape)
    if not image.dtype.is_floating_point:
        info = torch.iinfo(image.dtype)
        out = torch.round(out).clamp(info.min, info.max)
    return out.to(image.dtype)


def gaussian_blur(inpt, kernel_size, sigma=None):
    """Images, videos and plain tensors blurred; masks, boxes and keypoints
    as they are."""
    if _image_like(inpt):
        if isinstance(inpt, tv_tensors.TVTensor):
            return tv_tensors.wrap(gaussian_blur_image(
                inpt.as_tensor(), kernel_size, sigma), like=inpt)
        return gaussian_blur_image(inpt, kernel_size, sigma)
    return inpt


def gaussian_noise(inpt, mean: float = 0.0, sigma: float = 0.1,
                   clip: bool = True, *,
                   generator: Optional[torch.Generator] = None,
                   normals: Optional[torch.Tensor] = None):
    """``x + mean + sigma * z`` for a float image (clipped to [0, 1]); for
    uint8, ``255 (mean + sigma z)`` truncated to int16, added, clipped to
    [0, 255] (the JAX package's and torchvision's arithmetic). ``z`` are
    standard normals drawn from ``generator`` (on the image's device;
    None: torch's default one), or ``normals`` (of the image's shape) where
    given: the draws are torch's, not JAX's. Other types raise."""
    if sigma < 0:
        raise ValueError(f"sigma shouldn't be negative. Got {sigma}")
    img = inpt.as_tensor() if isinstance(inpt, tv_tensors.TVTensor) else inpt
    if not (img.is_floating_point() or img.dtype == torch.uint8):
        raise ValueError(f"Input is expected to be uint8 or float, got "
                         f"dtype={img.dtype}")
    z_dtype = img.dtype if img.is_floating_point() else torch.float32
    if normals is None:
        z = torch.randn(img.shape, generator=generator, dtype=z_dtype,
                        device=img.device)
    else:
        z = normals.to(img.device, z_dtype)
    if img.is_floating_point():
        out = img + (mean + z * sigma)
        if clip:
            out = out.clamp(0.0, 1.0)
    else:
        noise = (mean * 255.0 + z * (sigma * 255.0)).to(torch.int16)
        out = img.to(torch.int16) + noise
        if clip:
            out = out.clamp(0, 255)
        out = out.to(torch.uint8)
    if isinstance(inpt, tv_tensors.TVTensor):
        return tv_tensors.wrap(out, like=inpt)
    return out
