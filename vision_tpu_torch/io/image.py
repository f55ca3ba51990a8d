"""Image IO of the port (counterpart of ``vision_tpu/io/image.py``): JPEG
(sequential and progressive, sampling factors 1 to 4, CMYK on the host)
through the port's own codec (``csrc/jpeg_codec.cpp``), PNG and GIF
through ``csrc/image_codecs.cpp``, WebP (lossy, lossless, with alpha,
extended, an animation's first frame) through ``csrc/webp_codec.cpp``; no
PIL and no library fallback.

Images are CHW uint8 tensors, the port's layout (the JAX package returns
HWC arrays). ``decode_jpeg`` decodes on the card unless it is given
``device="cpu"``: on the CPU the whole decode runs on the host
(``_codecs.decode_jpeg_native``); on the card the host does the Huffman
pass and the card the rest (``jpeg_device.decode_jpeg_batch_device``).
Both give the same pixels within one count. A list is decoded on host
threads (``jpeg_device.decode_pool``), one batch for each frame size and
sampling. PNG, GIF and WebP decode on the host and land on ``device`` (the
card unless the caller asks for the CPU).
"""

from __future__ import annotations

import enum
import pathlib
from typing import List, Optional, Union

import numpy as np
import torch

from vision_tpu_torch.io import _codecs, _exif, _image_codecs
from vision_tpu_torch.io.jpeg_device import (
    decode_jpeg_batch_device,
    group_by_frame,
    host_decode_batch,
)
from vision_tpu_torch.models._api import resolve_device

__all__ = [
    "ImageReadMode",
    "decode_gif",
    "decode_image",
    "decode_jpeg",
    "decode_png",
    "decode_png16",
    "decode_webp",
    "encode_jpeg",
    "encode_png",
    "read_file",
    "read_image",
    "write_file",
    "write_jpeg",
    "write_png",
]

Device = Union[str, torch.device, None]


class ImageReadMode(enum.Enum):
    """reference ``io/image.py`` ImageReadMode."""

    UNCHANGED = 0
    GRAY = 1
    GRAY_ALPHA = 2
    RGB = 3
    RGB_ALPHA = 4


# ITU-R 601 luma, as vision_tpu's _apply_mode (truncated to uint8)
_GRAY_WEIGHTS = (0.2989, 0.587, 0.114)


def read_file(path: Union[str, pathlib.Path]) -> bytes:
    """reference ``io/image.py:59``."""
    with open(path, "rb") as f:
        return f.read()


def write_file(path: Union[str, pathlib.Path], data: bytes) -> None:
    with open(path, "wb") as f:
        f.write(data)


def _as_bytes(data) -> bytes:
    if isinstance(data, torch.Tensor):
        return data.cpu().numpy().tobytes()
    if isinstance(data, np.ndarray):
        return data.tobytes()
    return bytes(data)


def _gray(img: torch.Tensor) -> torch.Tensor:
    """``[..., 3, H, W]`` uint8 RGB -> ``[..., 1, H, W]`` luma, truncated."""
    w0, w1, w2 = _GRAY_WEIGHTS
    rgb = img[..., :3, :, :].to(torch.float32)
    lum = w0 * rgb[..., 0, :, :] + w1 * rgb[..., 1, :, :] + w2 * rgb[..., 2, :, :]
    return torch.clamp(lum, 0, 255).to(torch.uint8).unsqueeze(-3)


def _apply_mode(img: torch.Tensor, mode: ImageReadMode) -> torch.Tensor:
    """``vision_tpu``'s ``_apply_mode`` on a CHW uint8 tensor."""
    c = img.shape[-3]
    if mode == ImageReadMode.UNCHANGED:
        return img
    if mode == ImageReadMode.GRAY:
        if c == 1:
            return img
        if c == 2:  # gray + alpha: channel 0 is the luma plane
            return img[..., :1, :, :]
        return _gray(img)
    if mode == ImageReadMode.RGB:
        if c == 3:
            return img
        if c in (1, 2):  # replicate luma, drop alpha
            return img[..., :1, :, :].expand(*img.shape[:-3], 3,
                                             *img.shape[-2:]).contiguous()
        return img[..., :3, :, :]
    if mode == ImageReadMode.RGB_ALPHA:
        if c == 4:
            return img
        rgb = _apply_mode(img, ImageReadMode.RGB)
        alpha = img[..., 1:2, :, :] if c == 2 else torch.full_like(img[..., :1, :, :], 255)
        return torch.cat([rgb, alpha], dim=-3)
    if mode == ImageReadMode.GRAY_ALPHA:
        if c == 2:
            return img
        g = _apply_mode(img, ImageReadMode.GRAY)
        alpha = img[..., 3:4, :, :] if c == 4 else torch.full_like(img[..., :1, :, :], 255)
        return torch.cat([g, alpha], dim=-3)
    raise ValueError(f"unsupported mode {mode}")


def _coef_limit(scale) -> int:
    """``scale=(M, 8)``, M in 1..7: a DCT-scaled decode at M/8 size
    (``vision_tpu/io/image.py:160-175``)."""
    if scale is None:
        return 0
    if len(scale) != 2 or scale[1] != 8 or not 1 <= scale[0] <= 7:
        raise ValueError(
            f"DCT scaling supports scale=(M, 8) with M in 1..7, got {scale}")
    return int(scale[0])


def _orient(img: torch.Tensor, data: bytes, apply: bool) -> torch.Tensor:
    if not apply:
        return img
    return _exif.exif_orientation_transform(
        img, _exif.parse_jpeg_exif_orientation(data))


def decode_jpeg(
    data,
    mode: ImageReadMode = ImageReadMode.UNCHANGED,
    scale=None,
    device: Device = None,
    apply_exif_orientation: bool = False,
) -> Union[torch.Tensor, List[torch.Tensor]]:
    """Decode one JPEG stream, or a list of them, to CHW uint8 (reference
    ``io/image.py:173``; ``vision_tpu``'s ``decode_jpeg``).

    ``device`` None is the card: the host entropy-decodes and the card
    decodes the coefficients, a list as one batch per frame
    (``decode_jpeg_batch_device``); like ``vision_tpu``'s
    ``device="tpu"`` path it gives 3 channels for ``UNCHANGED`` (a grey
    stream replicated), takes ``GRAY`` and ``RGB``, and refuses the alpha
    modes. ``device="cpu"`` decodes on the host (a grey stream keeps one
    channel under ``UNCHANGED``), with every mode. ``scale=(M, 8)``, M in
    1..7, decodes at M/8 size from the top-left M x M coefficients on
    either device. ``apply_exif_orientation`` applies the APP1 orientation
    tag. Progressive streams read as sequential ones do. A CMYK (or YCCK)
    stream decodes on the host only, to RGB as ``vision_tpu``'s fallback
    (Pillow's ``convert("RGB")``) gives it; on the card it raises. A stream
    the decoder does not read (arithmetic-coded, 12-bit) or a corrupt one
    raises ``RuntimeError`` naming it."""
    device = resolve_device(device)
    coef_limit = _coef_limit(scale)
    is_list = isinstance(data, (list, tuple))
    buffers = [_as_bytes(b) for b in (data if is_list else [data])]
    if device.type == "cpu":
        out: List[Optional[torch.Tensor]] = [None] * len(buffers)
        for idx in group_by_frame(buffers):
            batch = host_decode_batch([buffers[i] for i in idx], coef_limit)
            for k, i in enumerate(idx):
                img = batch[k].permute(2, 0, 1).contiguous()
                out[i] = _orient(_apply_mode(img, mode), buffers[i],
                                 apply_exif_orientation)
        return out if is_list else out[0]
    if mode in (ImageReadMode.GRAY_ALPHA, ImageReadMode.RGB_ALPHA):
        raise ValueError("decode_jpeg on the card supports UNCHANGED, RGB and "
                         "GRAY (JPEG has no alpha; the host path makes one)")
    out = decode_jpeg_batch_device(buffers, coef_limit, device)
    if mode == ImageReadMode.GRAY:
        out = [_gray(img) for img in out]
    out = [_orient(img, b, apply_exif_orientation) for img, b in zip(out, buffers)]
    return out if is_list else out[0]


def _hwc(arr: np.ndarray) -> torch.Tensor:
    """``(..., H, W, C)`` numpy -> ``(..., C, H, W)`` contiguous tensor."""
    return torch.from_numpy(np.ascontiguousarray(arr)).movedim(-1, -3).contiguous()


def decode_png(
    data,
    mode: ImageReadMode = ImageReadMode.UNCHANGED,
    apply_exif_orientation: bool = False,
    device: Device = None,
) -> torch.Tensor:
    """A PNG to CHW uint8 (reference ``io/image.py:93``; ``vision_tpu``'s
    ``decode_png``): palettes and grey of 1-4 bits expanded, ``tRNS`` as an
    alpha channel, 16-bit samples cut to their high byte, Adam7 streams
    de-interlaced; then ``mode``, and the eXIf chunk's orientation with
    ``apply_exif_orientation``. Decoded on the host, returned on
    ``device`` (None: the card)."""
    device = resolve_device(device)
    data = _as_bytes(data)
    img = _apply_mode(_hwc(_image_codecs.decode_png_native(data)), mode)
    if apply_exif_orientation:
        img = _exif.exif_orientation_transform(
            img, _exif.parse_png_exif_orientation(data))
    return img.to(device)


def decode_png16(data, device: Device = None) -> torch.Tensor:
    """A 16-bit PNG to CHW ``torch.uint16`` (``vision_tpu``'s
    ``decode_png16``; the reference's ``decode_png`` keeps 16 bits): a
    ``tRNS`` colour gives an alpha channel of 0 or 65535. Another depth
    raises ``RuntimeError``."""
    device = resolve_device(device)
    return _hwc(_image_codecs.decode_png_native(_as_bytes(data),
                                                wide=True)).to(device)


def decode_gif(data, device: Device = None) -> torch.Tensor:
    """A GIF to uint8 RGB (reference ``io/image.py:362``; ``vision_tpu``'s
    ``decode_gif``): ``[N, 3, H, W]``, every frame composed on the logical
    screen (transparency, disposal), or ``[3, H, W]`` for one frame."""
    device = resolve_device(device)
    frames = _image_codecs.decode_gif_native(_as_bytes(data))
    out = _hwc(frames)
    return (out[0] if out.shape[0] == 1 else out).to(device)


def decode_webp(data, mode: ImageReadMode = ImageReadMode.UNCHANGED,
                device: Device = None) -> torch.Tensor:
    """A WebP to CHW uint8 (reference ``io/image.py:383``; ``vision_tpu``'s
    ``decode_webp``): ``[4, H, W]`` RGBA for ``UNCHANGED`` (libwebp's
    ``WebPDecodeRGBA``: lossy, lossless, lossy with an alpha plane, alpha
    255 where there is none), an animation's first frame on its canvas as
    Pillow gives it (``[3, H, W]`` where the file has no alpha flag); then
    ``mode``. Decoded on the host, returned on ``device`` (None: the card).
    A stream that neither libwebp nor Pillow reads raises ``RuntimeError``
    naming WebP and the reason."""
    device = resolve_device(device)
    img = _hwc(_image_codecs.decode_webp_native(_as_bytes(data)))
    return _apply_mode(img, mode).to(device)


_JPEG_MAGIC = b"\xff\xd8\xff"
_PNG_MAGIC = b"\x89PNG"
_GIF_MAGIC = b"GIF"
_WEBP_RIFF = b"RIFF"


def decode_image(
    data,
    mode: ImageReadMode = ImageReadMode.UNCHANGED,
    apply_exif_orientation: bool = False,
    device: Device = None,
) -> torch.Tensor:
    """Dispatch on the magic bytes (reference ``decode_image.cpp:80``):
    JPEG, PNG, GIF (a one-frame GIF takes ``mode``, an animation is
    returned as it is, as ``vision_tpu``'s does) and WebP.
    ``apply_exif_orientation`` reaches the JPEG and PNG decoders only, as in
    the reference."""
    data = _as_bytes(data)
    if data[:3] == _JPEG_MAGIC:
        return decode_jpeg(data, mode, device=device,
                           apply_exif_orientation=apply_exif_orientation)
    if data[:4] == _PNG_MAGIC:
        return decode_png(data, mode, apply_exif_orientation, device=device)
    if data[:3] == _GIF_MAGIC:
        out = decode_gif(data, device="cpu")
        out = _apply_mode(out, mode) if out.ndim == 3 else out
        return out.to(resolve_device(device))
    if data[:4] == _WEBP_RIFF and data[8:12] == b"WEBP":
        return decode_webp(data, mode, device=device)
    raise RuntimeError("Unsupported image format: expected jpeg/png/gif/webp "
                       "magic bytes")


def encode_jpeg(img: torch.Tensor, quality: int = 75) -> bytes:
    """A baseline JPEG of a ``[C, H, W]`` (C 1 or 3) or ``[H, W]`` uint8
    image, with libjpeg's default tables and sampling."""
    if not 1 <= quality <= 100:
        raise ValueError(f"quality must be in 1..100, got {quality}")
    img = torch.as_tensor(img)
    if img.dtype != torch.uint8:
        raise TypeError(f"encode_jpeg expects uint8, got {img.dtype}")
    if img.ndim == 2:
        img = img.unsqueeze(0)
    if img.ndim != 3 or img.shape[0] not in (1, 3):
        raise ValueError("encode_jpeg: permitted channel values are 1 or 3, "
                         f"got shape {tuple(img.shape)}")
    return _codecs.encode_jpeg_native(img.permute(1, 2, 0).cpu().numpy(), quality)


def write_jpeg(img: torch.Tensor, filename, quality: int = 75) -> None:
    write_file(filename, encode_jpeg(img, quality))


def encode_png(img: torch.Tensor, compression_level: int = 6) -> bytes:
    """An 8-bit PNG of a ``[C, H, W]`` (C 1-4) or ``[H, W]`` uint8 image
    (reference ``io/image.py`` ``encode_png``), rows filtered as libpng
    chooses by default, deflated at ``compression_level``."""
    img = torch.as_tensor(img)
    if img.dtype != torch.uint8:
        raise TypeError(f"encode_png expects uint8, got {img.dtype}")
    if img.ndim == 2:
        img = img.unsqueeze(0)
    if img.ndim != 3 or img.shape[0] not in (1, 2, 3, 4):
        raise ValueError("encode_png: permitted channel values are 1 to 4, "
                         f"got shape {tuple(img.shape)}")
    return _image_codecs.encode_png_native(img.permute(1, 2, 0).cpu().numpy(),
                                           compression_level)


def write_png(img: torch.Tensor, filename, compression_level: int = 6) -> None:
    write_file(filename, encode_png(img, compression_level))


def read_image(
    path: Union[str, pathlib.Path],
    mode: ImageReadMode = ImageReadMode.UNCHANGED,
    apply_exif_orientation: bool = False,
    device: Device = None,
) -> torch.Tensor:
    """reference ``io/image.py:350``: read, then ``decode_image``."""
    return decode_image(read_file(path), mode,
                        apply_exif_orientation=apply_exif_orientation,
                        device=device)
