"""Separable resampling as products with dense weight matrices
(counterpart of ``vision_tpu/transforms/v2/functional/_resample.py``).

The matrices are the JAX package's own: :func:`resample_matrix` is a
numpy copy of it (aten's upsample weights: centre, support and
normalisation). An image resizes as ``W_h @ x @ W_w^T``, two
``torch.matmul`` products in f32 on whatever device the image lies, which
is what the JAX package leaves to XLA. Each matrix goes to a device once
per (sizes, mode, device), not once per image.

Layout: the last two axes are (H, W), as in the port's CHW / NCHW
convention; the JAX package's are (H, W, C).

The antialiased bilinear matrix (aten's ``_compute_weights_aa``) is also
``jax.image.resize(..., method="bilinear")``'s, whose ``antialias``
defaults to True and which the JAX package's video recipe preset calls
directly: both widen the triangle by the shrink factor (support 1 when
enlarging) and normalise over the taps inside the image. They differ only
in rounding: JAX places the sample points in f32, this matrix in f64.
"""

from __future__ import annotations

import functools
from typing import Tuple

import numpy as np
import torch

__all__ = ["resample_matrix", "resize_2d", "resize_plane"]


def _triangle_filter(x: np.ndarray) -> np.ndarray:
    # bilinear: f(x) = max(0, 1 - |x|), support 1
    return np.clip(1.0 - np.abs(x), 0.0, None)


def _cubic_filter(x: np.ndarray, a: float) -> np.ndarray:
    # Keys cubic convolution kernel, support 2.
    # torch non-antialias uses a=-0.75 (UpSample.h cubic_convolution1/2);
    # torch antialias path uses a=-0.5 (matches PIL).
    x = np.abs(x)
    out = np.zeros_like(x)
    m1 = x <= 1.0
    m2 = (x > 1.0) & (x < 2.0)
    out[m1] = ((a + 2.0) * x[m1] - (a + 3.0)) * x[m1] * x[m1] + 1.0
    out[m2] = (((x[m2] - 5.0) * x[m2] + 8.0) * x[m2] - 4.0) * a
    return out


_FILTERS = {
    "bilinear": (_triangle_filter, 1.0),
    "linear": (_triangle_filter, 1.0),
}


@functools.lru_cache(maxsize=512)
def resample_matrix(
    in_size: int,
    out_size: int,
    mode: str = "bilinear",
    antialias: bool = True,
    align_corners: bool = False,
) -> np.ndarray:
    """Dense (out_size, in_size) float32 resampling matrix W with
    ``out[i] = sum_j W[i, j] * in[j]``, replicating aten upsample weights."""

    if mode in ("nearest", "nearest-exact"):
        w = np.zeros((out_size, in_size), dtype=np.float32)
        scale = in_size / out_size
        i = np.arange(out_size)
        if mode == "nearest":
            # aten nearest_neighbor_compute_source_index: floor(i * scale)
            src = np.floor(i * scale).astype(np.int64)
        else:
            src = np.floor((i + 0.5) * scale).astype(np.int64)
        src = np.clip(src, 0, in_size - 1)
        w[i, src] = 1.0
        return w

    if mode == "area":
        # aten adaptive_avg_pool semantics: integer window
        # [floor(i*in/out), ceil((i+1)*in/out)), equal weights.
        w = np.zeros((out_size, in_size), dtype=np.float32)
        for i in range(out_size):
            j0 = (i * in_size) // out_size
            j1 = -((-(i + 1) * in_size) // out_size)  # ceil div
            w[i, j0:j1] = 1.0 / (j1 - j0)
        return w

    if mode in ("bicubic", "cubic"):
        cubic_a = -0.5 if antialias else -0.75
        filt, support = (lambda x: _cubic_filter(x, cubic_a)), 2.0
    elif mode in _FILTERS:
        filt, support = _FILTERS[mode]
    else:
        raise ValueError(f"unsupported interpolation mode {mode!r}")

    w = np.zeros((out_size, in_size), dtype=np.float64)
    if align_corners:
        scale = (in_size - 1) / (out_size - 1) if out_size > 1 else 0.0
        centers = np.arange(out_size) * scale
    else:
        scale = in_size / out_size
        centers = (np.arange(out_size) + 0.5) * scale - 0.5

    if antialias and not align_corners:
        # aten _compute_weights_aa (UpSampleKernel.cpp): with
        # center = scale * (i + 0.5), window
        # [int(center - support + 0.5), int(center + support + 0.5)),
        # weight_j = filter((j - center + 0.5) * invscale),
        # normalized to sum 1 over the clipped window.
        if scale > 1.0:
            supp, inv = support * scale, 1.0 / scale
        else:
            supp, inv = support, 1.0
        for i in range(out_size):
            center = scale * (i + 0.5)  # == centers[i] + 0.5
            xmin = max(int(center - supp + 0.5), 0)
            xmax = min(int(center + supp + 0.5), in_size)
            j = np.arange(xmin, xmax)
            wj = filt((j - center + 0.5) * inv)
            total = wj.sum()
            if total > 0:
                w[i, j] = wj / total
    else:
        # Exact interpolation path: sample the filter at integer offsets
        # around the center; out-of-range taps clamp to the edge pixel
        # (aten clamps source indices), which we express by accumulating
        # the clipped tap's weight onto the edge column.
        n_taps = int(2 * support)
        for i in range(out_size):
            c = centers[i]
            j0 = int(np.floor(c)) - n_taps // 2 + 1
            for t in range(n_taps):
                j = j0 + t
                wj = filt(c - j)
                if wj == 0.0:
                    continue
                jc = min(max(j, 0), in_size - 1)
                w[i, jc] += wj
        # triangle/cubic integer-offset weights already sum to 1

    return w.astype(np.float32)


@functools.lru_cache(maxsize=128)
def _device_matrix(in_size: int, out_size: int, mode: str, antialias: bool,
                   align_corners: bool, device: torch.device) -> torch.Tensor:
    # the cached matrix outlives the mode it was made in: it is never an
    # inference tensor, so that a later product under autograd (the
    # keypoint predictor's upsample in training) may save it
    matrix = resample_matrix(in_size, out_size, mode, antialias,
                             align_corners)
    with torch.inference_mode(False):
        host = torch.from_numpy(matrix)
        if device.type == "cuda":  # through pinned memory: no host wait
            return host.pin_memory().to(device, non_blocking=True)
        return host.to(device)


def resize_plane(
    x: torch.Tensor,
    out_size: int,
    axis: int,
    mode: str = "bilinear",
    antialias: bool = True,
    align_corners: bool = False,
) -> torch.Tensor:
    """Resample f32 ``x`` along ``axis`` to ``out_size`` by one product."""
    in_size = x.shape[axis]
    if in_size == out_size and mode != "area":
        return x
    w = _device_matrix(in_size, out_size, mode, antialias, align_corners,
                       x.device)
    out = torch.matmul(x.movedim(axis, -1), w.t())
    return out.movedim(-1, axis)


def resize_2d(
    image: torch.Tensor,
    size: Tuple[int, int],
    mode: str = "bilinear",
    antialias: bool = True,
    align_corners: bool = False,
) -> torch.Tensor:
    """Resize ``(..., H, W)`` to ``size = (H', W')``: H first, then W, in
    f32. An integer image comes back in its type, rounded half to even and
    clamped to the type's range."""
    out_h, out_w = size
    orig_dtype = image.dtype
    x = image.float()
    x = resize_plane(x, out_h, axis=-2, mode=mode, antialias=antialias,
                     align_corners=align_corners)
    x = resize_plane(x, out_w, axis=-1, mode=mode, antialias=antialias,
                     align_corners=align_corners)
    if not orig_dtype.is_floating_point:
        info = torch.iinfo(orig_dtype)
        x = torch.round(x).clamp(info.min, info.max)
    return x.to(orig_dtype)
