"""RoIAlign forward, NCHW (counterpart of ``vision_tpu/ops/roi_align.py``).

:func:`roi_align` runs the CUDA kernel ``csrc/roi_align.cu`` for tensors
on the card and the plain PyTorch version :func:`roi_align_plain` for
tensors on the CPU. Both follow the JAX package's gather path
(``_roi_align_gather``): the reference's CUDA edge rules, ``aligned``
both ways, a fixed ``sampling_ratio > 0`` grid or the adaptive
``ceil(roi / pooled)`` grid for ``sampling_ratio <= 0``. Forward only:
the backward waits for the training path.
"""

from __future__ import annotations

from typing import Tuple, Union

import torch

from vision_tpu_torch import _kernels

__all__ = ["roi_align", "roi_align_cuda", "roi_align_plain"]

_Size = Union[int, Tuple[int, int]]


def _pair(size: _Size) -> Tuple[int, int]:
    return (size, size) if isinstance(size, int) else tuple(size)


def _bilinear_gather(feat, batch_ind, y, x, yvalid, xvalid):
    """feat [N, H, W, C]; y [K, PH, IY], x [K, PW, IX] sample coords with
    their validity masks -> [K, PH, PW, IY, IX, C] weighted corners."""
    _, height, width, _ = feat.shape
    yz = yvalid & (y >= -1.0) & (y <= height)
    xz = xvalid & (x >= -1.0) & (x <= width)
    y = y.clamp(min=0.0)
    x = x.clamp(min=0.0)
    y_low = y.to(torch.int64)
    x_low = x.to(torch.int64)
    y_high = torch.where(y_low >= height - 1, height - 1, y_low + 1)
    y_low = y_low.clamp(max=height - 1)
    y = torch.where(y_low >= height - 1, y_low.to(y.dtype), y)
    x_high = torch.where(x_low >= width - 1, width - 1, x_low + 1)
    x_low = x_low.clamp(max=width - 1)
    x = torch.where(x_low >= width - 1, x_low.to(x.dtype), x)
    ly = y - y_low
    lx = x - x_low
    hy = 1.0 - ly
    hx = 1.0 - lx
    b = batch_ind[:, None, None, None, None]

    def gather(yy, xx):
        return feat[b, yy[:, :, None, :, None], xx[:, None, :, None, :]]

    wy = yz.to(feat.dtype)[:, :, None, :, None]
    wx = xz.to(feat.dtype)[:, None, :, None, :]

    def w(a, c):
        return (a[:, :, None, :, None] * c[:, None, :, None, :] * wy * wx)[
            ..., None
        ]

    return (
        w(hy, hx) * gather(y_low, x_low)
        + w(hy, lx) * gather(y_low, x_high)
        + w(ly, hx) * gather(y_high, x_low)
        + w(ly, lx) * gather(y_high, x_high)
    )


def roi_align_plain(
    input: torch.Tensor,
    boxes: torch.Tensor,
    output_size: _Size,
    spatial_scale: float = 1.0,
    sampling_ratio: int = -1,
    aligned: bool = False,
) -> torch.Tensor:
    """Plain PyTorch RoIAlign: ``input [N, C, H, W]``, ``boxes [K, 5]``
    rows of ``(batch_index, x1, y1, x2, y2)`` -> ``[K, C, PH, PW]``."""
    pooled_h, pooled_w = _pair(output_size)
    _, _, height, width = input.shape
    k = boxes.shape[0]
    orig_dtype = input.dtype
    feat = input.float().permute(0, 2, 3, 1)  # NHWC for the corner gather
    rois = boxes.float()
    dev = rois.device

    batch_ind = rois[:, 0].to(torch.int64)
    offset = 0.5 if aligned else 0.0
    start_w = rois[:, 1] * spatial_scale - offset
    start_h = rois[:, 2] * spatial_scale - offset
    end_w = rois[:, 3] * spatial_scale - offset
    end_h = rois[:, 4] * spatial_scale - offset
    roi_w = end_w - start_w
    roi_h = end_h - start_h
    if not aligned:
        roi_w = roi_w.clamp(min=1.0)
        roi_h = roi_h.clamp(min=1.0)
    bin_h = roi_h / pooled_h
    bin_w = roi_w / pooled_w
    ph = torch.arange(pooled_h, dtype=torch.float32, device=dev)
    pw = torch.arange(pooled_w, dtype=torch.float32, device=dev)

    if sampling_ratio > 0:
        sr = sampling_ratio
        iy = torch.arange(sr, dtype=torch.float32, device=dev)
        ix = iy
        grid_h = torch.full((k,), float(sr), device=dev)
        grid_w = grid_h
        yvalid = torch.ones(k, pooled_h, sr, dtype=torch.bool, device=dev)
        xvalid = torch.ones(k, pooled_w, sr, dtype=torch.bool, device=dev)
        count = torch.full((k, 1, 1, 1), max(float(sr * sr), 1.0), device=dev)
    else:
        # adaptive grid: sample the largest grid any roi needs, mask the rest
        grid_h = torch.ceil(roi_h / pooled_h)
        grid_w = torch.ceil(roi_w / pooled_w)
        gmax_h = max(int(grid_h.max().item()) if k else 0, 1)
        gmax_w = max(int(grid_w.max().item()) if k else 0, 1)
        iy = torch.arange(gmax_h, dtype=torch.float32, device=dev)
        ix = torch.arange(gmax_w, dtype=torch.float32, device=dev)
        yvalid = (iy[None, :] < grid_h[:, None])[:, None, :].expand(
            k, pooled_h, gmax_h)
        xvalid = (ix[None, :] < grid_w[:, None])[:, None, :].expand(
            k, pooled_w, gmax_w)
        count = (grid_h * grid_w).clamp(min=1.0)[:, None, None, None]

    y = (
        start_h[:, None, None]
        + ph[None, :, None] * bin_h[:, None, None]
        + (iy[None, None, :] + 0.5) * (bin_h / grid_h)[:, None, None]
    )
    x = (
        start_w[:, None, None]
        + pw[None, :, None] * bin_w[:, None, None]
        + (ix[None, None, :] + 0.5) * (bin_w / grid_w)[:, None, None]
    )
    val = _bilinear_gather(feat, batch_ind, y, x, yvalid, xvalid)
    out = val.sum(dim=(3, 4)) / count  # [K, PH, PW, C]
    return out.permute(0, 3, 1, 2).contiguous().to(orig_dtype)


@_kernels.counted
def roi_align_cuda(
    input: torch.Tensor,
    boxes: torch.Tensor,
    output_size: _Size,
    spatial_scale: float = 1.0,
    sampling_ratio: int = -1,
    aligned: bool = False,
) -> torch.Tensor:
    """The kernel of ``csrc/roi_align.cu`` (same contract as
    :func:`roi_align_plain`; f32 only; batch indices in ``[0, N)``)."""
    if input.device.type != "cuda" or boxes.device != input.device:
        raise ValueError("roi_align_cuda takes CUDA tensors")
    if input.dtype != torch.float32 or boxes.dtype != torch.float32:
        raise ValueError("roi_align_cuda takes f32 input and boxes")
    if input.dim() != 4 or boxes.dim() != 2 or boxes.shape[1] != 5:
        raise ValueError("input must be [N, C, H, W] and boxes [K, 5]")
    pooled_h, pooled_w = _pair(output_size)
    n, c, h, w = input.shape
    k = boxes.shape[0]
    input = input.contiguous()
    boxes = boxes.contiguous()
    out = torch.empty(k, c, pooled_h, pooled_w, device=input.device)
    lib = _kernels.load("roi_align")
    _kernels.check(
        lib.vt_roi_align_forward(
            input.data_ptr(), boxes.data_ptr(), out.data_ptr(), n, c, h, w, k,
            pooled_h, pooled_w, float(spatial_scale), int(sampling_ratio),
            int(bool(aligned)), _kernels.stream_handle(input),
        ),
        "roi_align kernel",
    )
    return out


def roi_align(
    input: torch.Tensor,
    boxes: torch.Tensor,
    output_size: _Size,
    spatial_scale: float = 1.0,
    sampling_ratio: int = -1,
    aligned: bool = False,
) -> torch.Tensor:
    """RoIAlign forward (``torchvision.ops.roi_align``'s contract):
    ``input [N, C, H, W]``, ``boxes [K, 5]`` -> ``[K, C, PH, PW]``. The
    CUDA kernel for CUDA tensors, the plain version for CPU tensors."""
    if input.device.type == "cpu":
        return roi_align_plain(input, boxes, output_size, spatial_scale,
                               sampling_ratio, aligned)
    return roi_align_cuda(input, boxes, output_size, spatial_scale,
                          sampling_ratio, aligned)
