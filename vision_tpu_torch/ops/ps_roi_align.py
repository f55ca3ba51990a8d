"""Position-sensitive RoIAlign (R-FCN), NCHW (counterpart of
``vision_tpu/ops/ps_roi_align.py``): output channel ``c`` at bin ``(ph,
pw)`` averages bilinear samples of input channel ``(c * PH + ph) * PW +
pw``. Always aligned (-0.5), the RoI size not clamped to 1, samples outside
``[-1, size]`` give 0 (the roi_align family's edge rules), a grid of
``sampling_ratio`` squared samples a bin, or with ``sampling_ratio <= 0``
each RoI's own ``ceil(roi / bins)`` grid.

A torch composite (no Pallas kernel in the JAX package): the four corners
of every sample are gathered from the channels-last map of each bin's
channels and weighted. The JAX function pads the adaptive grid to the
whole map (``H x W`` samples a bin) and masks it; here it is sized by the
largest RoI's grid (at most ``H x W``, the same result), which reads that
grid to the host: one synchronisation a call with ``sampling_ratio <= 0``,
none with a fixed ratio. The gradient comes through autograd; only the
output is returned. It computes in f32 and returns the input's type."""

from __future__ import annotations

import torch

from vision_tpu_torch.ops.ps_roi_pool import position_sensitive
from vision_tpu_torch.ops.roi_align import _pair, _Size
from vision_tpu_torch.ops.roi_pool import divide

__all__ = ["ps_roi_align"]


def _axis(start, bin_size, grid, n_bins: int, n_samples: int, size: int):
    """One axis of the samples: the low and high corner indices and their
    weights ``[K, bins, samples]``, and the samples' validity (inside
    ``[-1, size]`` and on the RoI's grid)."""
    i = torch.arange(n_bins, dtype=torch.float32, device=start.device)
    s = torch.arange(n_samples, dtype=torch.float32, device=start.device)
    first = i[None, :] * bin_size[:, None] + start[:, None]  # [K, bins]
    c = first[:, :, None] + (s + 0.5)[None, None, :] * (
        bin_size / grid)[:, None, None]
    valid = (c >= -1.0) & (c <= size) & (s[None, None, :] < grid[:, None, None])
    c = c.clamp(min=0.0)
    low = c.int()
    edge = low >= size - 1
    high = torch.where(edge, size - 1, low + 1)
    low = low.clamp(max=size - 1)
    c = torch.where(edge, low.float(), c)
    frac = c - low
    return low.long(), high.long(), 1.0 - frac, frac, valid


def ps_roi_align(input: torch.Tensor, boxes: torch.Tensor, output_size: _Size,
                 spatial_scale: float = 1.0, sampling_ratio: int = -1
                 ) -> torch.Tensor:
    """PSRoIAlign: ``input [N, C_out * PH * PW, H, W]``, ``boxes [K, 5]``
    (batch index, x1, y1, x2, y2) -> ``[K, C_out, PH, PW]``."""
    ph_n, pw_n = _pair(output_size)
    height, width = input.shape[-2:]
    x = position_sensitive(input, ph_n, pw_n)  # [N, PH, PW, H, W, C_out]
    rois = boxes.float()
    k = rois.shape[0]
    batch = rois[:, 0].long()
    start_w = rois[:, 1] * spatial_scale - 0.5
    start_h = rois[:, 2] * spatial_scale - 0.5
    end_w = rois[:, 3] * spatial_scale - 0.5
    end_h = rois[:, 4] * spatial_scale - 0.5
    roi_w, roi_h = end_w - start_w, end_h - start_h
    bin_h, bin_w = divide(roi_h, ph_n), divide(roi_w, pw_n)
    if sampling_ratio > 0:
        grid_h = torch.full((k,), float(sampling_ratio), device=rois.device)
        grid_w = grid_h
        n_iy = n_ix = sampling_ratio
    else:
        grid_h, grid_w = torch.ceil(bin_h), torch.ceil(bin_w)
        # the largest RoI's grid, at most the map (the JAX grid's extent)
        n_iy, n_ix = (torch.stack([grid_h.amax(), grid_w.amax()]).clamp(min=1)
                      .int().tolist() if k else (1, 1))
        n_iy, n_ix = min(n_iy, height), min(n_ix, width)
    count = grid_h * grid_w
    y_lo, y_hi, y_wlo, y_whi, y_ok = _axis(start_h, bin_h, grid_h, ph_n, n_iy,
                                           height)
    x_lo, x_hi, x_wlo, x_whi, x_ok = _axis(start_w, bin_w, grid_w, pw_n, n_ix,
                                           width)
    b = batch[:, None, None, None, None]
    ph = torch.arange(ph_n, device=input.device)[None, :, None, None, None]
    pw = torch.arange(pw_n, device=input.device)[None, None, :, None, None]

    def ys(t):  # [K, PH, IY] -> [K, PH, 1, IY, 1]
        return t[:, :, None, :, None]

    def xs(t):  # [K, PW, IX] -> [K, 1, PW, 1, IX]
        return t[:, None, :, None, :]

    acc = None
    for yi, wy in ((y_lo, y_wlo), (y_hi, y_whi)):
        for xi, wx in ((x_lo, x_wlo), (x_hi, x_whi)):
            term = (ys(wy) * xs(wx))[..., None] * x[b, ph, pw, ys(yi), xs(xi)]
            acc = term if acc is None else acc + term
    ok = (ys(y_ok) & xs(x_ok)).float()[..., None]
    val = (acc * ok).sum((3, 4)) / count[:, None, None, None]
    return val.permute(0, 3, 1, 2).to(input.dtype)
