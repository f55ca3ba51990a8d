"""Position-sensitive RoIPool (R-FCN), NCHW (counterpart of
``vision_tpu/ops/ps_roi_pool.py``): output channel ``c`` at bin ``(ph,
pw)`` averages input channel ``(c * PH + ph) * PW + pw`` over the bin;
integer-rounded RoI bounds, size ``max(end - start, 1)``, bin edges
clipped to ``size - 1``, 0 for an empty bin.

A torch composite (no Pallas kernel in the JAX package): each bin's window
is gathered at the largest bin's size from the channels-last map of its
own channels, positions outside the bin read a zero border pixel, and the
window is summed. Sizing the window reads the largest bin's extent to the
host: one synchronisation a call. The gradient comes through autograd. It
computes in f32 and returns the input's type."""

from __future__ import annotations

import torch
import torch.nn.functional as F

from vision_tpu_torch.ops.roi_align import _pair, _Size
from vision_tpu_torch.ops.roi_pool import int_bins, window_index

__all__ = ["ps_roi_pool", "position_sensitive"]


def position_sensitive(input: torch.Tensor, ph_n: int, pw_n: int
                       ) -> torch.Tensor:
    """``input [N, C_out * PH * PW, H, W]`` as f32 ``[N, PH, PW, H, W,
    C_out]``: bin ``(ph, pw)``'s channels, channels last."""
    n, channels, height, width = input.shape
    if channels % (ph_n * pw_n) != 0:
        raise ValueError(f"input channels {channels} not divisible by "
                         f"{ph_n}*{pw_n}")
    c_out = channels // (ph_n * pw_n)
    return input.float().view(n, c_out, ph_n, pw_n, height, width).permute(
        0, 2, 3, 4, 5, 1)


def ps_roi_pool(input: torch.Tensor, boxes: torch.Tensor, output_size: _Size,
                spatial_scale: float = 1.0) -> torch.Tensor:
    """PSRoIPool: ``input [N, C_out * PH * PW, H, W]``, ``boxes [K, 5]`` ->
    ``[K, C_out, PH, PW]``."""
    ph_n, pw_n = _pair(output_size)
    height, width = input.shape[-2:]
    x = position_sensitive(input, ph_n, pw_n)
    rois = boxes.float()
    batch = rois[:, 0].long()
    hstart, hend, wstart, wend = int_bins(rois, spatial_scale, ph_n, pw_n,
                                          height, width, False, height - 1,
                                          width - 1)
    rows, cols = window_index(hstart, hend, wstart, wend, height, width)
    x = F.pad(x, (0, 0, 0, 1, 0, 1))  # a zero border row and column
    ph = torch.arange(ph_n, device=input.device)[None, :, None, None, None]
    pw = torch.arange(pw_n, device=input.device)[None, None, :, None, None]
    win = x[batch[:, None, None, None, None], ph, pw,
            rows[:, :, None, :, None], cols[:, None, :, None, :]]
    total = win.sum((3, 4))  # [K, PH, PW, C_out]
    area = ((hend - hstart)[:, :, None] * (wend - wstart)[:, None, :]).float()
    empty = (hend <= hstart)[:, :, None] | (wend <= wstart)[:, None, :]
    val = torch.where(empty[..., None], 0.0,
                      total / area.clamp(min=1.0)[..., None])
    return val.permute(0, 3, 1, 2).to(input.dtype)
