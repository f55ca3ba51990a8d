"""RoIPool, NCHW (counterpart of ``vision_tpu/ops/roi_pool.py``): the max
over each bin of integer-rounded RoI bounds (``round(x * scale)``, size
``max(end - start + 1, 1)``, bin edges ``floor`` / ``ceil`` clipped to the
map), 0 for an empty bin.

A torch composite (the JAX package has no Pallas kernel here): each bin's
window of the channels-last map is gathered at the largest bin's size,
positions outside the bin read a -inf border pixel, and ``amax`` reduces
it. Sizing the window reads the largest bin's extent to the host: one
synchronisation a call. The gradient comes through autograd (ties share
it evenly, as JAX's masked max shares it). It computes in f32 and returns
the input's type."""

from __future__ import annotations

import torch
import torch.nn.functional as F

from vision_tpu_torch.ops.roi_align import _pair, _Size

__all__ = ["roi_pool"]


def divide(a: torch.Tensor, n) -> torch.Tensor:
    """``a / n`` rounded once, as the CPU and JAX divide: on the card
    PyTorch multiplies by the reciprocal of a Python number, an ulp away,
    which moves a bin's ``floor`` / ``ceil`` edge or a sample."""
    return a / torch.full((), n, dtype=a.dtype, device=a.device)


def int_bins(rois: torch.Tensor, spatial_scale: float, ph_n: int, pw_n: int,
             height: int, width: int, plus_one: bool, clip_h: int,
             clip_w: int):
    """The integer bins of RoIPool (``plus_one``: size ``end - start + 1``)
    and PSRoIPool (size ``end - start``): ``(hstart, hend) [K, PH]`` and
    ``(wstart, wend) [K, PW]``, clipped to ``[0, clip_h]`` and ``[0,
    clip_w]``, in the JAX functions' f32 arithmetic."""
    start_w = torch.round(rois[:, 1] * spatial_scale).int()
    start_h = torch.round(rois[:, 2] * spatial_scale).int()
    end_w = torch.round(rois[:, 3] * spatial_scale).int()
    end_h = torch.round(rois[:, 4] * spatial_scale).int()
    extra = 1 if plus_one else 0
    roi_w = (end_w - start_w + extra).clamp(min=1).float()
    roi_h = (end_h - start_h + extra).clamp(min=1).float()
    bin_h, bin_w = divide(roi_h, ph_n), divide(roi_w, pw_n)

    def edges(n, bin_size, start, clip):
        i = torch.arange(n, dtype=torch.float32, device=rois.device)[None]
        lo = torch.floor(i * bin_size[:, None]).int() + start[:, None]
        hi = torch.ceil((i + 1) * bin_size[:, None]).int() + start[:, None]
        return lo.clamp(0, clip), hi.clamp(0, clip)

    return (*edges(ph_n, bin_h, start_h, clip_h),
            *edges(pw_n, bin_w, start_w, clip_w))


def window_index(hstart, hend, wstart, wend, height: int, width: int):
    """Each bin's rows ``[K, PH, bh]`` and columns ``[K, PW, bw]`` at the
    largest bin's extent (read to the host), those outside the bin set to
    ``height`` / ``width``: the border pixel the callers pad with."""
    bh, bw = torch.stack([(hend - hstart).amax(), (wend - wstart).amax()]
                         ).clamp(min=1).tolist()
    rows = hstart[..., None] + torch.arange(bh, device=hstart.device)
    cols = wstart[..., None] + torch.arange(bw, device=wstart.device)
    rows = torch.where(rows < hend[..., None], rows, height)
    cols = torch.where(cols < wend[..., None], cols, width)
    return rows.long(), cols.long()


def roi_pool(input: torch.Tensor, boxes: torch.Tensor, output_size: _Size,
             spatial_scale: float = 1.0) -> torch.Tensor:
    """RoIPool: ``input [N, C, H, W]``, ``boxes [K, 5]`` (batch index, x1,
    y1, x2, y2) -> ``[K, C, PH, PW]``."""
    ph_n, pw_n = _pair(output_size)
    _, _, height, width = input.shape
    rois = boxes.float()
    batch = rois[:, 0].long()
    hstart, hend, wstart, wend = int_bins(rois, spatial_scale, ph_n, pw_n,
                                          height, width, True, height, width)
    rows, cols = window_index(hstart, hend, wstart, wend, height, width)
    # channels-last, with a -inf border row and column
    x = F.pad(input.float().permute(0, 2, 3, 1), (0, 0, 0, 1, 0, 1),
              value=float("-inf"))
    win = x[batch[:, None, None, None, None], rows[:, :, None, :, None],
            cols[:, None, :, None, :]]  # [K, PH, PW, bh, bw, C]
    val = win.amax((3, 4))
    empty = (hend <= hstart)[:, :, None] | (wend <= wstart)[:, None, :]
    val = torch.where(empty[..., None], 0.0, val)
    return val.permute(0, 3, 1, 2).to(input.dtype)
