"""Multi-scale RoIAlign with FPN level assignment (counterpart of
``vision_tpu/ops/poolers.py``).

Two formulations with the same result:

* ``"dense"``: :func:`~vision_tpu_torch.ops.roi_align.roi_align` of every
  RoI against every level, then a masked sum that keeps each RoI's
  assigned level.
* ``"window"`` (the default): the FPN level rule makes each RoI span
  about 14 px at its level, so its samples lie in a small window. The
  levels are stacked along H into one channels-last pyramid
  ``[R, WMAX, C]``, and each RoI contracts its ``win x win`` window with
  local separable bilinear weights (:func:`window_pool`, the CUDA kernel
  ``csrc/window_pool.cu`` on the card, which checks each window's bounds
  itself). RoIs whose samples leave the
  window are found exactly and recomputed by the dense path at a fixed
  capacity of ``min(overflow_capacity, K)`` rows, which runs on every
  call.

Both are differentiable in the features (f32 or bf16; a bf16 gradient is
its f32 sum rounded once): the window pool through
:class:`_WindowPool`, whose backward pass is the kernel
``csrc/window_pool_backward.cu`` on the card (deterministic: no atomics)
and :func:`window_pool_backward_plain` on the CPU; the dense path through
``roi_align``'s. The pyramid is built by copies into a zero tensor and
the overflow rows are patched in place, and autograd takes both back to
each level.

The sampling rules live in the weights, computed here in PyTorch exactly
as the JAX package computes them (``poolers.py:176-267``). The port keeps
exact window origins: the 8-row alignment and the ``win + 8`` widening
were for the TPU's DMA engine.

Types: f32 or bf16 features (the amp path); the weights, the RoIs and the
sums stay f32, and the pooled output has the features' type. In bf16 the
window pool rounds as the JAX package does (``poolers.py:62,273``): the
f32 sum to bf16, then divided by ``sr**2`` in f32 and rounded again.
"""

from __future__ import annotations

import itertools
import math
from typing import Dict, List, Optional, Sequence, Tuple, Union

import torch
from torch import nn

from vision_tpu_torch import _kernels
from vision_tpu_torch.ops._topk import top_k
from vision_tpu_torch.ops.roi_align import KERNEL_DTYPES, roi_align

__all__ = [
    "LevelMapper",
    "MultiScaleRoIAlign",
    "window_pool",
    "window_pool_backward_cuda",
    "window_pool_backward_plain",
    "window_pool_cuda",
    "window_pool_plain",
]


def window_pool_plain(
    stacked: torch.Tensor,
    row0: torch.Tensor,
    x0: torch.Tensor,
    w_y: torch.Tensor,
    w_x: torch.Tensor,
    div: float = 1.0,
) -> torch.Tensor:
    """Plain PyTorch window pool.

    ``stacked [R, WMAX, C]`` channels-last pyramid, ``row0``/``x0 [K]``
    window origins, ``w_y [K, PH, winy]``, ``w_x [K, PW, winx]`` ->
    ``out [K, C, PH, PW] = sum_yx w_y w_x stacked[row0+y, x0+x] / div``,
    the sum in f32 (f64 for an f64 pyramid) rounded to ``stacked``'s type
    before the division.
    """
    acc = torch.promote_types(stacked.dtype, torch.float32)
    winy = w_y.shape[2]
    winx = w_x.shape[2]
    ys = row0.long()[:, None] + torch.arange(winy, device=stacked.device)
    xs = x0.long()[:, None] + torch.arange(winx, device=stacked.device)
    windows = stacked[ys[:, :, None], xs[:, None, :]].to(acc)  # [K, y, x, C]
    rows = torch.einsum("kpy,kyxc->kpxc", w_y.to(acc), windows)
    out = torch.einsum("kqx,kpxc->kcpq", w_x.to(acc), rows)
    return (out.to(stacked.dtype).to(acc) / div).to(stacked.dtype)


def window_pool_backward_plain(
    grad: torch.Tensor,
    row0: torch.Tensor,
    x0: torch.Tensor,
    w_y: torch.Tensor,
    w_x: torch.Tensor,
    size: Tuple[int, int],
    div: float = 1.0,
) -> torch.Tensor:
    """Plain PyTorch window-pool backward in the pyramid: ``grad [K, C, PH,
    PW]`` of the output -> the gradient ``[R, WMAX, C]`` of a pyramid of
    ``size = (R, WMAX)``, in f32 (f64 for an f64 ``grad``): each RoI's
    window gradient ``w_y^T (w_x g / div)`` scatter-added at its window."""
    acc = torch.promote_types(grad.dtype, torch.float32)
    k, c = grad.shape[:2]
    winy = w_y.shape[2]
    winx = w_x.shape[2]
    g = grad.to(acc) / div
    rows = torch.einsum("kqx,kcpq->kpxc", w_x.to(acc), g)
    win = torch.einsum("kpy,kpxc->kyxc", w_y.to(acc), rows)  # [K, y, x, C]
    ys = row0.long()[:, None] + torch.arange(winy, device=grad.device)
    xs = x0.long()[:, None] + torch.arange(winx, device=grad.device)
    out = torch.zeros(*size, c, dtype=acc, device=grad.device)
    out.index_put_((ys[:, :, None].expand(k, winy, winx),
                    xs[:, None, :].expand(k, winy, winx)), win,
                   accumulate=True)
    return out


def _check_windows(stacked, row0, x0, winy, winx) -> None:
    r_rows, wmax, _ = stacked.shape
    bad = (
        (row0 < 0) | (row0 + winy > r_rows) | (x0 < 0) | (x0 + winx > wmax)
    ).any()
    if bool(bad):
        raise ValueError(
            f"window_pool: a window leaves the pyramid (row0 + {winy} must "
            f"be <= {r_rows} and x0 + {winx} <= {wmax})"
        )


@_kernels.counted
def window_pool_cuda(
    stacked: torch.Tensor,
    row0: torch.Tensor,
    x0: torch.Tensor,
    w_y: torch.Tensor,
    w_x: torch.Tensor,
    div: float = 1.0,
) -> torch.Tensor:
    """The forward kernel of ``csrc/window_pool.cu`` (same contract as
    :func:`window_pool_plain`; an f32 or bf16 pyramid, f32 weights, any C,
    ``PH, PW <= 16``); :func:`window_pool` differentiates it through
    :func:`window_pool_backward_cuda`.

    It makes no host synchronisation. The kernel checks on the card that
    each window lies inside ``stacked``; a window that does not stops the
    launch, so the error surfaces at the next synchronisation (as a CUDA
    error, after which the CUDA context is unusable), not at this call."""
    if stacked.dtype not in KERNEL_DTYPES or w_y.dtype != torch.float32 or (
        w_x.dtype != torch.float32
    ):
        raise ValueError("window_pool_cuda takes an f32 or bf16 pyramid and "
                         f"f32 weights, got {stacked.dtype}, {w_y.dtype}, "
                         f"{w_x.dtype}")
    tensors = (stacked, row0, x0, w_y, w_x)
    if any(t.device != stacked.device for t in tensors) or (
        stacked.device.type != "cuda"
    ):
        raise ValueError("window_pool_cuda takes CUDA tensors on one device")
    k, ph, winy = w_y.shape
    _, pw, winx = w_x.shape
    if ph > 16 or pw > 16:
        raise ValueError(f"window_pool_cuda takes PH, PW <= 16, got {ph}, {pw}")
    r_rows, wmax, c = stacked.shape
    row0 = row0.to(torch.int32).contiguous()
    x0 = x0.to(torch.int32).contiguous()
    stacked = stacked.contiguous()
    w_y = w_y.contiguous()
    w_x = w_x.contiguous()
    out = torch.empty(k, c, ph, pw, dtype=stacked.dtype, device=stacked.device)
    lib = _kernels.load("window_pool")
    _kernels.check(
        lib.vt_window_pool(
            stacked.data_ptr(), row0.data_ptr(), x0.data_ptr(),
            w_y.data_ptr(), w_x.data_ptr(), out.data_ptr(), r_rows, wmax, c,
            k, ph, pw, winy, winx, float(div),
            int(stacked.dtype == torch.bfloat16),
            _kernels.stream_handle(stacked),
        ),
        "window_pool kernel",
    )
    return out


@_kernels.counted
def window_pool_backward_cuda(
    grad: torch.Tensor,
    row0: torch.Tensor,
    x0: torch.Tensor,
    w_y: torch.Tensor,
    w_x: torch.Tensor,
    size: Tuple[int, int],
    div: float = 1.0,
) -> torch.Tensor:
    """The kernel of ``csrc/window_pool_backward.cu`` (same contract as
    :func:`window_pool_backward_plain`; an f32 or bf16 ``grad``, f32
    weights, ``PH, PW <= 16``). The gradient has ``grad``'s type: in bf16
    the f32 sum rounded once, as the plain version followed by a cast to
    bf16 rounds it. Every call on the same inputs gives the same bits: each
    element is summed by one thread over the RoIs in the order of a stable
    sort of ``row0``, with no atomics.

    It makes no host synchronisation: the RoIs are sorted on the card, and
    the kernel checks each window's bounds there, as the forward does (the
    error surfaces at the next synchronisation)."""
    if grad.dtype not in KERNEL_DTYPES or w_y.dtype != torch.float32 or (
        w_x.dtype != torch.float32
    ):
        raise ValueError("window_pool_backward_cuda takes an f32 or bf16 grad "
                         f"and f32 weights, got {grad.dtype}, {w_y.dtype}, "
                         f"{w_x.dtype}")
    tensors = (grad, row0, x0, w_y, w_x)
    if any(t.device != grad.device for t in tensors) or (
        grad.device.type != "cuda"
    ):
        raise ValueError("window_pool_backward_cuda takes CUDA tensors on one "
                         "device")
    k, c, ph, pw = grad.shape
    winy = w_y.shape[2]
    winx = w_x.shape[2]
    if ph > 16 or pw > 16:
        raise ValueError(f"window_pool_backward_cuda takes PH, PW <= 16, got "
                         f"{ph}, {pw}")
    if tuple(w_y.shape) != (k, ph, winy) or tuple(w_x.shape[:2]) != (k, pw):
        raise ValueError(f"w_y {tuple(w_y.shape)} and w_x {tuple(w_x.shape)} "
                         f"do not fit grad {tuple(grad.shape)}")
    r_rows, wmax = size
    row0 = row0.to(torch.int32).contiguous()
    x0 = x0.to(torch.int32).contiguous()
    sorted_row0, order = torch.sort(row0, stable=True)
    order = order.to(torch.int32)
    grad = grad.contiguous()
    w_y = w_y.contiguous()
    w_x = w_x.contiguous()
    out = torch.empty(r_rows, wmax, c, dtype=grad.dtype, device=grad.device)
    lib = _kernels.load("window_pool_backward")
    scratch = torch.empty(lib.vt_window_pool_backward_scratch(k, r_rows),
                          dtype=torch.int32, device=grad.device)
    _kernels.check(
        lib.vt_window_pool_backward(
            grad.data_ptr(), sorted_row0.data_ptr(), order.data_ptr(),
            row0.data_ptr(), x0.data_ptr(), w_y.data_ptr(), w_x.data_ptr(),
            scratch.data_ptr(), out.data_ptr(), r_rows, wmax, c, k, ph, pw,
            winy, winx, float(div), int(grad.dtype == torch.bfloat16),
            _kernels.stream_handle(grad),
        ),
        "window_pool_backward kernel",
    )
    return out


def _window_pool_forward(stacked, row0, x0, w_y, w_x, div):
    if stacked.device.type == "cpu":
        _check_windows(stacked, row0, x0, w_y.shape[2], w_x.shape[2])
        return window_pool_plain(stacked, row0, x0, w_y, w_x, div)
    return window_pool_cuda(stacked, row0, x0, w_y, w_x, div)


class _WindowPool(torch.autograd.Function):
    """The window pool with the backward pass in the pyramid; saves the
    origins and the weights. Their own gradient is not computed: the
    backward pass raises where ``w_y`` or ``w_x`` needs one (on the Faster
    R-CNN path they come from proposals that carry no gradient)."""

    @staticmethod
    def forward(ctx, stacked, row0, x0, w_y, w_x, div):
        ctx.save_for_backward(row0, x0, w_y, w_x)
        ctx.size = tuple(stacked.shape[:2])
        ctx.div = div
        ctx.dtype = stacked.dtype
        return _window_pool_forward(stacked, row0, x0, w_y, w_x, div)

    @staticmethod
    def backward(ctx, grad):
        if ctx.needs_input_grad[3] or ctx.needs_input_grad[4]:
            raise NotImplementedError(
                "window_pool computes no gradient for w_y or w_x")
        row0, x0, w_y, w_x = ctx.saved_tensors
        gs = None
        if ctx.needs_input_grad[0]:
            backward = (window_pool_backward_plain if grad.device.type == "cpu"
                        else window_pool_backward_cuda)
            gs = backward(grad, row0, x0, w_y, w_x, ctx.size,
                          ctx.div).to(ctx.dtype)
        return gs, None, None, None, None, None


def window_pool(stacked, row0, x0, w_y, w_x, div: float = 1.0) -> torch.Tensor:
    """The CUDA kernels for CUDA tensors, the plain versions for CPU
    tensors. Differentiable in ``stacked``; where no gradient is wanted,
    nothing is saved for one."""
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (stacked, w_y, w_x)):
        return _WindowPool.apply(stacked, row0, x0, w_y, w_x, div)
    return _window_pool_forward(stacked, row0, x0, w_y, w_x, div)


class LevelMapper:
    """FPN-paper rule mapping box area to a pyramid level."""

    def __init__(
        self,
        k_min: int,
        k_max: int,
        canonical_scale: int = 224,
        canonical_level: int = 4,
        eps: float = 1e-6,
    ):
        self.k_min = k_min
        self.k_max = k_max
        self.s0 = canonical_scale
        self.lvl0 = canonical_level
        self.eps = eps

    def __call__(self, boxes: torch.Tensor) -> torch.Tensor:
        """boxes [K, 4] xyxy -> int64 level index in [0, k_max - k_min]."""
        s = torch.sqrt(
            (boxes[:, 2] - boxes[:, 0]) * (boxes[:, 3] - boxes[:, 1])
        )
        lvl = torch.floor(self.lvl0 + torch.log2(s / self.s0) + self.eps)
        lvl = lvl.clamp(self.k_min, self.k_max)
        return (lvl - self.k_min).to(torch.int64)


def _local_weights(coord, size_k, origin, width):
    """[K, P, SR] sample coords -> ([K, P, width] bilinear weights local to
    a window starting at ``origin`` [K], [K] overflow flag). ``size_k``
    [K] is the level extent. Samples outside [-1, size] weigh 0; corners
    clamp to size-1."""
    size = size_k[:, None, None]
    zmask = (coord >= -1.0) & (coord <= size.float())
    cc = coord.clamp(min=0.0)
    lo = cc.to(torch.int64)
    hi = torch.where(lo >= size - 1, size - 1, lo + 1)
    lo = torch.minimum(lo, size - 1)
    cc = torch.where(lo >= size - 1, lo.to(cc.dtype), cc)
    frac = cc - lo
    w_lo = torch.where(zmask, 1.0 - frac, torch.zeros_like(frac))
    w_hi = torch.where(zmask, frac, torch.zeros_like(frac))
    lo_loc = lo - origin[:, None, None]
    hi_loc = hi - origin[:, None, None]
    overflow = hi_loc.amax(dim=(1, 2)) >= width
    slots = torch.arange(width, device=coord.device)
    oh = (lo_loc[..., None] == slots) * w_lo[..., None] + (
        hi_loc[..., None] == slots
    ) * w_hi[..., None]
    return oh.sum(2), overflow


def _windowed_multiscale(
    feats: List[torch.Tensor],
    scales: Sequence[float],
    levels: torch.Tensor,
    rois: torch.Tensor,
    output_size: Tuple[int, int],
    sampling_ratio: int,
    win: int,
    overflow_capacity: int,
    dense_fallback,
) -> torch.Tensor:
    """Windowed single-level pooling: per RoI, exactly
    ``roi_align(feats[level], roi, output_size, scales[level], sr)``
    whenever its bilinear corners fit a ``win``-sized window at its level;
    the others go through ``dense_fallback`` up to the capacity."""
    ph, pw = output_size
    sr = sampling_ratio
    n, c = feats[0].shape[:2]
    heights = [f.shape[2] for f in feats]
    widths = [f.shape[3] for f in feats]
    wmax = max(max(widths), win)
    sumh = sum(heights)
    dev = rois.device

    # channels-last pyramid: per image the levels stacked along H, W padded
    # to wmax, `win` zero rows below so the last window stays in bounds
    stacked = feats[0].new_zeros(n * sumh + win, wmax, c)
    off = 0
    for f, h, w in zip(feats, heights, widths):
        for i in range(n):
            r = i * sumh + off
            stacked[r : r + h, :w].copy_(f[i].permute(1, 2, 0))
        off += h

    row_off = torch.tensor(
        [0, *itertools.accumulate(heights[:-1])], device=dev
    )
    h_tbl = torch.tensor(heights, device=dev)
    w_tbl = torch.tensor(widths, device=dev)
    scale_tbl = torch.tensor(scales, dtype=torch.float32, device=dev)

    rois = rois.float()
    batch_ind = rois[:, 0].to(torch.int64)
    lvl = levels.clamp(0, len(feats) - 1)
    scale_k = scale_tbl[lvl]
    h_k = h_tbl[lvl]
    w_k = w_tbl[lvl]

    start_w = rois[:, 1] * scale_k
    start_h = rois[:, 2] * scale_k
    roi_w = (rois[:, 3] * scale_k - start_w).clamp(min=1.0)
    roi_h = (rois[:, 4] * scale_k - start_h).clamp(min=1.0)
    bin_h = roi_h / ph
    bin_w = roi_w / pw
    ii = torch.arange(sr, dtype=torch.float32, device=dev)
    gp = torch.arange(ph, dtype=torch.float32, device=dev)
    gq = torch.arange(pw, dtype=torch.float32, device=dev)
    y = (
        start_h[:, None, None]
        + gp[None, :, None] * bin_h[:, None, None]
        + (ii[None, None, :] + 0.5) * (bin_h[:, None, None] / sr)
    )  # [K, PH, SR]
    x = (
        start_w[:, None, None]
        + gq[None, :, None] * bin_w[:, None, None]
        + (ii[None, None, :] + 0.5) * (bin_w[:, None, None] / sr)
    )  # [K, PW, SR]

    # window origin: the first corner row/col, clamped so that the window
    # stays inside the level when the level is at least `win` wide
    zero = torch.zeros_like(h_k)
    y0 = torch.minimum(
        y[:, 0, 0].clamp(min=0.0).to(torch.int64),
        torch.maximum(h_k - win, zero),
    )
    x0 = torch.minimum(
        x[:, 0, 0].clamp(min=0.0).to(torch.int64),
        torch.maximum(w_k - win, zero),
    )
    row0 = batch_ind * sumh + row_off[lvl] + y0
    w_y, of_y = _local_weights(y, h_k, y0, win)
    w_x, of_x = _local_weights(x, w_k, x0, win)
    overflow = of_y | of_x

    out = window_pool(stacked, row0, x0, w_y, w_x, div=float(sr * sr))

    if overflow_capacity > 0 and dense_fallback is not None:
        cap = min(overflow_capacity, rois.shape[0])
        _, ov_idx = top_k(overflow.float(), cap)
        ov_real = overflow[ov_idx]
        dense = dense_fallback(rois[ov_idx])  # [cap, C, PH, PW]
        out[ov_idx] = torch.where(
            ov_real[:, None, None, None], dense, out[ov_idx]
        )
    return out


def _infer_scale(feature_size: int, original_size: int) -> float:
    """Snap the size ratio to a power of two."""
    return 2 ** float(round(math.log2(feature_size / original_size)))


class MultiScaleRoIAlign(nn.Module):
    """torchvision's ``MultiScaleRoIAlign`` with fixed-size inputs:
    ``forward(features, rois, image_size)`` with NCHW feature maps, rois
    ``[K, 5]`` (batch index, x1, y1, x2, y2) in image coordinates, and
    the (H, W) of the model input -> ``[K, C, PH, PW]``. No parameters.

    ``backend``: ``"window"`` (default) or ``"dense"``.
    """

    def __init__(
        self,
        featmap_names: Sequence[str],
        output_size: Union[int, Tuple[int, int]],
        sampling_ratio: int,
        *,
        canonical_scale: int = 224,
        canonical_level: int = 4,
        backend: str = "window",
        window: int = 32,
        overflow_capacity: int = 64,
    ):
        super().__init__()
        if backend not in ("window", "dense"):
            raise ValueError(f"unknown MultiScaleRoIAlign backend {backend!r}")
        self.featmap_names = list(featmap_names)
        if isinstance(output_size, int):
            output_size = (output_size, output_size)
        self.output_size = tuple(output_size)
        self.sampling_ratio = sampling_ratio
        self.canonical_scale = canonical_scale
        self.canonical_level = canonical_level
        self.backend = backend
        self.window = window
        self.overflow_capacity = overflow_capacity

    def forward(
        self,
        x: Dict[str, torch.Tensor],
        rois: torch.Tensor,
        image_size: Tuple[int, int],
    ) -> torch.Tensor:
        feats = [x[k] for k in self.featmap_names]
        scales = [_infer_scale(f.shape[2], image_size[0]) for f in feats]
        if len(feats) == 1:
            return roi_align(feats[0], rois, self.output_size, scales[0],
                             self.sampling_ratio)

        mapper = LevelMapper(
            int(-math.log2(scales[0])),
            int(-math.log2(scales[-1])),
            canonical_scale=self.canonical_scale,
            canonical_level=self.canonical_level,
        )

        def dense(sub_rois: torch.Tensor) -> torch.Tensor:
            sub_levels = mapper(sub_rois[:, 1:5])
            out: Optional[torch.Tensor] = None
            for lvl, (feat, scale) in enumerate(zip(feats, scales)):
                pooled = roi_align(feat, sub_rois, self.output_size, scale,
                                   self.sampling_ratio)
                sel = (sub_levels == lvl).to(pooled.dtype)[:, None, None, None]
                out = pooled * sel if out is None else out + pooled * sel
            return out

        if self.backend == "window":
            return _windowed_multiscale(
                feats, scales, mapper(rois[:, 1:5]), rois, self.output_size,
                self.sampling_ratio, self.window, self.overflow_capacity,
                dense,
            )
        return dense(rois)
