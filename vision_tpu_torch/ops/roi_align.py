"""RoIAlign, NCHW (counterpart of ``vision_tpu/ops/roi_align.py``).

:func:`roi_align` runs the CUDA kernel ``csrc/roi_align.cu`` for tensors
on the card and the plain PyTorch version :func:`roi_align_plain` for
tensors on the CPU. Both follow the JAX package's gather path
(``_roi_align_gather``): the reference's CUDA edge rules, ``aligned``
both ways, a fixed ``sampling_ratio > 0`` grid or the adaptive
``ceil(roi / pooled)`` grid for ``sampling_ratio <= 0``.

It is differentiable in ``input`` (f32): the backward pass is the kernel
``csrc/roi_align_backward.cu`` on the card (deterministic: no atomics)
and :func:`roi_align_backward_plain` on the CPU. The gradient of the
boxes is None, as in torchvision (the JAX package returns zeros,
``roi_align.py:431``).

Types: an f32 or a bf16 input, f32 boxes; the output has the input's
type. Sampling weights and sums are f32 in both (the plain version sums an
f64 input in f64, for ``gradcheck``; its sample positions stay f32). A
bf16 result is rounded as the JAX package's Pallas kernel rounds it
(``vision_tpu/ops/_pallas/roi_align.py:104,230``): the f32 sum to bf16,
then divided by the sample count in f32 and rounded again. The JAX gather
path divides first and rounds once; the two agree where the count is a
power of two (``sampling_ratio=2``) and may part by one bf16 step
elsewhere.
"""

from __future__ import annotations

from typing import Tuple, Union

import torch

from vision_tpu_torch import _kernels

__all__ = ["roi_align", "roi_align_backward_cuda", "roi_align_backward_plain",
           "roi_align_cuda", "roi_align_plain"]

# the element types of the kernel's input and output
KERNEL_DTYPES = (torch.float32, torch.bfloat16)

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
    # the fractions are exact in f32; their products are taken in the
    # features' type (exact in f64, where the plain version is a reference)
    ly = (y - y_low).to(feat.dtype)
    lx = (x - x_low).to(feat.dtype)
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
    # sums in f32 (f64 for an f64 input); sample positions in f32 always
    acc = torch.promote_types(orig_dtype, torch.float32)
    feat = input.to(acc).permute(0, 2, 3, 1)  # NHWC for the corner gather
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
    # round the sum to the input's type, then divide (a no-op round in f32)
    out = val.sum(dim=(3, 4)).to(orig_dtype).to(acc) / count  # [K, PH, PW, C]
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
    :func:`roi_align_plain`; an f32 or bf16 input, f32 boxes).

    It makes no host synchronisation. The kernel checks each RoI's batch
    index on the card: one outside ``[0, N)`` stops the launch, so the
    error surfaces at the next synchronisation (as a CUDA error, after
    which the CUDA context is unusable), not at this call."""
    if input.dtype not in KERNEL_DTYPES or boxes.dtype != torch.float32:
        raise ValueError("roi_align_cuda takes an f32 or bf16 input and f32 "
                         f"boxes, got {input.dtype} and {boxes.dtype}")
    if input.device.type != "cuda" or boxes.device != input.device:
        raise ValueError("roi_align_cuda takes CUDA tensors")
    if input.dim() != 4 or boxes.dim() != 2 or boxes.shape[1] != 5:
        raise ValueError("input must be [N, C, H, W] and boxes [K, 5]")
    pooled_h, pooled_w = _pair(output_size)
    n, c, h, w = input.shape
    k = boxes.shape[0]
    input = input.contiguous()
    boxes = boxes.contiguous()
    out = torch.empty(k, c, pooled_h, pooled_w, dtype=input.dtype,
                      device=input.device)
    lib = _kernels.load("roi_align")
    _kernels.check(
        lib.vt_roi_align_forward(
            input.data_ptr(), boxes.data_ptr(), out.data_ptr(), n, c, h, w, k,
            pooled_h, pooled_w, float(spatial_scale), int(sampling_ratio),
            int(bool(aligned)), int(input.dtype == torch.bfloat16),
            _kernels.stream_handle(input),
        ),
        "roi_align kernel",
    )
    return out


def roi_align_backward_plain(
    grad: torch.Tensor,
    boxes: torch.Tensor,
    input_shape: Tuple[int, int, int, int],
    output_size: _Size,
    spatial_scale: float = 1.0,
    sampling_ratio: int = -1,
    aligned: bool = False,
) -> torch.Tensor:
    """Plain PyTorch RoIAlign backward: the gradient ``[N, C, H, W]`` of an
    input of ``input_shape`` for ``grad [K, C, PH, PW]`` of the output,
    in f32 (f64 for an f64 ``grad``): the autograd of
    :func:`roi_align_plain`, which is linear in its input."""
    acc = torch.promote_types(grad.dtype, torch.float32)
    with torch.enable_grad():
        x = torch.zeros(input_shape, dtype=acc, device=grad.device,
                        requires_grad=True)
        out = roi_align_plain(x, boxes, output_size, spatial_scale,
                              sampling_ratio, aligned)
        (gx,) = torch.autograd.grad(out, x, grad.to(acc))
    return gx


@_kernels.counted
def roi_align_backward_cuda(
    grad: torch.Tensor,
    boxes: torch.Tensor,
    input_shape: Tuple[int, int, int, int],
    output_size: _Size,
    spatial_scale: float = 1.0,
    sampling_ratio: int = -1,
    aligned: bool = False,
) -> torch.Tensor:
    """The kernel of ``csrc/roi_align_backward.cu`` (same contract as
    :func:`roi_align_backward_plain`; f32 ``grad`` and boxes). Every call
    on the same inputs gives the same bits: each element is summed by one
    thread over the RoIs in index order, with no atomics.

    It makes no host synchronisation. The kernel checks each RoI's batch
    index on the card, as the forward does: one outside ``[0, N)`` stops
    the launch, and the error surfaces at the next synchronisation."""
    if grad.dtype != torch.float32 or boxes.dtype != torch.float32:
        raise ValueError("roi_align_backward_cuda takes f32 grad and boxes, "
                         f"got {grad.dtype} and {boxes.dtype}")
    if grad.device.type != "cuda" or boxes.device != grad.device:
        raise ValueError("roi_align_backward_cuda takes CUDA tensors")
    pooled_h, pooled_w = _pair(output_size)
    n, c, h, w = input_shape
    k = boxes.shape[0]
    if tuple(grad.shape) != (k, c, pooled_h, pooled_w) or boxes.dim() != 2 or (
            boxes.shape[1] != 5):
        raise ValueError(f"grad must be [{k}, {c}, {pooled_h}, {pooled_w}] and "
                         f"boxes [K, 5], got {tuple(grad.shape)} and "
                         f"{tuple(boxes.shape)}")
    grad = grad.contiguous()
    boxes = boxes.contiguous()
    out = torch.empty(n, c, h, w, dtype=torch.float32, device=grad.device)
    desc = torch.empty(k, 16, dtype=torch.int32, device=grad.device)
    lib = _kernels.load("roi_align_backward")
    _kernels.check(
        lib.vt_roi_align_backward(
            grad.data_ptr(), boxes.data_ptr(), desc.data_ptr(), out.data_ptr(),
            n, c, h, w, k,
            pooled_h, pooled_w, float(spatial_scale), int(sampling_ratio),
            int(bool(aligned)), _kernels.stream_handle(grad),
        ),
        "roi_align_backward kernel",
    )
    return out


def _roi_align_forward(input, boxes, output_size, spatial_scale,
                       sampling_ratio, aligned):
    if input.device.type == "cpu":
        return roi_align_plain(input, boxes, output_size, spatial_scale,
                               sampling_ratio, aligned)
    return roi_align_cuda(input, boxes, output_size, spatial_scale,
                          sampling_ratio, aligned)


class _RoIAlign(torch.autograd.Function):
    """RoIAlign with the backward pass in ``input``; saves only the boxes."""

    @staticmethod
    def forward(ctx, input, boxes, output_size, spatial_scale, sampling_ratio,
                aligned):
        ctx.save_for_backward(boxes)
        ctx.args = (tuple(input.shape), output_size, spatial_scale,
                    sampling_ratio, aligned)
        ctx.dtype = input.dtype
        return _roi_align_forward(input, boxes, output_size, spatial_scale,
                                  sampling_ratio, aligned)

    @staticmethod
    def backward(ctx, grad):
        (boxes,) = ctx.saved_tensors
        gx = None
        if ctx.needs_input_grad[0]:
            backward = (roi_align_backward_plain if grad.device.type == "cpu"
                        else roi_align_backward_cuda)
            gx = backward(grad, boxes, *ctx.args).to(ctx.dtype)
        return gx, None, None, None, None, None


def roi_align(
    input: torch.Tensor,
    boxes: torch.Tensor,
    output_size: _Size,
    spatial_scale: float = 1.0,
    sampling_ratio: int = -1,
    aligned: bool = False,
) -> torch.Tensor:
    """RoIAlign (``torchvision.ops.roi_align``'s contract): ``input [N, C,
    H, W]``, ``boxes [K, 5]`` -> ``[K, C, PH, PW]``. The CUDA kernels for
    CUDA tensors, the plain versions for CPU tensors. Differentiable in
    ``input``; where no gradient is wanted, nothing is saved for one."""
    if torch.is_grad_enabled() and input.requires_grad:
        return _RoIAlign.apply(input, boxes, output_size, spatial_scale,
                               sampling_ratio, aligned)
    return _roi_align_forward(input, boxes, output_size, spatial_scale,
                              sampling_ratio, aligned)
