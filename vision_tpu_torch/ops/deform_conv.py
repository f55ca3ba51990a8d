"""Deformable convolution v1 and v2, NCHW (counterpart of
``vision_tpu/ops/deform_conv.py``, with torchvision's signature and
layouts).

:func:`deform_conv2d` samples the input bilinearly at each output
position's offset taps into f32 columns ``[N, OH, OW, K², C_in]`` (the JAX
package's layout, channels last), then contracts them with the weight by
``torch.matmul``, which writes the ``[N, C_out, OH, OW]`` result directly.
The columns come from the CUDA kernel ``csrc/deform_conv.cu`` for tensors
on the card and from the plain PyTorch version :func:`deform_im2col_plain`
for tensors on the CPU. Differentiable in the input, the offsets, the
mask, the weight and the bias: the weight's and the bias's gradients and
the columns' (``g_cols = g^T @ weight``) are ``torch.matmul`` products; the
input's, the offsets' and the mask's come from the kernel
``csrc/deform_conv_backward.cu`` on the card (deterministic: no atomics)
and from :func:`deform_conv_backward_plain` on the CPU.

The arithmetic is the JAX function's: the input and the offsets are taken
to f32 whatever their type, and the product is f32, so a bf16 input gives
f32 columns and an f32 product, and the result is rounded to the input's
type once. A sample ``y = oh * stride - pad + i * dilation + dy`` counts
only strictly inside ``(-1, H)`` (and the same in x); each of its four
corners has its own validity; the corners are summed as ``w1 g(yl, xl) +
w2 g(yl, xh) + w3 g(yh, xl) + w4 g(yh, xh)``, and the DCNv2 mask multiplies
the sum. ``floor`` carries no gradient, and an invalid corner gives zero.

Layouts: ``offset [N, 2 og K², OH, OW]``, channel ``g 2K² + 2 tap + {0: dy,
1: dx}`` (taps row-major); ``mask [N, og K², OH, OW]``; ``weight [C_out,
C_in / groups, KH, KW]``. The input's channels split into ``og`` offset
groups of consecutive channels, each sampled at its own offsets.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple, Union

import torch
from torch import nn

from vision_tpu_torch import _kernels

__all__ = ["DeformConv2d", "deform_conv2d", "deform_conv2d_plain",
           "deform_conv_backward_cuda", "deform_conv_backward_plain",
           "deform_im2col_cuda", "deform_im2col_plain", "sample_positions"]

# the element types of the kernels' input
KERNEL_DTYPES = (torch.float32, torch.bfloat16)

_Pair = Union[int, Tuple[int, int]]


def _pair(v: _Pair) -> Tuple[int, int]:
    return (v, v) if isinstance(v, int) else tuple(v)


def _geometry(input, offset, kernel_size, stride, padding, dilation):
    """(n, c, h, w, kh, kw, oh, ow, og) of a call, checked."""
    n, c, h, w = input.shape
    kh, kw = kernel_size
    oh = (h + 2 * padding[0] - (dilation[0] * (kh - 1) + 1)) // stride[0] + 1
    ow = (w + 2 * padding[1] - (dilation[1] * (kw - 1) + 1)) // stride[1] + 1
    k2 = kh * kw
    og = offset.shape[1] // (2 * k2) if offset.dim() == 4 else 0
    if offset.dim() != 4 or og == 0 or tuple(offset.shape) != (
            n, 2 * og * k2, oh, ow):
        raise ValueError(f"offset shape {tuple(offset.shape)} incompatible "
                         f"with the output ({n}, 2*og*{k2}, {oh}, {ow})")
    if c % og:
        raise ValueError(f"{c} input channels do not split into {og} offset "
                         "groups")
    return n, c, h, w, kh, kw, oh, ow, og


def sample_positions(offset: torch.Tensor, kernel_size: _Pair,
                     stride: _Pair = 1, padding: _Pair = 0,
                     dilation: _Pair = 1):
    """The f32 sample positions ``(y, x)``, each ``[N, og, K², OH, OW]``, of
    ``offset [N, 2 og K², OH, OW]``: ``oh * stride - pad + i * dilation + dy``
    (one f32 add: the base is an exact integer), and the same in x."""
    (kh, kw), stride, padding, dilation = map(
        _pair, (kernel_size, stride, padding, dilation))
    n, _, oh, ow = offset.shape
    k2 = kh * kw
    dev = offset.device
    base_y = (torch.arange(oh, dtype=torch.float32, device=dev)[None, :]
              * stride[0] - padding[0]
              + torch.arange(kh, dtype=torch.float32, device=dev)[:, None]
              * dilation[0])  # [KH, OH]
    base_x = (torch.arange(ow, dtype=torch.float32, device=dev)[None, :]
              * stride[1] - padding[1]
              + torch.arange(kw, dtype=torch.float32, device=dev)[:, None]
              * dilation[1])  # [KW, OW]
    off = offset.float().reshape(n, -1, k2, 2, oh, ow)
    y = base_y[:, None, :, None].expand(kh, kw, oh, 1).reshape(k2, oh, 1) + off[:, :, :, 0]
    x = base_x[None, :, None, :].expand(kh, kw, 1, ow).reshape(k2, 1, ow) + off[:, :, :, 1]
    return y, x


def _corners(input, offset, kernel_size, stride, padding, dilation):
    """The bilinear sample of every ``(n, g, tap, oh, ow)``: its four
    corners' values ``[N, og, K², OH, OW, C / og]`` (the input's channels
    of group g, taken to f32, or f64 for an f64 input; zero where the
    corner or the sample is invalid) and the fractions ``(hy, ly, hx, lx)``
    ``[N, og, K², OH, OW]`` in that type, as
    ``vision_tpu/ops/deform_conv.py:88-145`` computes them. The sample
    positions are f32 whatever the input's type."""
    stride, padding, dilation = map(_pair, (stride, padding, dilation))
    n, c, h, w, kh, kw, oh, ow, og = _geometry(
        input, offset, _pair(kernel_size), stride, padding, dilation)
    acc = torch.promote_types(input.dtype, torch.float32)
    k2, cg = kh * kw, c // og
    y, x = sample_positions(offset, (kh, kw), stride, padding, dilation)
    inside = (y > -1.0) & (y < h) & (x > -1.0) & (x < w)
    y_low = torch.floor(y).to(torch.int64)
    x_low = torch.floor(x).to(torch.int64)
    y_high, x_high = y_low + 1, x_low + 1
    ly = y - y_low.to(torch.float32)
    lx = x - x_low.to(torch.float32)
    hy, hx = 1.0 - ly, 1.0 - lx

    src = input.to(acc).permute(0, 2, 3, 1).reshape(n, h * w, og, cg)
    src = src.permute(0, 2, 1, 3)  # [N, og, H*W, Cg]

    def gather(yy, xx):
        valid = (yy >= 0) & (yy <= h - 1) & (xx >= 0) & (xx <= w - 1) & inside
        flat = yy.clamp(0, h - 1) * w + xx.clamp(0, w - 1)
        out = torch.gather(src, 2, flat.reshape(n, og, -1, 1).expand(-1, -1, -1, cg))
        out = out.reshape(n, og, k2, oh, ow, cg)
        return out * valid.to(acc)[..., None]

    values = (gather(y_low, x_low), gather(y_low, x_high),
              gather(y_high, x_low), gather(y_high, x_high))
    return values, tuple(t.to(acc) for t in (hy, ly, hx, lx))


def deform_im2col_plain(
    input: torch.Tensor,
    offset: torch.Tensor,
    mask: Optional[torch.Tensor],
    kernel_size: _Pair,
    stride: _Pair = 1,
    padding: _Pair = 0,
    dilation: _Pair = 1,
) -> torch.Tensor:
    """Plain PyTorch columns, gather by gather: ``input [N, C, H, W]``,
    ``offset [N, 2 og K², OH, OW]``, ``mask [N, og K², OH, OW]`` or None ->
    ``[N, OH, OW, K², C]`` in f32 (f64 for an f64 input)."""
    (v1, v2, v3, v4), (hy, ly, hx, lx) = _corners(
        input, offset, kernel_size, stride, padding, dilation)
    n, og, k2, oh, ow, cg = v1.shape
    cols = ((hy * hx)[..., None] * v1 + (hy * lx)[..., None] * v2
            + (ly * hx)[..., None] * v3 + (ly * lx)[..., None] * v4)
    if mask is not None:
        cols = cols * mask.to(cols.dtype).reshape(n, og, k2, oh, ow)[..., None]
    return cols.permute(0, 3, 4, 2, 1, 5).reshape(n, oh, ow, k2, og * cg)


def _kernel_args(input, offset, mask, kernel_size, stride, padding, dilation,
                 name):
    if input.dtype not in KERNEL_DTYPES:
        raise ValueError(f"{name} takes an f32 or bf16 input, got {input.dtype}")
    if input.device.type != "cuda" or offset.device != input.device or (
            mask is not None and mask.device != input.device):
        raise ValueError(f"{name} takes CUDA tensors")
    stride, padding, dilation = map(_pair, (stride, padding, dilation))
    geo = _geometry(input, offset, _pair(kernel_size), stride, padding,
                    dilation)
    n, _, _, _, kh, kw, oh, ow, og = geo
    if mask is not None and tuple(mask.shape) != (n, og * kh * kw, oh, ow):
        raise ValueError(f"mask shape {tuple(mask.shape)}, expected "
                         f"({n}, {og * kh * kw}, {oh}, {ow})")
    # the kernels read the input channels last, the offsets and the mask in
    # f32 (the JAX function casts them)
    x = input.permute(0, 2, 3, 1).contiguous()
    off = offset.float().contiguous()
    m = None if mask is None else mask.float().contiguous()
    return geo, (stride, padding, dilation), x, off, m


@_kernels.counted
def deform_im2col_cuda(
    input: torch.Tensor,
    offset: torch.Tensor,
    mask: Optional[torch.Tensor],
    kernel_size: _Pair,
    stride: _Pair = 1,
    padding: _Pair = 0,
    dilation: _Pair = 1,
) -> torch.Tensor:
    """The kernel of ``csrc/deform_conv.cu`` (same contract as
    :func:`deform_im2col_plain`; an f32 or bf16 input, read as it lies and
    widened; f32 columns). Makes no host synchronisation."""
    geo, (stride, padding, dilation), x, off, m = _kernel_args(
        input, offset, mask, kernel_size, stride, padding, dilation,
        "deform_im2col_cuda")
    n, c, h, w, kh, kw, oh, ow, og = geo
    cols = torch.empty(n, oh, ow, kh * kw, c, dtype=torch.float32,
                       device=input.device)
    lib = _kernels.load("deform_conv")
    _kernels.check(
        lib.vt_deform_im2col(
            x.data_ptr(), off.data_ptr(), 0 if m is None else m.data_ptr(),
            cols.data_ptr(), n, c, h, w, kh, kw, oh, ow, og, *stride,
            *padding, *dilation, int(input.dtype == torch.bfloat16),
            _kernels.stream_handle(input)),
        "deform_conv kernel")
    return cols


def deform_conv_backward_plain(
    input: torch.Tensor,
    offset: torch.Tensor,
    mask: Optional[torch.Tensor],
    grad_cols: torch.Tensor,
    kernel_size: _Pair,
    stride: _Pair = 1,
    padding: _Pair = 0,
    dilation: _Pair = 1,
):
    """Plain PyTorch gradients of the columns: ``(grad_input [N, C, H, W],
    grad_offset, grad_mask or None)`` for ``grad_cols [N, OH, OW, K², C]``,
    by autograd of :func:`deform_im2col_plain`; in f32 (f64 for an f64
    input), the offsets' and the mask's too."""
    acc = torch.promote_types(input.dtype, torch.float32)
    with torch.enable_grad():
        x = input.detach().to(acc).requires_grad_(True)
        off = offset.detach().float().requires_grad_(True)
        m = None if mask is None else mask.detach().to(acc).requires_grad_(True)
        cols = deform_im2col_plain(x, off, m, kernel_size, stride, padding,
                                   dilation)
        grads = torch.autograd.grad(cols, [t for t in (x, off, m) if t is not None],
                                    grad_cols.to(acc))
    return grads[0], grads[1], grads[2] if m is not None else None


@_kernels.counted
def deform_conv_backward_cuda(
    input: torch.Tensor,
    offset: torch.Tensor,
    mask: Optional[torch.Tensor],
    grad_cols: torch.Tensor,
    kernel_size: _Pair,
    stride: _Pair = 1,
    padding: _Pair = 0,
    dilation: _Pair = 1,
):
    """The kernels of ``csrc/deform_conv_backward.cu`` (same contract as
    :func:`deform_conv_backward_plain`; an f32 or bf16 input, f32
    ``grad_cols``). The input's gradient has the input's type, its f32 sum
    rounded once; the offsets' and the mask's are f32.

    Deterministic, with no atomics: every corner that a valid sample reads
    is keyed by its input pixel (``vt_deform_scatter_keys``), the keys are
    sorted stably (``torch.sort``) and each pixel's range found by
    ``torch.searchsorted``; then one thread sums each (pixel, channel) over
    its range in sorted order, and one warp each (sample, offset group)'s
    offset and mask gradients, in a fixed order. Every element is written,
    zeros included. Makes no host synchronisation: the scratch is sized
    from the shapes."""
    geo, (stride, padding, dilation), x, off, m = _kernel_args(
        input, offset, mask, kernel_size, stride, padding, dilation,
        "deform_conv_backward_cuda")
    n, c, h, w, kh, kw, oh, ow, og = geo
    k2 = kh * kw
    if grad_cols.dtype != torch.float32 or tuple(grad_cols.shape) != (
            n, oh, ow, k2, c):
        raise ValueError(f"grad_cols must be f32 [{n}, {oh}, {ow}, {k2}, {c}], "
                         f"got {grad_cols.dtype} {tuple(grad_cols.shape)}")
    items = 4 * n * og * k2 * oh * ow
    buckets = n * og * h * w
    if max(items, buckets + 1) >= 2 ** 31:
        raise ValueError(f"deform_conv_backward_cuda: {items} corners or "
                         f"{buckets} pixels pass 2**31")
    dev = input.device
    grad_cols = grad_cols.contiguous()
    lib = _kernels.load("deform_conv_backward")
    stream = _kernels.stream_handle(input)
    geometry = (n, c, h, w, kh, kw, oh, ow, og, *stride, *padding, *dilation)
    keys = torch.empty(items, dtype=torch.int32, device=dev)
    _kernels.check(lib.vt_deform_scatter_keys(off.data_ptr(), keys.data_ptr(),
                                              *geometry, stream),
                   "deform_conv_backward keys kernel")
    sorted_keys, order = torch.sort(keys, stable=True)
    starts = torch.searchsorted(
        sorted_keys, torch.arange(buckets + 1, dtype=torch.int32, device=dev))
    grad_input = torch.empty(n, c, h, w, dtype=input.dtype, device=dev)
    grad_offset = torch.empty(off.shape, dtype=torch.float32, device=dev)
    grad_mask = None if m is None else torch.empty(m.shape, dtype=torch.float32,
                                                   device=dev)
    _kernels.check(
        lib.vt_deform_backward(
            x.data_ptr(), off.data_ptr(), 0 if m is None else m.data_ptr(),
            grad_cols.data_ptr(), order.data_ptr(), starts.data_ptr(),
            grad_input.data_ptr(), grad_offset.data_ptr(),
            0 if grad_mask is None else grad_mask.data_ptr(), *geometry,
            int(input.dtype == torch.bfloat16), stream),
        "deform_conv_backward kernel")
    return grad_input, grad_offset, grad_mask


def _grouped(cols: torch.Tensor, weight: torch.Tensor):
    """The weight as ``[G, C_out/G, K² C_in/G]`` in the columns' type, and
    the columns as ``[N, G, OH OW, K² C_in/G]`` (a view where G = 1)."""
    n, oh, ow, k2, c = cols.shape
    co, cg = weight.shape[:2]
    groups = c // cg
    w = weight.to(cols.dtype).permute(0, 2, 3, 1).reshape(groups, co // groups,
                                                          k2 * cg)
    if groups == 1:
        return w, cols.reshape(n, 1, oh * ow, k2 * c)
    return w, cols.reshape(n, oh * ow, k2, groups, cg).permute(
        0, 3, 1, 2, 4).reshape(n, groups, oh * ow, k2 * cg)


def _product(cols: torch.Tensor, weight: torch.Tensor,
             bias: Optional[torch.Tensor]) -> torch.Tensor:
    """``cols [N, OH, OW, K², C_in]`` with ``weight [C_out, C_in / G, KH,
    KW]`` (and the bias), in the columns' type: ``[N, C_out, OH, OW]``. The
    product of each group, ``weight [C_out/G, K² C_in/G] @ cols^T``, writes
    NCHW directly. Named ``deform_conv2d.product`` for ``torch.profiler``."""
    n, oh, ow = cols.shape[:3]
    w, cols_g = _grouped(cols, weight)
    with torch.profiler.record_function("deform_conv2d.product"):
        out = torch.matmul(w, cols_g.transpose(-1, -2)).reshape(
            n, weight.shape[0], oh, ow)
    if bias is not None:
        out = out + bias.to(out.dtype)[:, None, None]
    return out


def _check_groups(input: torch.Tensor, weight: torch.Tensor) -> None:
    if input.shape[1] % weight.shape[1]:
        raise ValueError(f"{input.shape[1]} input channels do not split into "
                         f"groups of {weight.shape[1]}")


def deform_conv2d_plain(
    input: torch.Tensor,
    offset: torch.Tensor,
    weight: torch.Tensor,
    bias: Optional[torch.Tensor] = None,
    stride: _Pair = 1,
    padding: _Pair = 0,
    dilation: _Pair = 1,
    mask: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """The whole op in plain PyTorch (:func:`deform_im2col_plain` and the
    product); its autograd gives the plain gradients."""
    _check_groups(input, weight)
    cols = deform_im2col_plain(input, offset, mask, weight.shape[-2:], stride,
                               padding, dilation)
    return _product(cols, weight, bias).to(input.dtype)


def _im2col(input, *args):
    fn = deform_im2col_plain if input.device.type == "cpu" else deform_im2col_cuda
    return fn(input, *args)


class _DeformConv2d(torch.autograd.Function):
    """The op with its backward pass; saves the f32 columns (the weight's
    gradient needs them)."""

    @staticmethod
    def forward(ctx, input, offset, mask, weight, bias, geometry):
        cols = _im2col(input, offset, mask, weight.shape[-2:], *geometry)
        ctx.save_for_backward(input, offset, mask, weight, cols)
        ctx.geometry = geometry
        ctx.has_bias = bias is not None
        ctx.bias_dtype = None if bias is None else bias.dtype
        return _product(cols, weight, bias).to(input.dtype)

    @staticmethod
    def backward(ctx, grad):
        input, offset, mask, weight, cols = ctx.saved_tensors
        n, oh, ow, k2, c = cols.shape
        co, cg = weight.shape[:2]
        groups = c // cg
        g = grad.to(cols.dtype).reshape(n, groups, co // groups, oh * ow)
        w, cols_g = _grouped(cols, weight)
        gi = go = gm = gw = gb = None
        if any(ctx.needs_input_grad[:3]):
            with torch.profiler.record_function("deform_conv2d.product"):
                g_cols = torch.matmul(g.transpose(-1, -2), w)  # [N, G, L, K² Cg]
            if groups == 1:
                g_cols = g_cols.reshape(n, oh, ow, k2, c)
            else:
                g_cols = g_cols.reshape(n, groups, oh * ow, k2, cg).permute(
                    0, 2, 3, 1, 4).reshape(n, oh, ow, k2, c)
            backward = (deform_conv_backward_plain if input.device.type == "cpu"
                        else deform_conv_backward_cuda)
            gi, go, gm = backward(input, offset, mask, g_cols.to(cols.dtype),
                                  weight.shape[-2:], *ctx.geometry)
            gi, go = gi.to(input.dtype), go.to(offset.dtype)
            gm = None if gm is None else gm.to(mask.dtype)
        if ctx.needs_input_grad[3]:
            with torch.profiler.record_function("deform_conv2d.product"):
                gw = torch.matmul(g, cols_g).sum(0)
            gw = gw.reshape(co, *weight.shape[-2:], cg)
            gw = gw.permute(0, 3, 1, 2).to(weight.dtype)
        if ctx.has_bias and ctx.needs_input_grad[4]:
            gb = g.sum((0, 3)).reshape(co).to(ctx.bias_dtype)
        return gi, go, gm, gw, gb, None


def deform_conv2d(
    input: torch.Tensor,
    offset: torch.Tensor,
    weight: torch.Tensor,
    bias: Optional[torch.Tensor] = None,
    stride: _Pair = 1,
    padding: _Pair = 0,
    dilation: _Pair = 1,
    mask: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Deformable convolution (``torchvision.ops.deform_conv2d``'s
    contract): ``input [N, C_in, H, W]``, ``offset [N, 2 og KH KW, OH,
    OW]``, ``weight [C_out, C_in / groups, KH, KW]``, ``mask [N, og KH KW,
    OH, OW]`` (DCNv2) -> ``[N, C_out, OH, OW]`` in the input's type. The
    CUDA kernels for CUDA tensors, the plain versions for CPU tensors.
    Where no gradient is wanted, nothing is saved for one."""
    _check_groups(input, weight)
    geometry = tuple(map(_pair, (stride, padding, dilation)))
    tensors = [t for t in (input, offset, mask, weight, bias) if t is not None]
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        return _DeformConv2d.apply(input, offset, mask, weight, bias, geometry)
    cols = _im2col(input, offset, mask, weight.shape[-2:], *geometry)
    return _product(cols, weight, bias).to(input.dtype)


class DeformConv2d(nn.Module):
    """A deformable convolution with parameters ``weight [out, in /
    groups, k, k]`` (and ``bias``); ``forward(input, offset, mask=None)``.
    Initialised as ``torch.nn.Conv2d`` is (a detector's ``init_weights``
    redraws it)."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size: _Pair,
                 stride: _Pair = 1, padding: _Pair = 0, dilation: _Pair = 1,
                 groups: int = 1, bias: bool = True):
        super().__init__()
        if in_channels % groups or out_channels % groups:
            raise ValueError("in_channels and out_channels must be divisible "
                             "by groups")
        self.stride, self.padding, self.dilation = map(
            _pair, (stride, padding, dilation))
        self.weight = nn.Parameter(torch.empty(
            out_channels, in_channels // groups, *_pair(kernel_size)))
        self.bias = nn.Parameter(torch.empty(out_channels)) if bias else None
        nn.init.kaiming_uniform_(self.weight, a=math.sqrt(5))
        if self.bias is not None:
            fan_in = self.weight[0].numel()
            bound = 1.0 / math.sqrt(fan_in)
            nn.init.uniform_(self.bias, -bound, bound)

    def forward(self, input: torch.Tensor, offset: torch.Tensor,
                mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        return deform_conv2d(input, offset, self.weight, self.bias, self.stride,
                             self.padding, self.dilation, mask)
