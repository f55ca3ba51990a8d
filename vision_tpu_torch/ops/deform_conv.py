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

The kernels' bookkeeping has plain twins that the CPU tests reach:
:func:`tile_plan` sizes their tiles and staged windows,
:func:`deform_tile_codes_plain` is what a tile makes of each corner, and
:func:`deform_corner_records_plain`, :func:`sort_corners` and
:func:`deform_records_input_grad_plain` are the backward's per-corner
records, their sorted order and the input gradient's sum over them.

Layouts: ``offset [N, 2 og K², OH, OW]``, channel ``g 2K² + 2 tap + {0: dy,
1: dx}`` (taps row-major); ``mask [N, og K², OH, OW]``; ``weight [C_out,
C_in / groups, KH, KW]``. The input's channels split into ``og`` offset
groups of consecutive channels, each sampled at its own offsets.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional, Tuple, Union

import torch
from torch import nn

from vision_tpu_torch import _kernels

__all__ = ["DeformConv2d", "TilePlan", "deform_conv2d", "deform_conv2d_plain",
           "deform_conv_backward_cuda", "deform_conv_backward_plain",
           "deform_corner_records_plain", "deform_im2col_cuda",
           "deform_im2col_plain", "deform_records_input_grad_plain",
           "deform_tile_codes_plain", "sample_positions", "sort_corners",
           "tile_plan"]

# the element types of the kernels' input
KERNEL_DTYPES = (torch.float32, torch.bfloat16)
# The kernels' tiles (csrc/deform_sample.cuh): a block stages, CHUNK channels
# at a time, the input pixels its tile of output positions reads at offsets
# of up to MARGIN px, in SMEM_LIMIT bytes of shared memory at most; both
# split the channels over more blocks until their threads would fill the
# H100's 132 SMs of 2,048 threads (FILL_THREADS).
MARGIN = 3
CHUNK = 32
SMEM_LIMIT = 227 * 1024
FILL_THREADS = 2048 * 132
# tiles (rows, columns of output positions): the forward's, in order of
# preference, and the offsets' backward (32 positions, 9 taps a block:
# csrc/deform_conv_backward.cu); the threads of each kernel's block
_FORWARD_TILES = ((4, 8), (2, 8), (1, 8), (1, 4), (1, 2), (1, 1))
_BACKWARD_TILE = (4, 8)
_BACKWARD_TAPS = 9
_THREADS = {"forward": 256, "backward": 512}
_STRIDE = CHUNK + 4  # floats a staged pixel

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


class TilePlan(NamedTuple):
    """A kernel's tile and staged window (``csrc/deform_sample.cuh``):
    ``th x tw`` output positions a block, the window's ``margin`` (px of
    offset it covers) and its ``wr x wc`` pixels (0 x 0: nothing staged,
    every corner read from global memory), the channel ``splits`` (blocks
    a tile), and the block's shared-memory bytes."""
    th: int
    tw: int
    margin: int
    wr: int
    wc: int
    splits: int
    smem: int


def _window(th, tw, margin, kernel_size, stride, dilation):
    """The rows and columns a tile stages: ``(th - 1) sh + (kh - 1) dh + 2
    margin + 1``, and the same in x."""
    (kh, kw), (sh, sw), (dh, dw) = kernel_size, stride, dilation
    return ((th - 1) * sh + (kh - 1) * dh + 2 * margin + 1,
            (tw - 1) * sw + (kw - 1) * dw + 2 * margin + 1)


def _window_bytes(wr, wc):
    """The window and its zero pixel, ``_STRIDE`` floats a pixel."""
    return (wr * wc + 1) * _STRIDE * 4


def tile_plan(kind: str, n: int, c: int, og: int, out_hw, kernel_size,
              stride, dilation) -> TilePlan:
    """The tile of the forward kernel (``kind="forward"``: records of 40
    bytes a sample, all taps) or of the offsets' backward kernel
    (``"backward"``: 4 x 8 positions, 9 taps a block, 32 bytes a sample
    and its chunk of ``g_cols``):
    the first tile, and then the largest margin up to ``MARGIN``, whose
    window and records fit in ``SMEM_LIMIT``; an empty window where none
    does. The channel splits: as many as bring the blocks' threads to
    ``FILL_THREADS``, no more than the chunks of ``CHUNK`` channels a block
    walks (the forward's over all offset groups, the backward's within
    one)."""
    kernel_size, stride, dilation = map(_pair, (kernel_size, stride, dilation))
    k2 = kernel_size[0] * kernel_size[1]
    if kind == "forward":
        tiles, per_sample, taps = _FORWARD_TILES, 40, k2
    elif kind == "backward":
        tiles, per_sample, taps = (_BACKWARD_TILE,), 32 + 4 * CHUNK, _BACKWARD_TAPS
    else:
        raise ValueError(f"kind must be 'forward' or 'backward', got {kind!r}")
    for th, tw in tiles:
        records = th * tw * taps * per_sample
        if records > SMEM_LIMIT:
            continue
        for margin in range(MARGIN, -1, -1):
            wr, wc = _window(th, tw, margin, kernel_size, stride, dilation)
            if records + _window_bytes(wr, wc) <= SMEM_LIMIT:
                break
        else:
            margin = wr = wc = 0
        break
    else:
        raise ValueError(f"a {kernel_size} kernel's records do not fit in "
                         "shared memory")
    oh, ow = out_hw
    blocks = n * -(-oh // th) * -(-ow // tw)
    chunks = -(-(c // og) // CHUNK)
    if kind == "forward":
        chunks *= og
    else:
        blocks *= og * -(-k2 // taps)
    fill = FILL_THREADS // _THREADS[kind]
    splits = max(1, min(chunks, -(-fill // max(blocks, 1))))
    return TilePlan(th, tw, margin, wr, wc, splits,
                    records + _window_bytes(wr, wc))


def deform_tile_codes_plain(offset: torch.Tensor, kernel_size: _Pair,
                            stride: _Pair, padding: _Pair, dilation: _Pair,
                            input_hw, plan: TilePlan) -> torch.Tensor:
    """What the kernels make of each sample's corners under ``plan``:
    ``[N, og, K², OH, OW, 4]`` int64, the corner's pixel in its tile's
    staged window (``r wc + c``), the window's zero pixel ``wr wc`` where
    the sample or the corner is invalid, or ``-1 - (y W + x)`` for a valid
    corner outside the window (read from global memory); the kernels hold
    the first two times the window's pixel stride. The tile of output (oy,
    ox) is (oy // th, ox // tw); its window's top-left pixel is (ty th sh -
    ph - margin, tx tw sw - pw - margin)."""
    (kh, kw), stride, padding, dilation = map(
        _pair, (kernel_size, stride, padding, dilation))
    h, w = input_hw
    y, x = sample_positions(offset, (kh, kw), stride, padding, dilation)
    oh, ow = y.shape[-2:]
    dev = offset.device
    wy0 = ((torch.arange(oh, device=dev) // plan.th) * plan.th * stride[0]
           - padding[0] - plan.margin)[:, None]
    wx0 = ((torch.arange(ow, device=dev) // plan.tw) * plan.tw * stride[1]
           - padding[1] - plan.margin)[None, :]
    inside = (y > -1.0) & (y < h) & (x > -1.0) & (x < w)
    yl, xl = torch.floor(y).long(), torch.floor(x).long()
    codes = []
    for k in range(4):
        yy, xx = yl + (k >> 1), xl + (k & 1)
        valid = inside & (yy >= 0) & (yy <= h - 1) & (xx >= 0) & (xx <= w - 1)
        r, cc = yy - wy0, xx - wx0
        staged = (r >= 0) & (r < plan.wr) & (cc >= 0) & (cc < plan.wc)
        codes.append(torch.where(~valid, torch.full_like(yy, plan.wr * plan.wc),
                                 torch.where(staged, r * plan.wc + cc,
                                             -1 - (yy * w + xx))))
    return torch.stack(codes, -1)


def deform_corner_records_plain(offset: torch.Tensor,
                                mask: Optional[torch.Tensor],
                                kernel_size: _Pair, stride: _Pair,
                                padding: _Pair, dilation: _Pair, input_hw,
                                dtype: torch.dtype = torch.float32):
    """What the backward's keys kernel writes (``vt_deform_scatter_keys``),
    corner ``t = 4 (((b og + g) K² + tap) OH OW + pos) + k``: ``keys``, the
    input pixel ``(b og + g) H W + y W + x`` it reads (``N og H W`` where
    the sample or the corner is invalid); ``rows``, its sample's g_cols row
    ``(b OH OW + pos) K² + tap``; ``weights``, its weight times the mask in
    ``dtype`` (the fractions are f32 whatever it is; the kernel's are f32
    products); both 0 where invalid. ``keys`` and ``rows`` are int64."""
    (kh, kw), stride, padding, dilation = map(
        _pair, (kernel_size, stride, padding, dilation))
    h, w = input_hw
    y, x = sample_positions(offset, (kh, kw), stride, padding, dilation)
    n, og, k2, oh, ow = y.shape
    dev = offset.device
    inside = (y > -1.0) & (y < h) & (x > -1.0) & (x < w)
    yl, xl = torch.floor(y), torch.floor(x)
    ly, lx = y - yl, x - xl
    hy, hx = 1.0 - ly, 1.0 - lx
    yl, xl = yl.long(), xl.long()
    b = torch.arange(n, device=dev).reshape(n, 1, 1, 1, 1)
    g = torch.arange(og, device=dev).reshape(1, og, 1, 1, 1)
    tap = torch.arange(k2, device=dev).reshape(1, 1, k2, 1, 1)
    pos = torch.arange(oh * ow, device=dev).reshape(1, 1, 1, oh, ow)
    row = (b * oh * ow + pos) * k2 + tap
    m = None if mask is None else mask.to(dtype).reshape(n, og, k2, oh, ow)
    keys, rows, weights = [], [], []
    for k in range(4):
        yy, xx = yl + (k >> 1), xl + (k & 1)
        valid = inside & (yy >= 0) & (yy <= h - 1) & (xx >= 0) & (xx <= w - 1)
        wt = (hy if k < 2 else ly).to(dtype) * (lx if k & 1 else hx).to(dtype)
        if m is not None:
            wt = wt * m
        keys.append(torch.where(valid, (b * og + g) * h * w + yy * w + xx,
                                n * og * h * w))
        rows.append(torch.where(valid, row, 0))
        weights.append(torch.where(valid, wt, torch.zeros((), dtype=dtype,
                                                          device=dev)))
    return tuple(torch.stack(t, -1).reshape(-1) for t in (keys, rows, weights))


def sort_corners(keys: torch.Tensor, buckets: int):
    """The backward's glue: the stable sort's permutation of the corners'
    keys (int64) and each pixel's first position among the sorted keys,
    ``buckets + 1`` of them (int32; the last bucket, ``buckets``, holds the
    invalid corners)."""
    sorted_keys, order = torch.sort(keys, stable=True)
    starts = torch.searchsorted(
        sorted_keys, torch.arange(buckets + 1, dtype=keys.dtype,
                                  device=keys.device), out_int32=True)
    return order, starts


def deform_records_input_grad_plain(keys: torch.Tensor, rows: torch.Tensor,
                                    weights: torch.Tensor,
                                    grad_cols: torch.Tensor, input_shape,
                                    og: int) -> torch.Tensor:
    """The input's gradient as the backward's sum kernel forms it from the
    records (:func:`deform_corner_records_plain`): put in sorted order
    (:func:`sort_corners`), each pixel's range summed in that order,
    ``g_cols[row, g C/og ..] * weight``, in ``weights``' type;
    ``[N, C, H, W]``."""
    n, c, h, w = input_shape
    buckets = n * og * h * w
    order, _ = sort_corners(keys, buckets)
    keys, rows, weights = keys[order], rows[order], weights[order]
    cg = c // og
    g = (keys // (h * w)) % og
    gc = grad_cols.to(weights.dtype).reshape(-1, og, cg)
    out = torch.zeros(buckets + 1, cg, dtype=weights.dtype,
                      device=weights.device)
    out.index_add_(0, keys, gc[rows, g.clamp(max=og - 1)] * weights[:, None])
    return out[:-1].reshape(n, og, h, w, cg).permute(0, 1, 4, 2, 3).reshape(
        n, c, h, w)


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
    n, _, h, w, kh, kw, oh, ow, og = geo
    if mask is not None and tuple(mask.shape) != (n, og * kh * kw, oh, ow):
        raise ValueError(f"mask shape {tuple(mask.shape)}, expected "
                         f"({n}, {og * kh * kw}, {oh}, {ow})")
    items = 4 * n * og * kh * kw * oh * ow
    if max(items, n * og * h * w + 1) >= 2 ** 31:
        raise ValueError(f"{name}: {items} corners or {n * og * h * w} "
                         "pixels pass 2**31")
    # the kernels read the input NCHW as it lies, the offsets and the mask
    # in f32 (the JAX function casts them)
    x = input.contiguous()
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
    :func:`deform_im2col_plain`; an f32 or bf16 input, read NCHW as it lies
    and widened; f32 columns; the tile of :func:`tile_plan`). Makes no
    host synchronisation."""
    geo, (stride, padding, dilation), x, off, m = _kernel_args(
        input, offset, mask, kernel_size, stride, padding, dilation,
        "deform_im2col_cuda")
    n, c, h, w, kh, kw, oh, ow, og = geo
    plan = tile_plan("forward", n, c, og, (oh, ow), (kh, kw), stride,
                     dilation)
    cols = torch.empty(n, oh, ow, kh * kw, c, dtype=torch.float32,
                       device=input.device)
    lib = _kernels.load("deform_conv")
    _kernels.check(
        lib.vt_deform_im2col(
            x.data_ptr(), off.data_ptr(), 0 if m is None else m.data_ptr(),
            cols.data_ptr(), n, c, h, w, kh, kw, oh, ow, og, *stride,
            *padding, *dilation, plan.th, plan.tw, plan.margin, plan.wr,
            plan.wc, plan.splits, int(input.dtype == torch.bfloat16),
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


def _corner_records_cuda(off, m, geometry):
    """``vt_deform_scatter_keys`` on the card: the corners' keys (int32)
    and records ``[items, 2]`` (int32 row, f32 weight times mask as its
    bits), as :func:`deform_corner_records_plain` lays them out."""
    n, _, _, _, kh, kw, oh, ow, og = geometry[:9]
    items = 4 * n * og * kh * kw * oh * ow
    keys = torch.empty(items, dtype=torch.int32, device=off.device)
    recs = torch.empty(items, 2, dtype=torch.int32, device=off.device)
    _kernels.check(
        _kernels.load("deform_conv_backward").vt_deform_scatter_keys(
            off.data_ptr(), 0 if m is None else m.data_ptr(), keys.data_ptr(),
            recs.data_ptr(), *geometry, _kernels.stream_handle(off)),
        "deform_conv_backward keys kernel")
    return keys, recs


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
    :func:`deform_conv_backward_plain`; an f32 or bf16 input, read NCHW as
    it lies; f32 ``grad_cols``). The input's gradient has the input's type,
    its f32 sum rounded once; the offsets' and the mask's are f32.

    Deterministic, with no atomics: every corner is keyed by the input
    pixel it reads and given a record, its g_cols row and its weight times
    the mask (``vt_deform_scatter_keys``, as
    :func:`deform_corner_records_plain`); the keys are sorted stably and
    each pixel's range found (:func:`sort_corners`); the records are put in
    sorted order, and one warp sums each pixel's range in that order (as
    :func:`deform_records_input_grad_plain`), for all its channels at once
    up to 256; the offsets' and the mask's gradients come from four sums a
    sample over the channels (of ``g_cols`` times each corner), taken in a
    fixed order on the tile of :func:`tile_plan`, its channel splits added
    in order by a last pass.
    Every element is written, zeros included. Makes no host
    synchronisation: the scratch is sized from the shapes."""
    geo, (stride, padding, dilation), x, off, m = _kernel_args(
        input, offset, mask, kernel_size, stride, padding, dilation,
        "deform_conv_backward_cuda")
    n, c, h, w, kh, kw, oh, ow, og = geo
    k2 = kh * kw
    if grad_cols.dtype != torch.float32 or tuple(grad_cols.shape) != (
            n, oh, ow, k2, c):
        raise ValueError(f"grad_cols must be f32 [{n}, {oh}, {ow}, {k2}, {c}], "
                         f"got {grad_cols.dtype} {tuple(grad_cols.shape)}")
    dev = input.device
    grad_cols = grad_cols.contiguous()
    geometry = (n, c, h, w, kh, kw, oh, ow, og, *stride, *padding, *dilation)
    keys, recs = _corner_records_cuda(off, m, geometry)
    order, starts = sort_corners(keys, n * og * h * w)
    plan = tile_plan("backward", n, c, og, (oh, ow), (kh, kw), stride,
                     dilation)
    partial = None if plan.splits == 1 else torch.empty(
        4 * plan.splits * n * og * k2 * oh * ow, dtype=torch.float32,
        device=dev)
    grad_input = torch.empty(n, c, h, w, dtype=input.dtype, device=dev)
    grad_offset = torch.empty(off.shape, dtype=torch.float32, device=dev)
    grad_mask = None if m is None else torch.empty(m.shape, dtype=torch.float32,
                                                   device=dev)
    _kernels.check(
        _kernels.load("deform_conv_backward").vt_deform_backward(
            x.data_ptr(), off.data_ptr(), 0 if m is None else m.data_ptr(),
            grad_cols.data_ptr(), order.data_ptr(), recs.data_ptr(),
            torch.empty_like(recs).data_ptr(), starts.data_ptr(),
            grad_input.data_ptr(), grad_offset.data_ptr(),
            0 if grad_mask is None else grad_mask.data_ptr(),
            0 if partial is None else partial.data_ptr(), *geometry, plan.th,
            plan.tw, plan.margin, plan.wr, plan.wc, plan.splits,
            int(input.dtype == torch.bfloat16), _kernels.stream_handle(input)),
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
