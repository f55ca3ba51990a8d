"""1x1 convolution as a matrix product, with the previous batch norm's
normalise+ReLU folded into its input and this batch norm's statistics taken
from its output (counterpart of ``vision_tpu/ops/_pallas/conv1x1_bn.py``).

For ``x [M, K]`` and ``w [K, N]``::

    xn = relu(x * scale + shift)   # optional prologue, f32 math, cast back
                                   # to x.dtype; never written to memory
    y  = xn @ w                    # f32 accumulation, cast to the out dtype
    s1 = sum_m y[m, :]             # f32, over the CAST y: the tensor an
    s2 = sum_m y[m, :] ** 2        # unfused batch norm would reduce

so ``mean = s1 / M`` and ``var = max(0, s2 / M - mean**2)`` are the
statistics of the unfused path to f32 round-off.

* :func:`matmul_stats` — the differentiable entry: the CUDA kernel
  ``csrc/matmul_stats.cu`` for tensors on the card, the plain PyTorch
  version for tensors on the CPU.
* :func:`matmul_stats_cuda` — the kernel's wrapper.
* :func:`matmul_stats_plain` — the plain version.

The backward pass is plain PyTorch in both cases, as it is plain XLA in the
JAX package: the cotangents of the sums fold into the output's,
``dy + ds1 + 2 * y * ds2``, and two matrix products follow.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from vision_tpu_torch import _kernels

__all__ = ["matmul_stats", "matmul_stats_cuda", "matmul_stats_plain"]

_Out = Tuple[torch.Tensor, torch.Tensor, torch.Tensor]


def _prologue(x: torch.Tensor, scale: torch.Tensor, shift: torch.Tensor):
    """``(z, relu(z) cast to x.dtype)`` with ``z = f32(x) * scale + shift``."""
    z = x.float() * scale.float() + shift.float()
    return z, torch.relu(z).to(x.dtype)


def matmul_stats_plain(
    x: torch.Tensor,
    w: torch.Tensor,
    scale: Optional[torch.Tensor] = None,
    shift: Optional[torch.Tensor] = None,
) -> _Out:
    """Plain PyTorch version: ``(y [M, N], s1 [N] f32, s2 [N] f32)``."""
    out_dtype = torch.promote_types(x.dtype, w.dtype)
    xb = x if scale is None else _prologue(x, scale, shift)[1]
    y = xb.to(out_dtype) @ w.to(out_dtype)
    yf = y.float()
    return y, yf.sum(0), (yf * yf).sum(0)


@_kernels.counted
def matmul_stats_cuda(
    x: torch.Tensor,
    w: torch.Tensor,
    scale: Optional[torch.Tensor] = None,
    shift: Optional[torch.Tensor] = None,
) -> _Out:
    """The kernel of ``csrc/matmul_stats.cu`` (same contract as
    :func:`matmul_stats_plain`): ``x`` and ``w`` both f32 or both bf16, any
    M, K, N with M, N >= 1. Two launches per call: the product with the
    per-tile column sums, then the sum over the tiles."""
    if x.device.type != "cuda" or w.device != x.device:
        raise ValueError("matmul_stats_cuda takes CUDA tensors")
    if x.dim() != 2 or w.dim() != 2 or x.shape[1] != w.shape[0]:
        raise ValueError(f"x must be [M, K] and w [K, N], got "
                         f"{tuple(x.shape)} and {tuple(w.shape)}")
    if x.dtype != w.dtype or x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"matmul_stats_cuda takes x and w both f32 or both "
                        f"bf16, got {x.dtype} and {w.dtype}")
    if (scale is None) != (shift is None):
        raise ValueError("scale and shift come together")
    m, k = x.shape
    n = w.shape[1]
    if m == 0 or n == 0:
        raise ValueError("matmul_stats_cuda takes M >= 1 and N >= 1")
    x = x.contiguous()
    w = w.contiguous()
    sc_ptr = sh_ptr = None
    if scale is not None:
        if scale.shape != (k,) or shift.shape != (k,):
            raise ValueError(f"scale and shift must be [{k}]")
        if scale.device != x.device or shift.device != x.device:
            raise ValueError("matmul_stats_cuda takes CUDA tensors")
        scale = scale.float().contiguous()
        shift = shift.float().contiguous()
        sc_ptr, sh_ptr = scale.data_ptr(), shift.data_ptr()
    lib = _kernels.load("matmul_stats")
    tiles_m = -(-m // lib.vt_matmul_stats_tile_m())
    y = torch.empty(m, n, dtype=x.dtype, device=x.device)
    ws = torch.empty(2, tiles_m, n, dtype=torch.float32, device=x.device)
    s = torch.empty(2, n, dtype=torch.float32, device=x.device)
    _kernels.check(
        lib.vt_matmul_stats(
            x.data_ptr(), w.data_ptr(), sc_ptr, sh_ptr, y.data_ptr(),
            ws.data_ptr(), s[0].data_ptr(), s[1].data_ptr(), m, k, n,
            int(x.dtype == torch.bfloat16), _kernels.stream_handle(x),
        ),
        "matmul_stats kernel",
    )
    return y, s[0], s[1]


def _forward(x, w, scale, shift) -> _Out:
    if x.device.type == "cpu":
        return matmul_stats_plain(x, w, scale, shift)
    return matmul_stats_cuda(x, w, scale, shift)


class _MatmulStats(torch.autograd.Function):
    """``vision_tpu/ops/_pallas/conv1x1_bn.py:_mm_np_bwd`` and
    ``_mm_p_bwd``. In bf16 the product ``dy @ w.T`` comes back rounded to
    bf16 before the ReLU mask, where the JAX package keeps it in f32."""

    @staticmethod
    def forward(ctx, x, w, scale, shift):
        y, s1, s2 = _forward(x, w, scale, shift)
        ctx.save_for_backward(x, w, scale, shift, y)
        return y, s1, s2

    @staticmethod
    def backward(ctx, dy, ds1, ds2):
        # autograd hands zeros for an output nobody used
        x, w, scale, shift, y = ctx.saved_tensors
        dyf = dy.float() + ds1[None, :] + 2.0 * y.float() * ds2[None, :]
        dy_c = dyf.to(x.dtype)
        w_c = w.to(x.dtype)
        if scale is None:
            dx = dy_c @ w_c.t()
            dw = (x.t() @ dy_c).to(w.dtype)
            return dx, dw, None, None
        z, xn = _prologue(x, scale, shift)
        dxn = (dy_c @ w_c.t()).float()
        dw = (xn.t() @ dy_c).to(w.dtype)
        dz = dxn * (z > 0)
        dx = (dz * scale.float()).to(x.dtype)
        dscale = (dz * x.float()).sum(0).to(scale.dtype)
        dshift = dz.sum(0).to(shift.dtype)
        return dx, dw, dscale, dshift


def matmul_stats(
    x: torch.Tensor,
    w: torch.Tensor,
    scale: Optional[torch.Tensor] = None,
    shift: Optional[torch.Tensor] = None,
) -> _Out:
    """``y = (relu(x*scale+shift) if scale else x) @ w`` with the per-column
    f32 sum and sum of squares of ``y``; differentiable in ``x``, ``w``,
    ``scale`` and ``shift``.

    Args:
      x: ``[M, K]`` activations (f32 or bf16).
      w: ``[K, N]`` weights (the 1x1 conv kernel as a matrix).
      scale, shift: optional ``[K]`` f32 per-channel affine applied with a
        ReLU before the product (the previous batch norm, folded).

    Returns:
      ``(y [M, N], s1 [N] f32, s2 [N] f32)``.
    """
    return _MatmulStats.apply(x, w, scale, shift)
