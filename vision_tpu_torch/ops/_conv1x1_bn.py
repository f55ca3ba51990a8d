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

* :func:`matmul_stats` — the differentiable entry: a CUDA kernel for
  tensors on the card, the plain PyTorch version for tensors on the CPU.
* :func:`matmul_stats_cuda` — the kernels' wrapper. :func:`choose_kernel`
  sends a call to one of three: ``csrc/matmul_stats_wgmma.cu`` (bf16, on the
  tensor cores), ``csrc/matmul_stats_fma.cu`` (f32, pipelined FP32 FMAs) or
  ``csrc/matmul_stats.cu`` (the guarded kernel for every other shape);
  :func:`matmul_stats_wgmma_cuda`, :func:`matmul_stats_fma_cuda` and
  :func:`matmul_stats_general_cuda` call each directly.
* :func:`matmul_stats_plain` — the plain version.

The backward pass is plain PyTorch in both cases, as it is plain XLA in the
JAX package: the cotangents of the sums fold into the output's,
``dy + ds1 + 2 * y * ds2``, and two matrix products follow.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from vision_tpu_torch import _kernels

__all__ = [
    "choose_kernel", "matmul_stats", "matmul_stats_cuda",
    "matmul_stats_fma_cuda", "matmul_stats_general_cuda",
    "matmul_stats_plain", "matmul_stats_wgmma_cuda",
]

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


def choose_kernel(m: int, k: int, n: int, dtype: torch.dtype,
                  w_strides: Tuple[int, int], aligned: bool = True) -> str:
    """Which kernel a call goes to, from its shapes, type and the strides
    of ``w [K, N]`` alone: ``"wgmma"`` (bf16, ``csrc/matmul_stats_wgmma.cu``),
    ``"fma"`` (f32, ``csrc/matmul_stats_fma.cu``) or ``"general"``
    (``csrc/matmul_stats.cu``, any shape, either type).

    The two fast kernels move 16 bytes at a time (TMA boxes, ``cp.async``
    chunks, vector stores), i.e. ``unit`` = 8 bf16 or 4 f32 elements. They
    take a call when ``K >= unit``, ``K`` and ``N`` are multiples of
    ``unit``, ``w`` has a unit stride along K or along N with the other
    stride a multiple of ``unit``, and every pointer is 16-byte aligned
    (``aligned``). Everything else, ``K == 0`` included, goes to the general
    kernel. Every 1x1 convolution of a ResNet (K, N multiples of 64) takes a
    fast kernel."""
    unit = 8 if dtype == torch.bfloat16 else 4
    sk, sn = w_strides
    w_ok = ((sk == 1 and sn >= k and sn % unit == 0)
            or (sn == 1 and sk >= n and sk % unit == 0))
    if aligned and w_ok and k >= unit and k % unit == 0 and n % unit == 0:
        return "wgmma" if dtype == torch.bfloat16 else "fma"
    return "general"


def _check_args(x, w, scale, shift):
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
    if scale is not None:
        if scale.shape != (k,) or shift.shape != (k,):
            raise ValueError(f"scale and shift must be [{k}]")
        if scale.device != x.device or shift.device != x.device:
            raise ValueError("matmul_stats_cuda takes CUDA tensors")
        scale = scale.float().contiguous()
        shift = shift.float().contiguous()
    return x.contiguous(), scale, shift


def _launch(name: str, x, w, scale, shift) -> _Out:
    """Allocate the outputs and the workspace and call kernel ``name`` of
    :func:`choose_kernel`. ``w`` as the kernel takes it: contiguous for the
    general kernel, either unit stride for the other two."""
    m, k = x.shape
    n = w.shape[1]
    sc_ptr = None if scale is None else scale.data_ptr()
    sh_ptr = None if shift is None else shift.data_ptr()
    y = torch.empty(m, n, dtype=x.dtype, device=x.device)
    if name == "general":
        lib = _kernels.load("matmul_stats")
        tile_m = lib.vt_matmul_stats_tile_m()
    else:
        lib = _kernels.load(f"matmul_stats_{name}")
        tile_m = getattr(lib, f"vt_matmul_stats_{name}_tile_m")(m, n)
    # one allocation: the sums [2, N], then the workspace [2, tiles_m, N]
    buf = torch.empty(2 + 2 * -(-m // tile_m), n, dtype=torch.float32,
                      device=x.device)
    s_ptr = buf.data_ptr()
    head = (x.data_ptr(), w.data_ptr(), sc_ptr, sh_ptr, y.data_ptr(),
            s_ptr + 8 * n, s_ptr, s_ptr + 4 * n, m, k, n)
    if name == "general":
        err = lib.vt_matmul_stats(*head, int(x.dtype == torch.bfloat16),
                                  _kernels.stream_handle(x))
    else:
        err = getattr(lib, f"vt_matmul_stats_{name}")(
            *head, x.stride(0), w.stride(0), w.stride(1),
            _kernels.stream_handle(x))
    _kernels.check(err, f"matmul_stats {name} kernel")
    return y, buf[0], buf[1]


def _aligned(*tensors) -> bool:
    return all(t is None or t.data_ptr() % 16 == 0 for t in tensors)


def _checked_for(name: str, x, w, scale, shift):
    """The arguments checked for a direct call of kernel ``name``: raises on
    what :func:`choose_kernel` would not send it."""
    x, scale, shift = _check_args(x, w, scale, shift)
    chosen = choose_kernel(x.shape[0], x.shape[1], w.shape[1], x.dtype,
                           w.stride(), _aligned(x, w, scale, shift))
    if name != "general" and chosen != name:
        raise ValueError(
            f"the {name} kernel does not take x {tuple(x.shape)} {x.dtype} "
            f"and w {tuple(w.shape)} with strides {w.stride()}: "
            f"choose_kernel sends them to {chosen!r}")
    return x, scale, shift


@_kernels.counted
def matmul_stats_wgmma_cuda(x, w, scale=None, shift=None, *,
                            _checked=False) -> _Out:
    """The bf16 tensor-core kernel of ``csrc/matmul_stats_wgmma.cu``, called
    directly."""
    if not _checked:
        x, scale, shift = _checked_for("wgmma", x, w, scale, shift)
    return _launch("wgmma", x, w, scale, shift)


@_kernels.counted
def matmul_stats_fma_cuda(x, w, scale=None, shift=None, *,
                          _checked=False) -> _Out:
    """The pipelined f32 kernel of ``csrc/matmul_stats_fma.cu``, called
    directly."""
    if not _checked:
        x, scale, shift = _checked_for("fma", x, w, scale, shift)
    return _launch("fma", x, w, scale, shift)


@_kernels.counted
def matmul_stats_general_cuda(x, w, scale=None, shift=None, *,
                              _checked=False) -> _Out:
    """The guarded kernel of ``csrc/matmul_stats.cu``, called directly: any
    M, K, N with M, N >= 1, f32 or bf16; ``w`` is made contiguous."""
    if not _checked:
        x, scale, shift = _checked_for("general", x, w, scale, shift)
    return _launch("general", x, w.contiguous(), scale, shift)


_CUDA_KERNELS = {
    "wgmma": matmul_stats_wgmma_cuda,
    "fma": matmul_stats_fma_cuda,
    "general": matmul_stats_general_cuda,
}


@_kernels.counted
def matmul_stats_cuda(
    x: torch.Tensor,
    w: torch.Tensor,
    scale: Optional[torch.Tensor] = None,
    shift: Optional[torch.Tensor] = None,
) -> _Out:
    """The kernels' wrapper (same contract as :func:`matmul_stats_plain`):
    ``x`` and ``w`` both f32 or both bf16, any M, K, N with M, N >= 1; ``w``
    may be a transposed view and is then read where it lies. The call goes
    to the one kernel :func:`choose_kernel` names, and a failure of that
    kernel is raised, never retried on another. Two launches per call: the
    product with the per-tile column sums, then the sum over the tiles. Its
    count is the sum of the three kernels' counts."""
    x, scale, shift = _check_args(x, w, scale, shift)
    name = choose_kernel(x.shape[0], x.shape[1], w.shape[1], x.dtype,
                         w.stride(), _aligned(x, w, scale, shift))
    return _CUDA_KERNELS[name](x, w, scale, shift, _checked=True)


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
