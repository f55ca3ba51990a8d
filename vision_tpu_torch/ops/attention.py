"""Full (non-causal) scaled dot-product attention (counterpart of
``vision_tpu/ops/attention.py``).

The JAX function takes one of two paths. Past its gate (``_flash_supported``:
a head dim that is a multiple of 128, or 64 at 512 tokens and more) a TPU
runs JAX's library Pallas flash kernel, forward and backward
(``jax/experimental/pallas/ops/tpu/flash_attention.py``: the forward's
``pallas_call`` at l.758, ``_flash_attention_bwd_dkv``'s at l.1121,
``_flash_attention_bwd_dq``'s at l.1456). Below it, the product is a plain
einsum outside any kernel.

The port keeps the gate. Past it, :func:`flash_attention` runs the
hand-written kernels of ``csrc/flash_attention.cu`` (forward) and
``csrc/flash_attention_backward.cu`` (the dK/dV and dQ kernels) on a CUDA
tensor, and their plain versions (:func:`flash_attention_plain`,
:func:`flash_attention_dkv_plain`, :func:`flash_attention_dq_plain`) on a
CPU tensor; the device type takes the place of JAX's backend test. Below
the gate the card calls ``torch.nn.functional.scaled_dot_product_attention``,
as a plain product calls ``torch.matmul``, and the CPU runs
:func:`attention_plain`, the JAX einsum path's arithmetic.

Differences from the library kernel, by design: keys past the sequence are
masked inside the kernels (JAX pads to 128 and gives the padding its own
segment id, ``vision_tpu/ops/attention.py:64-76``; the padded rows are
sliced off, so the result is the same); the output is normalised once at
the end (the library kernel renormalises its accumulator at every 128-key
block); the saved row statistic is ``lse = m + log(l)`` in f32 (the
library saves ``m`` and ``l``), and the backward recomputes
``p = exp(s - lse)``. In bf16 the probabilities ``p`` are rounded to bf16
against another running maximum than the library's, so the two part by
bf16 roundings of ``p``. The f32 kernels, forward and backward, take every
product on the tensor cores as three TF32 products (``x = hi + lo``,
``a_hi b_lo + a_lo b_hi + a_hi b_hi`` summed in f32), whatever
``torch.backends.cuda.matmul.allow_tf32`` says: f32 accuracy, held to the
plain f32 versions on the card at 1e-5 of the largest output and 1e-5 on
``lse`` (forward) and at 1e-4 of the largest gradient (backward). The bf16
kernels take theirs on ``wgmma`` with operands arriving by TMA.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from vision_tpu_torch import _kernels

__all__ = [
    "FLASH_HEAD_DIMS",
    "attention_plain",
    "flash_attention",
    "flash_attention_backward_plain",
    "flash_attention_dkv_cuda",
    "flash_attention_dkv_plain",
    "flash_attention_dq_cuda",
    "flash_attention_dq_plain",
    "flash_attention_forward_cuda",
    "flash_attention_plain",
    "scaled_dot_product_attention",
]

# the head dims the flash kernels are built for; the zoo reaches the gate
# only at 64 (ViT-B/16 at 384, ViT-L/16 at 512)
FLASH_HEAD_DIMS = (64, 128)
KERNEL_DTYPES = (torch.float32, torch.bfloat16)


def attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    scale: Optional[float] = None) -> torch.Tensor:
    """``softmax(q k^T * scale) v`` as the JAX einsum path computes it: the
    scores and the softmax in f32 whatever the inputs' type, the weights
    cast to ``v``'s type before the second product."""
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    attn = torch.matmul(q.float(), k.float().transpose(-2, -1)) * scale
    attn = torch.softmax(attn, dim=-1).to(v.dtype)
    return torch.matmul(attn, v)


def _flash_supported(q: torch.Tensor) -> bool:
    """The JAX gate's shape rule (``vision_tpu/ops/attention.py:28-42``):
    a head dim that is a multiple of 128, or 64 at 512 tokens and more."""
    _, _, s, d = q.shape
    return d % 128 == 0 or (d == 64 and s >= 512)


def _scale(q: torch.Tensor, scale: Optional[float]) -> float:
    return 1.0 / math.sqrt(q.shape[-1]) if scale is None else float(scale)


def _scores(q, k, scale):
    """``q k^T`` summed in f32, then times ``scale``."""
    return torch.matmul(q.float(), k.float().transpose(-2, -1)) * scale


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          scale: Optional[float] = None
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The forward kernel's plain version: ``q, k, v [B, H, S, D]`` ->
    ``(o [B, H, S, D], lse [B, H, S] f32)``, in the library kernel's
    arithmetic (``flash_attention.py:385-474``): the scores summed in f32
    and times ``scale``, the row maximum ``m`` and sum ``l`` in f32,
    ``p = exp(s - m)`` cast to ``v``'s type before ``p v``, an f32 sum, the
    output divided by ``l`` once and cast to ``q``'s type.
    ``lse = m + log(l)``."""
    scale = _scale(q, scale)
    s = _scores(q, k, scale)
    m = s.amax(-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(-1, keepdim=True)
    o = torch.matmul(p.to(v.dtype).float(), v.float()) / l
    return o.to(q.dtype), (m + torch.log(l)).squeeze(-1)


def _probs(q, k, lse, scale):
    return torch.exp(_scores(q, k, scale) - lse[..., None])


def flash_attention_dkv_plain(q, k, v, do, lse, di,
                              scale: Optional[float] = None):
    """The dK/dV kernel's plain version (``flash_attention.py:894-918``):
    ``p = exp(scale q k^T - lse)``, ``dv = p^T do`` with ``p`` cast to
    ``do``'s type, ``ds = p (do v^T - di) scale``, ``dk = ds^T q`` with
    ``ds`` cast to ``do``'s type; every sum in f32, each gradient cast to
    its input's type. ``di = sum(o do)`` over the head dim, in f32."""
    scale = _scale(q, scale)
    p = _probs(q, k, lse, scale)
    dof = do.float()
    dv = torch.matmul(p.to(do.dtype).float().transpose(-2, -1), dof)
    ds = p * (torch.matmul(dof, v.float().transpose(-2, -1)) - di[..., None])
    ds = ds * scale
    dk = torch.matmul(ds.to(do.dtype).float().transpose(-2, -1), q.float())
    return dk.to(k.dtype), dv.to(v.dtype)


def flash_attention_dq_plain(q, k, v, do, lse, di,
                             scale: Optional[float] = None):
    """The dQ kernel's plain version (``flash_attention.py:1225-1261``):
    ``ds`` as in :func:`flash_attention_dkv_plain`, ``dq = ds k`` with
    ``ds`` cast to ``k``'s type, an f32 sum cast to ``q``'s type."""
    scale = _scale(q, scale)
    p = _probs(q, k, lse, scale)
    ds = p * (torch.matmul(do.float(), v.float().transpose(-2, -1))
              - di[..., None]) * scale
    return torch.matmul(ds.to(k.dtype).float(), k.float()).to(q.dtype)


def _di(o, do):
    """``sum(o do)`` over the head dim in f32 (JAX takes it with ``jnp.sum``
    outside its kernels, ``flash_attention.py:273-275``)."""
    return (o.float() * do.float()).sum(-1)


def flash_attention_backward_plain(q, k, v, o, do, lse,
                                   scale: Optional[float] = None):
    """``(dq, dk, dv)`` of :func:`flash_attention_plain` through the two
    backward kernels' plain versions."""
    di = _di(o, do)
    dk, dv = flash_attention_dkv_plain(q, k, v, do, lse, di, scale)
    return flash_attention_dq_plain(q, k, v, do, lse, di, scale), dk, dv


def _check(name: str, *tensors: torch.Tensor) -> None:
    """What every flash kernel takes: CUDA tensors ``[B, H, S, D]`` of one
    type, f32 or bf16, with D in ``FLASH_HEAD_DIMS``."""
    q = tensors[0]
    if any(t.dtype != q.dtype for t in tensors) or q.dtype not in KERNEL_DTYPES:
        raise ValueError(f"{name} takes f32 or bf16 tensors of one type, got "
                         f"{[t.dtype for t in tensors]}")
    if any(t.device.type != "cuda" or t.device != q.device for t in tensors):
        raise ValueError(f"{name} takes CUDA tensors on one device")
    if q.dim() != 4 or any(t.shape != q.shape for t in tensors):
        raise ValueError(f"{name} takes q, k, v [B, H, S, D] of one shape, got "
                         f"{[tuple(t.shape) for t in tensors]}")
    if q.shape[-1] not in FLASH_HEAD_DIMS:
        raise ValueError(f"{name}: head dim {q.shape[-1]} is not one the "
                         f"kernels are built for, {FLASH_HEAD_DIMS}")


def _readable(t: torch.Tensor) -> torch.Tensor:
    """``t`` as the kernels read it: unit stride in the head dim, rows of 16
    bytes at 16-byte addresses, batch, head and row strides any positive
    multiple of those 16 bytes where the dimension is longer than 1 (a view
    of the packed q, k, v projection passes as it lies; the bf16 backward
    kernels' tensor maps take no other); otherwise a contiguous copy."""
    per16 = 16 // t.element_size()
    ok = (t.stride(3) == 1 and t.data_ptr() % 16 == 0
          and all(st % per16 == 0 and (st > 0 or n == 1)
                  for st, n in zip(t.stride()[:3], t.shape[:3])))
    return t if ok else t.contiguous()


def _strides(t: torch.Tensor):
    return t.stride(0), t.stride(1), t.stride(2)


@_kernels.counted
def flash_attention_forward_cuda(q: torch.Tensor, k: torch.Tensor,
                                 v: torch.Tensor,
                                 scale: Optional[float] = None
                                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The kernel of ``csrc/flash_attention.cu`` (same contract as
    :func:`flash_attention_plain`). ``q``, ``k`` and ``v`` are read through
    their strides (``_readable``); ``o`` is contiguous. A block owns its
    query rows and walks every key in order: no atomics, the same bits on
    every call. In f32 each product is three TF32 tensor-core products at
    f32 accuracy, whatever ``allow_tf32`` says; in bf16 the products run on
    ``wgmma``, k and v arriving by TMA (a tensor map the driver refuses
    raises). No host synchronisation."""
    _check("flash_attention_forward_cuda", q, k, v)
    q, k, v = (_readable(t) for t in (q, k, v))
    b, h, s, d = q.shape
    o = torch.empty(b, h, s, d, dtype=q.dtype, device=q.device)
    lse = torch.empty(b, h, s, dtype=torch.float32, device=q.device)
    lib = _kernels.load("flash_attention")
    _kernels.check(
        lib.vt_flash_attention_forward(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            lse.data_ptr(), b, h, s, d, *_strides(q), *_strides(k),
            *_strides(v), _scale(q, scale), int(q.dtype == torch.bfloat16),
            _kernels.stream_handle(q)),
        "flash_attention forward kernel")
    return o, lse


def _backward_args(name, q, k, v, do, lse, di):
    _check(name, q, k, v, do)
    b, h, s, _ = q.shape
    for t in (lse, di):
        if t.dtype != torch.float32 or tuple(t.shape) != (b, h, s) or (
                t.device != q.device):
            raise ValueError(f"{name} takes lse and di [B, H, S] f32 on q's "
                             f"device, got {t.dtype} {tuple(t.shape)}")
    q, k, v, do = (_readable(t) for t in (q, k, v, do))
    return q, k, v, do, lse.contiguous(), di.contiguous()


def _launch_backward(fn, what, q, k, v, do, lse, di, outs, scale):
    b, h, s, d = q.shape
    _kernels.check(
        fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
           lse.data_ptr(), di.data_ptr(), *[t.data_ptr() for t in outs],
           b, h, s, d, *_strides(q), *_strides(k), *_strides(v),
           *_strides(do), _scale(q, scale), int(q.dtype == torch.bfloat16),
           _kernels.stream_handle(q)),
        what)


@_kernels.counted
def flash_attention_dkv_cuda(q, k, v, do, lse, di,
                             scale: Optional[float] = None):
    """The dK/dV kernel of ``csrc/flash_attention_backward.cu`` (same
    contract as :func:`flash_attention_dkv_plain`): ``(dk, dv)``,
    contiguous. A block owns a key tile and sums over every query in
    order: no atomics, the same bits on every call. In f32 each product is
    three TF32 tensor-core products at f32 accuracy, whatever
    ``allow_tf32`` says. No host synchronisation."""
    q, k, v, do, lse, di = _backward_args("flash_attention_dkv_cuda", q, k, v,
                                          do, lse, di)
    dk = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    dv = torch.empty_like(dk)
    lib = _kernels.load("flash_attention_backward")
    _launch_backward(lib.vt_flash_attention_dkv, "flash_attention dkv kernel",
                     q, k, v, do, lse, di, (dk, dv), scale)
    return dk, dv


@_kernels.counted
def flash_attention_dq_cuda(q, k, v, do, lse, di,
                            scale: Optional[float] = None):
    """The dQ kernel of ``csrc/flash_attention_backward.cu`` (same contract
    as :func:`flash_attention_dq_plain`): ``dq``, contiguous. A block owns
    a query tile and sums over every key in order: no atomics. In f32 each
    product is three TF32 tensor-core products at f32 accuracy, whatever
    ``allow_tf32`` says. No host synchronisation."""
    q, k, v, do, lse, di = _backward_args("flash_attention_dq_cuda", q, k, v,
                                          do, lse, di)
    dq = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    lib = _kernels.load("flash_attention_backward")
    _launch_backward(lib.vt_flash_attention_dq, "flash_attention dq kernel",
                     q, k, v, do, lse, di, (dq,), scale)
    return dq


def _forward(q, k, v, scale):
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, scale)
    return flash_attention_forward_cuda(q, k, v, scale)


class _FlashAttention(torch.autograd.Function):
    """The forward kernel, saving ``lse``; the backward takes ``di`` with a
    torch reduction, then runs the dK/dV and the dQ kernels (their plain
    versions on the CPU)."""

    @staticmethod
    def forward(ctx, q, k, v, scale):
        o, lse = _forward(q, k, v, scale)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.scale = scale
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        di = _di(o, do)
        if q.device.type == "cpu":
            dkv, dq = flash_attention_dkv_plain, flash_attention_dq_plain
        else:
            dkv, dq = flash_attention_dkv_cuda, flash_attention_dq_cuda
        dk, dv = dkv(q, k, v, do, lse, di, ctx.scale)
        return dq(q, k, v, do, lse, di, ctx.scale), dk, dv, None


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    scale: Optional[float] = None) -> torch.Tensor:
    """``softmax(q k^T * scale) v`` through the flash kernels (the plain
    versions on the CPU): ``q, k, v [B, H, S, D]``, f32 or bf16. On the
    card D is one of ``FLASH_HEAD_DIMS`` (the kernels raise on another);
    the plain versions take any D, as JAX's CPU path does. Differentiable
    in all three; where no gradient is wanted, nothing is saved for one."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        return _FlashAttention.apply(q, k, v, scale)
    return _forward(q, k, v, scale)[0]


def scaled_dot_product_attention(q: torch.Tensor, k: torch.Tensor,
                                 v: torch.Tensor,
                                 scale: Optional[float] = None) -> torch.Tensor:
    """q, k, v: ``[B, H, S, D]`` -> ``[B, H, S, D]``; ``scale`` defaults to
    ``1 / sqrt(D)``. Past the gate, :func:`flash_attention`; below it,
    ``attention_plain`` on the CPU and PyTorch's fused attention on the
    card."""
    if _flash_supported(q):
        return flash_attention(q, k, v, scale)
    if q.device.type == "cpu":
        return attention_plain(q, k, v, scale)
    return F.scaled_dot_product_attention(q, k, v, scale=scale)
