"""Full (non-causal) scaled dot-product attention (counterpart of
``vision_tpu/ops/attention.py``).

The JAX function computes the product outside any kernel of the repo: at
ViT-B/16's 197 tokens it takes its einsum path, and past a few hundred
tokens on a TPU it calls JAX's own library flash kernel. So on the card
this calls ``torch.nn.functional.scaled_dot_product_attention``, as a plain
product calls ``torch.matmul``; on the CPU it runs
``attention_plain``, the JAX einsum path's arithmetic.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F

__all__ = ["attention_plain", "scaled_dot_product_attention"]


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


def scaled_dot_product_attention(q: torch.Tensor, k: torch.Tensor,
                                 v: torch.Tensor,
                                 scale: Optional[float] = None) -> torch.Tensor:
    """q, k, v: ``[B, H, S, D]`` -> ``[B, H, S, D]``; ``scale`` defaults to
    ``1 / sqrt(D)``."""
    if q.device.type == "cpu":
        return attention_plain(q, k, v, scale)
    return F.scaled_dot_product_attention(q, k, v, scale=scale)
