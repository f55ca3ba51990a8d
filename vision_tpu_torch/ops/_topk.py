"""Top-k with a fixed tie order (counterpart of ``vision_tpu/ops/_topk.py``).

``torch.topk`` on CUDA promises no order among equal values, and the
presorted-NMS contract (``ops/nms.py``: rows in descending score order,
ties in index order) depends on one. A stable descending sort gives it on
every device. The JAX package reaches the same set through a row-max
decomposition (``top_k_flat``); the two differ only in the order inside a
class of exactly equal values.
"""

from __future__ import annotations

from typing import Tuple

import torch

__all__ = ["top_k"]


def top_k(x: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The ``k`` largest values along the last dim, in descending order
    with ties in index order, and their indices."""
    values, indices = torch.sort(x, dim=-1, descending=True, stable=True)
    return values[..., :k], indices[..., :k]
