"""Top-k with a fixed tie order (counterpart of ``vision_tpu/ops/_topk.py``).

``torch.topk`` on CUDA promises no order among equal values, and the
presorted-NMS contract (``ops/nms.py``: rows in descending score order,
ties in index order) depends on one. A stable descending sort gives it on
every device. The JAX package reaches the same set through a row-max
decomposition (``top_k_flat``); the two differ only in the order inside a
class of exactly equal values.

RetinaNet's per-level candidates are a top-k over ``[H*W*A, K]`` scores
(23.1 M at P3 on the 1344 canvas), where a sort of them all would be the
postprocess's largest cost. :func:`top_k_2d` gives the same values and
indices as :func:`top_k` of the flattened scores through the JAX package's
row-max decomposition. On an H100 (700 W) at P3 it took 0.42 ms against
2.31 for the sort of all the scores and 3.93 for one ``torch.topk`` over
unique int64 keys (``chip_smoke.py``, line ``topk_retinanet``, which
times the three).
"""

from __future__ import annotations

from typing import Tuple

import torch

__all__ = ["top_k", "top_k_2d"]


def top_k(x: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The ``k`` largest values along the last dim, in descending order
    with ties in index order, and their indices."""
    values, indices = torch.sort(x, dim=-1, descending=True, stable=True)
    return values[..., :k], indices[..., :k]


def top_k_2d(scores: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """:func:`top_k` of ``scores [..., R, K]`` flattened over its last two
    dims: values ``[..., k]`` and flat indices ``[..., k]``, equal to it
    element for element.

    Every element of the top k lies in one of the k rows whose maximum
    ranks highest (ties by row index): a row holds an element at least the
    k-th largest only if its maximum does, and of the rows that reach it
    only as many as the top k needs are taken, lowest first. Those rows,
    put back in their own order, keep the flat order of the elements, so
    a stable top k over their ``k * K`` values breaks ties as the full one
    does. Where ``k >= R`` or ``K == 1`` the decomposition saves nothing and
    :func:`top_k` runs on the flat scores."""
    *lead, r, kk = scores.shape
    if k > r * kk:
        raise ValueError(f"k={k} > elements={r * kk}")
    if k >= r or kk == 1:
        return top_k(scores.reshape(*lead, r * kk), k)
    _, rows = top_k(scores.amax(-1), k)
    rows = rows.sort(-1).values
    cand = torch.gather(scores, -2, rows[..., None].expand(*rows.shape, kk))
    values, flat = top_k(cand.reshape(*lead, k * kk), k)
    return values, torch.gather(rows, -1, flat // kk) * kk + flat % kk
