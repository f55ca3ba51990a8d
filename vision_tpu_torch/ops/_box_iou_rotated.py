"""Pairwise IoU of rotated boxes (counterpart of
``vision_tpu/ops/_box_iou_rotated.py``).

The same formulation as the JAX package, batched over the ``[N, M]`` pair
grid instead of a ``vmap``: all 24 candidate vertices of a pair's
intersection (16 edge-edge intersections, the 4 corners of each box that
lie inside the other) are computed at once, masked, sorted by angle around
their centroid (the intersection of two convex sets is convex) and
integrated with a masked shoelace fan. No data-dependent shapes.
"""

from __future__ import annotations

import torch

from vision_tpu_torch.ops import _box_convert as _bc

__all__ = ["box_iou_rotated"]


def _corners(boxes: torch.Tensor) -> torch.Tensor:
    """cxcywhr ``[..., 5]`` -> corners ``[..., 4, 2]``."""
    pts = _bc._box_xywhr_to_xyxyxyxy(_bc._box_cxcywhr_to_xywhr(boxes))
    return pts.reshape(*pts.shape[:-1], 4, 2)


def _inside(pts: torch.Tensor, quad: torch.Tensor) -> torch.Tensor:
    """``[..., P, 2]`` points inside the convex ``[..., 4, 2]`` quad: every
    cross product with its edges has the same sign."""
    a = quad[..., None, :, :]
    b = torch.roll(quad, -1, dims=-2)[..., None, :, :]
    cr = (b[..., 0] - a[..., 0]) * (pts[..., :, None, 1] - a[..., 1]) - (
        b[..., 1] - a[..., 1]) * (pts[..., :, None, 0] - a[..., 0])
    return (cr >= -1e-9).all(-1) | (cr <= 1e-9).all(-1)


def _intersection_area(c1: torch.Tensor, c2: torch.Tensor) -> torch.Tensor:
    """Corners ``[N, 1, 4, 2]`` and ``[1, M, 4, 2]`` of convex quads ->
    ``[N, M]`` intersection areas."""
    c1, c2 = torch.broadcast_tensors(c1, c2)
    p1, p2 = c1, torch.roll(c1, -1, dims=-2)  # edge starts, ends
    q1, q2 = c2, torch.roll(c2, -1, dims=-2)

    # 16 edge-edge intersections: [N, M, 4 (edge of 1), 4 (edge of 2)]
    d1 = (p2 - p1)[..., :, None, :]
    d2 = (q2 - q1)[..., None, :, :]
    w = q1[..., None, :, :] - p1[..., :, None, :]
    den = d1[..., 0] * d2[..., 1] - d1[..., 1] * d2[..., 0]
    safe = torch.where(den == 0, torch.ones_like(den), den)
    t = (w[..., 0] * d2[..., 1] - w[..., 1] * d2[..., 0]) / safe
    u = (w[..., 0] * d1[..., 1] - w[..., 1] * d1[..., 0]) / safe
    valid_int = (den != 0) & (t >= 0) & (t <= 1) & (u >= 0) & (u <= 1)
    pts_int = p1[..., :, None, :] + t[..., None] * d1
    pts_int = pts_int.flatten(-3, -2)  # [N, M, 16, 2]
    valid_int = valid_int.flatten(-2)

    pts = torch.cat([pts_int, c1, c2], dim=-2)  # [N, M, 24, 2]
    valid = torch.cat([valid_int, _inside(c1, c2), _inside(c2, c1)], dim=-1)
    num_valid = valid.sum(-1)

    centroid = torch.where(valid[..., None], pts, 0.0).sum(-2) / (
        num_valid.clamp(min=1)[..., None])
    ang = torch.atan2(pts[..., 1] - centroid[..., None, 1],
                      pts[..., 0] - centroid[..., None, 0])
    ang = torch.where(valid, ang, torch.inf)  # invalid points sort last
    order = torch.argsort(ang, dim=-1, stable=True)
    pts_sorted = torch.gather(pts, -2, order[..., None].expand_as(pts))
    valid_sorted = torch.gather(valid, -1, order)

    # masked shoelace fan from the first (valid) vertex: invalid points
    # become that vertex, so their triangles are degenerate
    p0 = pts_sorted[..., :1, :]
    fan = torch.where(valid_sorted[..., None], pts_sorted, p0)
    a, b = fan[..., :-1, :], fan[..., 1:, :]
    area2 = ((a[..., 0] - p0[..., 0]) * (b[..., 1] - p0[..., 1])
             - (a[..., 1] - p0[..., 1]) * (b[..., 0] - p0[..., 0])).sum(-1)
    return torch.where(num_valid >= 3, area2.abs() / 2.0, 0.0)


def box_iou_rotated(boxes1: torch.Tensor, boxes2: torch.Tensor) -> torch.Tensor:
    """Pairwise IoU of rotated boxes in cxcywhr (degrees) format.

    boxes1: ``[N, 5]``; boxes2: ``[M, 5]`` -> ``[N, M]`` f32.
    """
    boxes1, boxes2 = boxes1.float(), boxes2.float()
    inter = _intersection_area(_corners(boxes1)[:, None],
                               _corners(boxes2)[None, :])
    area1 = boxes1[:, 2] * boxes1[:, 3]
    area2 = boxes2[:, 2] * boxes2[:, 3]
    union = area1[:, None] + area2[None, :] - inter
    return torch.where(union > 0, inter / union, 0.0)
