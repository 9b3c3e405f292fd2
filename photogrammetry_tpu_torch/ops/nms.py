"""Score-ordered non-maximum suppression (port of
photogrammetry_tpu/ops/nms.py: ``nms_keypoints_static``, ``compact_points``).

Greedy radius NMS as a parallel fixed point with a static round count: each
round keeps every active point not dominated by a stronger active point
within the radius, then deactivates everything near a kept point.
"""
from __future__ import annotations

import torch

from photogrammetry_tpu_torch.utils.padding import PaddedPoints, front_indices


def nms_keypoints_static(points: PaddedPoints, radius: float,
                         rounds: int = 64) -> PaddedPoints:
    """Same capacity, updated mask/count.  Strength order: score desc,
    original index asc; distances > radius survive (strict)."""
    coords = points.coords.to(torch.float32)
    r2 = torch.tensor(radius, dtype=torch.float32,
                      device=coords.device) ** 2
    k = points.capacity
    d2 = ((coords[:, None, :] - coords[None, :, :]) ** 2).sum(-1)
    near = d2 <= r2
    idx = torch.arange(k, device=coords.device)
    s = points.score
    stronger = (s[None, :] > s[:, None]) | \
        ((s[None, :] == s[:, None]) & (idx[None, :] < idx[:, None]))
    dominates = near & stronger

    active = points.mask
    kept = torch.zeros_like(active)
    for _ in range(rounds):
        blocked = (dominates & active[None, :]).any(dim=1)
        new_kept = active & ~blocked
        suppressed = (near & new_kept[None, :]).any(dim=1)
        active = active & ~suppressed
        kept = kept | new_kept
    return PaddedPoints(points.coords, points.score, kept,
                        kept.sum().to(torch.int32))


def compact_points(points: PaddedPoints, capacity: int) -> PaddedPoints:
    """Pack the masked entries to the front (order-stable), new capacity."""
    idx = front_indices(points.mask, capacity)
    n = torch.clamp(points.count, max=capacity)
    valid = torch.arange(capacity, device=idx.device) < n
    return PaddedPoints(
        coords=points.coords[idx],
        score=torch.where(valid, points.score[idx], 0.0),
        mask=valid,
        count=n,
    )
