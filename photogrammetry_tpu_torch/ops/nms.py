"""Keypoint redundancy reduction (port of photogrammetry_tpu/ops/nms.py).

Greedy radius NMS in three forms that give the same mask: the
score-ordered loop (``nms_keypoints``), the parallel fixed point that runs
until nothing changes (``nms_keypoints_parallel``) and the same with a
static round count (``nms_keypoints_static``, the frontend's default).
Each round of the fixed point keeps every active point not dominated by a
stronger active point within the radius, then deactivates everything near
a kept point.  ``anms_keypoints`` is adaptive NMS: the points farthest
from a stronger point survive.  Strength order everywhere: score
descending, original index ascending.
"""
from __future__ import annotations

import torch

from photogrammetry_tpu_torch.utils.padding import PaddedPoints, front_indices

F32_MAX = torch.finfo(torch.float32).max


def _strength_dominance(points: PaddedPoints):
    """(K, K) bool ``stronger[i, j]``: j is stronger than i (higher score,
    or the same score and a lower index)."""
    s = points.score
    idx = torch.arange(points.capacity, device=s.device)
    return (s[None, :] > s[:, None]) | \
        ((s[None, :] == s[:, None]) & (idx[None, :] < idx[:, None]))


def _pairwise_d2(coords: torch.Tensor) -> torch.Tensor:
    c = coords.to(torch.float32)
    return ((c[:, None, :] - c[None, :, :]) ** 2).sum(-1)


def _radius2(radius, device) -> torch.Tensor:
    return torch.tensor(radius, dtype=torch.float32, device=device) ** 2


def nms_keypoints(points: PaddedPoints, radius: float) -> PaddedPoints:
    """Greedy radius NMS, one kept-or-dropped decision per point in score
    order (the reference's loop, and JAX's ``fori_loop``): same capacity,
    updated mask/count.  K steps of whole-tensor ops; the point of each
    step is indexed by a one-element tensor, so the loop reads nothing
    back to the host."""
    coords = points.coords.to(torch.float32)
    r2 = _radius2(radius, coords.device)
    order = torch.argsort(-points.score, stable=True)
    active = points.mask.clone()
    kept = torch.zeros_like(active)
    for i in range(points.capacity):
        cur = order[i:i + 1]
        take = active[cur] & points.mask[cur]                 # (1,)
        kept = kept.index_put((cur,), take)
        d2 = ((coords - coords[cur]) ** 2).sum(-1)
        active = active & ~(take & (d2 <= r2))
    return PaddedPoints(points.coords, points.score, kept,
                        kept.sum().to(torch.int32))


def _fixed_point_round(dominates, near, active, kept):
    blocked = (dominates & active[None, :]).any(dim=1)
    new_kept = active & ~blocked
    suppressed = (near & new_kept[None, :]).any(dim=1)
    return active & ~suppressed, kept | new_kept, new_kept


def nms_keypoints_parallel(points: PaddedPoints,
                           radius: float) -> PaddedPoints:
    """Greedy radius NMS as a parallel fixed point, run until a round keeps
    nothing new (JAX's ``while_loop``): the same mask as ``nms_keypoints``
    in about chain-depth rounds.  Each round reads one flag back to the
    host (whether it kept anything), so a call costs one host sync a
    round."""
    near = _pairwise_d2(points.coords) <= _radius2(radius,
                                                   points.coords.device)
    dominates = near & _strength_dominance(points)
    active = points.mask
    kept = torch.zeros_like(active)
    changed = True
    while changed:
        active, kept, new_kept = _fixed_point_round(dominates, near, active,
                                                    kept)
        changed = bool(new_kept.any())
    return PaddedPoints(points.coords, points.score, kept,
                        kept.sum().to(torch.int32))


def nms_keypoints_static(points: PaddedPoints, radius: float,
                         rounds: int = 64) -> PaddedPoints:
    """The fixed point of ``nms_keypoints_parallel`` with a static round
    count: same capacity, updated mask/count.  Distances > radius survive
    (strict)."""
    near = _pairwise_d2(points.coords) <= _radius2(radius,
                                                   points.coords.device)
    dominates = near & _strength_dominance(points)
    active = points.mask
    kept = torch.zeros_like(active)
    for _ in range(rounds):
        active, kept, _ = _fixed_point_round(dominates, near, active, kept)
    return PaddedPoints(points.coords, points.score, kept,
                        kept.sum().to(torch.int32))


def anms_keypoints(points: PaddedPoints, num_keep: int) -> PaddedPoints:
    """Adaptive non-maximal suppression (Brown et al.): each point's radius
    is its squared distance to the nearest stronger valid point; the
    ``num_keep`` points with the largest radii survive, near-ties resolved
    by strength rank (key ``radius2 - rank / (K + 1)``).

    JAX takes ``lax.top_k`` of the key, which puts the lower index first
    among equal keys; ``torch.topk`` promises no order among ties on the
    card, and at large radii the rank term vanishes in f32 (radius2 above
    ~1.6e7 at K = 1024), so equal keys are real.  A stable descending sort,
    first ``num_keep``, gives JAX's choice."""
    k = points.capacity
    stronger = _strength_dominance(points) & points.mask[None, :]
    d2 = _pairwise_d2(points.coords)
    radius2 = torch.where(stronger, d2, F32_MAX).min(dim=1).values
    radius2 = torch.where(points.mask, radius2, -1.0)
    order = torch.argsort(-points.score, stable=True)
    rank = torch.empty_like(order)
    rank[order] = torch.arange(k, device=order.device)
    key = radius2 - rank.to(torch.float32) / (k + 1.0)
    keep_idx = torch.sort(key, descending=True,
                          stable=True).indices[:min(num_keep, k)]
    kept = torch.zeros_like(points.mask)
    kept[keep_idx] = True
    kept = kept & points.mask
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
