"""FAST-16 corner detection (port of photogrammetry_tpu/ops/fast.py).

``fast_score_map`` here is the plain PyTorch version: 16 shifted copies of
the image and the circular-run recurrence as whole-tensor ops.  The
frontend calls the CUDA kernel in ``kernels/fast_stencil.py`` instead, and
that wrapper runs this function only for tensors on the CPU.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from photogrammetry_tpu_torch.utils.padding import PaddedPoints, front_indices

# Radius-3 Bresenham ring, positions 1..16 as (row, col) offsets relative to
# the center pixel, in ring order.
RING_OFFSETS = (
    (-3, 0), (-3, 1), (-2, 2), (-1, 3), (0, 3), (1, 3), (2, 2), (3, 1),
    (3, 0), (3, -1), (2, -2), (1, -3), (0, -3), (-1, -3), (-2, -2), (-3, -1),
)

BORDER = 3  # ring radius; detection excludes a 3px border
MIN_CONSECUTIVE = 12
INT32_MAX = 2 ** 31 - 1


def fast_score_map(image: torch.Tensor, threshold: float) -> torch.Tensor:
    """Dense FAST score map of an (H, W) or (B, H, W) image.

    Returns int32 of the same shape: 0 for non-corners, else the longest
    circular run of ring pixels outside the open band (c-thr, c+thr),
    12..16.  The band edges are formed in f32 as ``c - thr`` and ``c + thr``
    and compared with ``<=`` / ``>=``, exactly as the JAX version does.
    """
    img = image.to(torch.float32)
    h, w = img.shape[-2:]
    padded = F.pad(img, (BORDER, BORDER, BORDER, BORDER))
    thr = torch.tensor(threshold, dtype=torch.float32, device=img.device)
    lower = img - thr
    upper = img + thr
    outside = [
        (s <= lower) | (s >= upper)
        for s in (padded[..., BORDER + dr:BORDER + dr + h,
                         BORDER + dc:BORDER + dc + w]
                  for dr, dc in RING_OFFSETS)
    ]
    # runs over the doubled ring, backward: run_k = m_k * (1 + run_{k+1});
    # a fully-outside ring saturates at 16 by the cap below.
    run = torch.zeros(img.shape, dtype=torch.int32, device=img.device)
    best = torch.zeros_like(run)
    for k in range(31, -1, -1):
        run = outside[k % 16].to(torch.int32) * (1 + run)
        if k < 16:
            best = torch.maximum(best, run)
    score = torch.clamp(best, max=16)
    score = torch.where(score >= MIN_CONSECUTIVE, score, 0)
    rows = torch.arange(h, device=img.device)[:, None]
    cols = torch.arange(w, device=img.device)[None, :]
    interior = ((rows >= BORDER) & (rows < h - BORDER)
                & (cols >= BORDER) & (cols < w - BORDER))
    return torch.where(interior, score, 0).to(torch.int32)


def extract_keypoints(score_map: torch.Tensor, capacity: int,
                      order: str = "raster") -> PaddedPoints:
    """Dense (H, W) score map → fixed-capacity keypoints.

    ``order="raster"`` (the JAX default) keeps the detected pixels in
    row-major order, the reference's detection order; ``order="score"``
    sorts by score descending, raster ascending among equal scores.

    For the score order, the JAX key ``raster - score*h*w`` is unique for
    detected pixels; the INT32_MAX fill of the others ties, and
    ``lax.top_k`` breaks that tie by lower index.  Here the fill carries
    the raster index as well (``INT32_MAX - h*w + raster``, still above
    every detected key), so all keys are unique and ``torch.topk`` returns
    JAX's order exactly.
    """
    h, w = score_map.shape
    flat = score_map.reshape(-1).to(torch.int32)
    det = flat > 0
    total = det.sum().to(torch.int32)
    if order == "raster":
        idx = front_indices(det, capacity)
    elif order == "score":
        raster = torch.arange(h * w, dtype=torch.int32, device=flat.device)
        key = torch.where(det, raster - flat * (h * w),
                          (INT32_MAX - h * w) + raster)
        idx = torch.topk(-key, capacity).indices
    else:
        raise ValueError(f"unknown order {order!r}")
    valid = torch.arange(capacity, device=flat.device) < total
    coords = torch.stack([idx // w, idx % w], dim=-1).to(torch.int32)
    score = torch.where(valid, flat[idx].to(torch.float32), 0.0)
    count = torch.clamp(total, max=capacity)
    return PaddedPoints(coords=coords, score=score, mask=valid, count=count)
