"""Plain reference of the frontend the benchmark's cells drive: FAST-16
scores, keypoints by score, greedy radius NMS, BRIEF bits on the JAX pair
table, subpixel corner refinement and mutual-nearest Hamming matching.

Written from the semantics the port documents (``sfm/frontend.py``,
``ops/{fast,nms,brief,refine,match}.py``), in plain PyTorch and NumPy; it
imports nothing of the port.  NMS is the greedy loop itself (the port runs
a fixed point of it with a static round count), extraction sorts the
detected pixels on the host, and Hamming distances are counted from the
bits in float64.  ``dtype`` is the precision of the image arithmetic:
float32 for the reference, bfloat16 for the control.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F

from reference import prng

RING = ((-3, 0), (-3, 1), (-2, 2), (-1, 3), (0, 3), (1, 3), (2, 2), (3, 1),
        (3, 0), (3, -1), (2, -2), (1, -3), (0, -3), (-1, -3), (-2, -2),
        (-3, -1))
BORDER = 3
MIN_RUN = 12
INT_INF = 2 ** 31 - 1


class Features(NamedTuple):
    """One frame's features as numpy: the slot layout the port uses
    (detected points compacted to the front of ``capacity`` slots)."""
    coords: np.ndarray   # (K, 2) int32 (row, col), 0 past count
    score: np.ndarray    # (K,) float32, 0 past count
    mask: np.ndarray     # (K,) bool
    bits: np.ndarray     # (K, P) uint8, rows past count zero
    xy: np.ndarray       # (K, 2) float32 refined (x, y); past count unused


def pair_table(seed: int, sigma: float, num_pairs: int) -> np.ndarray:
    """(P, 2, 2) int32 BRIEF offsets ((a_row, a_col), (b_row, b_col)):
    ``jax.random.normal(PRNGKey(seed), (P, 2, 2)) * sigma`` rounded half to
    even."""
    pts = prng.normal(prng.prng_key(seed), (num_pairs, 2, 2)) \
        * np.float32(sigma)
    return np.rint(pts).astype(np.int32)


def fast_scores(img: torch.Tensor, threshold: float) -> torch.Tensor:
    """(H, W) int32 FAST-16 score: the longest circular run (12..16) of
    ring pixels at or beyond the band edges c - thr, c + thr, formed in
    ``img``'s dtype; 0 elsewhere and within 3 px of the border."""
    h, w = img.shape
    pad = F.pad(img[None, None].float(), (3, 3, 3, 3))[0, 0].to(img.dtype)
    thr = torch.tensor(threshold, dtype=img.dtype, device=img.device)
    lo, hi = img - thr, img + thr
    out = [(s <= lo) | (s >= hi) for s in
           (pad[3 + dr:3 + dr + h, 3 + dc:3 + dc + w] for dr, dc in RING)]
    run = torch.zeros((h, w), dtype=torch.int32, device=img.device)
    best = torch.zeros_like(run)
    for k in range(31, -1, -1):
        run = out[k % 16].to(torch.int32) * (1 + run)
        if k < 16:
            best = torch.maximum(best, run)
    score = torch.clamp(best, max=16)
    score = torch.where(score >= MIN_RUN, score, 0)
    score[:BORDER] = 0
    score[h - BORDER:] = 0
    score[:, :BORDER] = 0
    score[:, w - BORDER:] = 0
    return score


def strongest(score: torch.Tensor, capacity: int):
    """The ``capacity`` strongest detections, score descending and raster
    order among equal scores: ((n, 2) int64 (row, col), (n,) scores)."""
    h, w = score.shape
    flat = score.reshape(-1)
    idx = torch.nonzero(flat > 0)[:, 0].cpu().numpy()
    s = flat[idx].cpu().numpy().astype(np.int64) if len(idx) else \
        np.zeros(0, np.int64)
    order = np.lexsort((idx, -s))[:capacity]
    idx, s = idx[order], s[order]
    return np.stack([idx // w, idx % w], -1), s


def greedy_nms(coords: np.ndarray, score: np.ndarray,
               radius: float) -> np.ndarray:
    """(n,) bool kept: in score order (index order among equals) keep a
    point unless a kept one lies within ``radius`` (squared distance in
    float32, ``<=``)."""
    n = len(coords)
    c = coords.astype(np.float32)
    r2 = np.float32(radius) ** 2
    order = np.lexsort((np.arange(n), -score))
    active = np.ones(n, bool)
    kept = np.zeros(n, bool)
    for i in order:
        if not active[i]:
            continue
        kept[i] = True
        d2 = ((c - c[i]) ** 2).sum(-1, dtype=np.float32)
        active &= ~(d2 <= r2)
    return kept


def brief(img: torch.Tensor, coords: np.ndarray,
          pairs: np.ndarray) -> np.ndarray:
    """(n, P) uint8: bit i set iff I(p + a_i) < I(p + b_i), 0 where a
    sample falls outside the frame."""
    h, w = img.shape
    p = coords[:, None, None, :].astype(np.int64) + pairs[None]  # (n,P,2,2)
    inside = ((p >= 0) & (p < np.array([h, w]))).all(-1).all(-1)
    pc = np.minimum(np.maximum(p, 0), np.array([h - 1, w - 1]))
    idx = torch.as_tensor(pc[..., 0] * w + pc[..., 1], device=img.device)
    vals = img.reshape(-1)[idx]
    lt = (vals[..., 0] < vals[..., 1]).cpu().numpy()
    return (lt & inside).astype(np.uint8)


def _box(x: torch.Tensor, half: int) -> torch.Tensor:
    k = 2 * half + 1
    h, w = x.shape
    p = F.pad(x.float(), (0, 0, half, half)).to(x.dtype)
    x = p[0:h]
    for i in range(1, k):
        x = x + p[i:i + h]
    p = F.pad(x.float(), (half, half, 0, 0)).to(x.dtype)
    y = p[:, 0:w]
    for i in range(1, k):
        y = y + p[:, i:i + w]
    return y


def refine(img: torch.Tensor, coords: np.ndarray, window: int = 3,
           iterations: int = 2) -> np.ndarray:
    """(n, 2) float32 refined (row, col): two cornerSubPix normal-equation
    steps over the (2 window + 1)^2 window of central-difference gradient
    products (windowed sums as box filters), each around the current
    position rounded half to even; a flat window keeps its position; the
    move clamped to 1.5 px."""
    h, w = img.shape
    dt = img.dtype
    gy = torch.zeros_like(img)
    gy[1:-1] = (img[2:] - img[:-2]) / 2.0
    gx = torch.zeros_like(img)
    gx[:, 1:-1] = (img[:, 2:] - img[:, :-2]) / 2.0
    rr = torch.arange(h, device=img.device).to(dt)[:, None]
    cc = torch.arange(w, device=img.device).to(dt)[None, :]
    gyy, gyx, gxx = gy * gy, gy * gx, gx * gx
    maps = torch.stack([_box(gyy, window), _box(gyx, window),
                        _box(gxx, window), _box(gyy * rr + gyx * cc, window),
                        _box(gyx * rr + gxx * cc, window)]).reshape(5, -1)
    q0 = torch.as_tensor(coords, device=img.device).to(dt)
    q = q0
    for _ in range(iterations):
        r_ = torch.clamp(torch.round(q[:, 0]).to(torch.int64), 0, h - 1)
        c_ = torch.clamp(torch.round(q[:, 1]).to(torch.int64), 0, w - 1)
        a, b, c, br, bc = maps[:, r_ * w + c_]
        det = a * c - b * b
        ok = det.abs() > 1e-6
        det = torch.where(ok, det, torch.ones_like(det))
        step = torch.stack([(c * br - b * bc) / det,
                            (a * bc - b * br) / det], -1)
        q = torch.where(ok[:, None], step, q)
    out = q0 + torch.clamp(q - q0, -1.5, 1.5)
    return out.float().cpu().numpy()


def frame_features(frame: torch.Tensor, pairs: np.ndarray, threshold: float,
                   capacity: int, radius: float,
                   dtype=torch.float32) -> Features:
    """The features of one (H, W) frame (float32 grey levels) in
    ``capacity`` slots."""
    img = frame.to(dtype)
    coords, score = strongest(fast_scores(img, threshold), capacity)
    kept = greedy_nms(coords, score, radius)
    coords, score = coords[kept], score[kept]
    n = len(coords)
    out_c = np.zeros((capacity, 2), np.int32)
    out_s = np.zeros(capacity, np.float32)
    out_b = np.zeros((capacity, len(pairs)), np.uint8)
    out_xy = np.zeros((capacity, 2), np.float32)
    out_c[:n] = coords
    out_s[:n] = score
    if n:
        out_b[:n] = brief(img, coords, pairs)
        rc = refine(img, coords)
        out_xy[:n] = rc[:, ::-1]
    return Features(out_c, out_s, np.arange(capacity) < n, out_b, out_xy)


def hamming(bits1: np.ndarray, mask1: np.ndarray, bits2: np.ndarray,
            mask2: np.ndarray, device) -> torch.Tensor:
    """(N1, N2) int64 Hamming distances, INT_INF on masked rows and
    columns."""
    a = torch.as_tensor(bits1, device=device, dtype=torch.float64)
    b = torch.as_tensor(bits2, device=device, dtype=torch.float64)
    # 0/1 products summed in float64: exact
    d = (a.sum(1)[:, None] + b.sum(1)[None, :] - 2 * a @ b.T).to(torch.int64)
    m = torch.as_tensor(mask1, device=device)[:, None] & \
        torch.as_tensor(mask2, device=device)[None, :]
    return torch.where(m, d, INT_INF)


def mutual_matches(f1: Features, f2: Features, max_distance: int, device):
    """(idx2 (N1,) int32 with -1 for none, dist (N1,) int64, valid (N1,)
    bool): row i's nearest column j (the first among equals) when i is
    also j's nearest row and the distance is within ``max_distance``."""
    d = hamming(f1.bits, f1.mask, f2.bits, f2.mask, device)
    best2 = torch.argmin(d, 1)
    best1 = torch.argmin(d, 0)
    dist = d.gather(1, best2[:, None])[:, 0]
    rows = torch.arange(d.shape[0], device=device)
    valid = (best1[best2] == rows) & (dist <= max_distance) & (dist < INT_INF)
    idx2 = torch.where(valid, best2, -1)
    return (idx2.cpu().numpy().astype(np.int32), dist.cpu().numpy(),
            valid.cpu().numpy())
