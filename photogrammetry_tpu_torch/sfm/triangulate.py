"""DLT triangulation and cheirality-based pose disambiguation (port of
photogrammetry_tpu/sfm/triangulate.py: ``triangulate_dlt``,
``cheirality_counts``, ``select_pose``).

The 4x4 null space of each point's DLT system is the smallest eigenvector
of its Gram matrix; candidates and points are one batch.
"""
from __future__ import annotations

import torch

from photogrammetry_tpu_torch.core.camera import normalize_pixels
from photogrammetry_tpu_torch.sfm.epipolar import smallest_eigvec


def _dlt_design(xn1, xn2, r, t):
    """(…, N, 4, 4) DLT design for normalized coords, P1 = [I | 0] and
    P2 = [R | t] with R (…, 3, 3), t (…, 3)."""
    eye = torch.eye(3, dtype=xn1.dtype, device=xn1.device)
    p1 = torch.cat([eye, torch.zeros_like(eye[:, :1])], dim=1)    # (3, 4)
    p2 = torch.cat([r, t[..., :, None]], dim=-1)[..., None, :, :]  # (…,1,3,4)
    x1 = xn1[..., :, None]   # (N, 2, 1)
    x2 = xn2[..., :, None]
    rows = [p1[0] - x1[:, 0] * p1[2], x1[:, 1] * p1[2] - p1[1]]
    rows = [q.expand(*p2.shape[:-3], *q.shape) for q in rows]
    rows += [p2[..., 0, :] - x2[:, 0] * p2[..., 2, :],
             x2[:, 1] * p2[..., 2, :] - p2[..., 1, :]]
    return torch.stack(rows, dim=-2)


def triangulate_dlt(xy1, xy2, r, t, k1, k2):
    """Triangulate pixel correspondences for pose (R, t) of camera 2 (with
    optional leading candidate dims on R, t).

    Returns (points_w (…, N, 3) in the camera-1/world frame, depth2 (…, N)).
    """
    xn1 = normalize_pixels(xy1, k1)
    xn2 = normalize_pixels(xy2, k2)
    d = _dlt_design(xn1, xn2, r, t)                   # (…, N, 4, 4)
    gram = d.transpose(-1, -2) @ d
    xh = smallest_eigvec(gram)                        # (…, N, 4)
    denom = xh[..., 3:]
    denom = torch.where(denom.abs() < 1e-12, 1e-12, denom)
    pts = xh[..., :3] / denom
    cam2 = pts @ r.transpose(-1, -2) + t[..., None, :]
    return pts, cam2[..., 2]


def cheirality_counts(xy1, xy2, rs, ts, k1, k2, mask,
                      both_cameras: bool = True):
    """Masked positive-depth counts (4,) for each candidate pose, and the
    triangulated points (4, N, 3)."""
    pts, z2 = triangulate_dlt(xy1, xy2, rs, ts, k1, k2)
    ok = z2 > 0
    if both_cameras:
        ok = ok & (pts[..., 2] > 0)
    return (ok & mask).sum(-1), pts


def select_pose(xy1, xy2, rs, ts, k1, k2, mask, both_cameras: bool = True):
    """Pick the candidate with the most points in front of the camera(s)
    (the first of a tie).

    Returns (r (3,3), t (3,), points_w (N,3), counts (4,), best_idx ()).
    """
    counts, pts = cheirality_counts(xy1, xy2, rs, ts, k1, k2, mask,
                                    both_cameras)
    best = torch.argmax(counts)
    return rs[best], ts[best], pts[best], counts, best
