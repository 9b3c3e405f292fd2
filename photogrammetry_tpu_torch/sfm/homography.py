"""Plane-induced homography: DLT, RANSAC and pose decomposition (port of
photogrammetry_tpu/sfm/homography.py).

As in sfm/epipolar.py, hypotheses are one batch and RANSAC is a function of
sample indices drawn beforehand (``epipolar.draw_samples``).
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from photogrammetry_tpu_torch.core.camera import to_homogeneous
from photogrammetry_tpu_torch.sfm.epipolar import (
    normalization_transform, smallest_eigvec,
)


def dlt_homography(xy1: torch.Tensor, xy2: torch.Tensor,
                   weights: torch.Tensor | None = None) -> torch.Tensor:
    """Normalized DLT estimate of H with x2 ~ H x1 for (…, N, 2) points;
    (…, 3, 3) of unit Frobenius norm (defined up to sign)."""
    w = torch.ones(xy1.shape[:-1], dtype=torch.float32, device=xy1.device) \
        if weights is None else weights.to(torch.float32)
    t1 = normalization_transform(xy1, w > 0)
    t2 = normalization_transform(xy2, w > 0)
    h1 = to_homogeneous(xy1) @ t1.transpose(-1, -2)
    h2 = to_homogeneous(xy2) @ t2.transpose(-1, -2)
    x1, y1 = h1[..., 0], h1[..., 1]
    x2, y2 = h2[..., 0], h2[..., 1]
    zero = torch.zeros_like(x1)
    one = torch.ones_like(x1)
    # two rows per correspondence of the DLT system A h = 0
    r1 = torch.stack([x1, y1, one, zero, zero, zero,
                      -x2 * x1, -x2 * y1, -x2], dim=-1)
    r2 = torch.stack([zero, zero, zero, x1, y1, one,
                      -y2 * x1, -y2 * y1, -y2], dim=-1)
    a = torch.cat([r1 * w[..., None], r2 * w[..., None]], dim=-2)
    gram = a.transpose(-1, -2) @ a
    h = smallest_eigvec(gram).reshape(*gram.shape[:-2], 3, 3)
    h = torch.linalg.solve(t2, h) @ t1  # denormalize: T2^-1 H T1
    norm = torch.linalg.matrix_norm(h)[..., None, None]
    return h / torch.clamp(norm, min=1e-12)


def homography_residuals(h: torch.Tensor, xy1: torch.Tensor,
                         xy2: torch.Tensor) -> torch.Tensor:
    """Symmetric transfer error (pixels) of (…, 3, 3) H over (N, 2) points
    → (…, N): (|H x1 - x2| + |H^-1 x2 - x1|) / 2."""
    eye = torch.eye(3, dtype=h.dtype, device=h.device)
    hinv = torch.linalg.inv(h + 1e-30 * eye)

    def transfer(m, a):
        p = to_homogeneous(a) @ m.transpose(-1, -2)
        z = p[..., 2:3]
        z = torch.where(z.abs() < 1e-12, 1e-12, z)
        return p[..., :2] / z

    d12 = torch.linalg.vector_norm(transfer(h, xy1) - xy2, dim=-1)
    d21 = torch.linalg.vector_norm(transfer(hinv, xy2) - xy1, dim=-1)
    return 0.5 * (d12 + d21)


class HRansacResult(NamedTuple):
    h: torch.Tensor
    inliers: torch.Tensor
    num_inliers: torch.Tensor


def ransac_homography(sample_idx: torch.Tensor, xy1: torch.Tensor,
                      xy2: torch.Tensor, mask: torch.Tensor,
                      threshold: float,
                      lo_iterations: int = 3) -> HRansacResult:
    """RANSAC over the H hypotheses of ``sample_idx`` (H, 4) with LO
    refinement (first of the highest inlier count wins)."""
    hs = dlt_homography(xy1[sample_idx], xy2[sample_idx])
    counts = ((homography_residuals(hs, xy1, xy2) <= threshold)
              & mask).sum(-1)
    h = hs[torch.argmax(counts)]
    inliers = (homography_residuals(h, xy1, xy2) <= threshold) & mask
    for _ in range(max(1, lo_iterations)):
        h2 = dlt_homography(xy1, xy2, weights=inliers.to(torch.float32))
        in2 = (homography_residuals(h2, xy1, xy2) <= threshold) & mask
        better = in2.sum() >= inliers.sum()
        h = torch.where(better, h2, h)
        inliers = torch.where(better, in2, inliers)
    return HRansacResult(h=h, inliers=inliers,
                         num_inliers=inliers.sum().to(torch.int32))


def decompose_homography(h: torch.Tensor, k1: torch.Tensor,
                         k2: torch.Tensor):
    """Calibrated H → 4 candidate poses (R (4,3,3), t (4,3), n (4,3)) by
    Faugeras-Lustman's SVD construction; t is unit-normalized and n points
    toward camera 1."""
    hn = torch.linalg.solve(k2, h) @ k1
    u, d, vt = torch.linalg.svd(hn)
    d2 = torch.clamp(d[1], min=1e-12)
    d1, d3 = d[0] / d2, d[2] / d2
    s = torch.linalg.det(u) * torch.linalg.det(vt)

    denom = torch.clamp(d1 ** 2 - d3 ** 2, min=1e-12)
    x1 = torch.sqrt(torch.clamp((d1 ** 2 - 1.0) / denom, min=0.0))
    x3 = torch.sqrt(torch.clamp((1.0 - d3 ** 2) / denom, min=0.0))
    zero = torch.zeros_like(d1)
    one = torch.ones_like(d1)

    rs, ts, ns = [], [], []
    for e1, e3 in ((1.0, 1.0), (1.0, -1.0), (-1.0, 1.0), (-1.0, -1.0)):
        a1, a3 = e1 * x1, e3 * x3
        sin_t = (d1 - d3) * a1 * a3
        cos_t = d1 * a3 ** 2 + d3 * a1 ** 2
        rp = torch.stack([
            torch.stack([cos_t, zero, -sin_t]),
            torch.stack([zero, one, zero]),
            torch.stack([sin_t, zero, cos_t]),
        ])
        tp = (d1 - d3) * torch.stack([a1, zero, -a3])
        npp = torch.stack([a1, zero, a3])
        r = s * u @ rp @ vt
        t = u @ tp
        nvec = vt.T @ npp
        flip = torch.where(nvec[2] < 0, -1.0, 1.0)
        rs.append(r)
        ts.append(t / torch.clamp(torch.linalg.vector_norm(t), min=1e-12))
        ns.append(nvec * flip)
    return torch.stack(rs), torch.stack(ts), torch.stack(ns)
