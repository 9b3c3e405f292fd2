"""Epipolar geometry: normalized 8-point, RANSAC, essential decomposition
(port of photogrammetry_tpu/sfm/epipolar.py).

Functions take leading batch dimensions where the JAX package vmaps them:
all RANSAC hypotheses are estimated and scored as one batch.  RANSAC is
split in two steps — ``draw_samples`` draws the (H, S) sample indices from a
``torch.Generator``, ``ransac_fundamental`` is a function of those indices —
so that a test can feed it the JAX package's own draws.

The null vector stays the smallest eigenvector of the 9x9 Gram matrix
(``eigh``); the JAX package's inverse-iteration variant is a documented
accuracy loss and is not ported.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from photogrammetry_tpu_torch.core.camera import to_homogeneous
from photogrammetry_tpu_torch.utils.padding import front_indices


def normalization_transform(xy: torch.Tensor,
                            mask: torch.Tensor) -> torch.Tensor:
    """Hartley normalization transform (…, 3, 3) for masked (…, N, 2)."""
    m = mask.to(torch.float32)
    n = torch.clamp(m.sum(-1), min=1.0)
    centroid = (xy * m[..., None]).sum(-2) / n[..., None]
    d2 = ((xy - centroid[..., None, :]) ** 2).sum(-1) * m
    msd = d2.sum(-1) / n
    s = torch.sqrt(2.0 / torch.clamp(msd, min=1e-12))
    zero = torch.zeros_like(s)
    one = torch.ones_like(s)
    return torch.stack([
        torch.stack([s, zero, -s * centroid[..., 0]], -1),
        torch.stack([zero, s, -s * centroid[..., 1]], -1),
        torch.stack([zero, zero, one], -1),
    ], -2)


def smallest_eigvec(a: torch.Tensor) -> torch.Tensor:
    """Eigenvector of the smallest eigenvalue of symmetric (…, D, D)."""
    return torch.linalg.eigh(a).eigenvectors[..., :, 0]


def eight_point_fundamental(xy1: torch.Tensor, xy2: torch.Tensor,
                            weights: torch.Tensor | None = None
                            ) -> torch.Tensor:
    """Normalized 8-point estimate of F with x2^T F x1 = 0.

    xy1, xy2: (…, N, 2) pixel coords; weights: optional (…, N) row weights
    (0 excludes a correspondence).  Returns (…, 3, 3) rank-2 F of unit
    Frobenius norm (defined up to sign).
    """
    w = torch.ones(xy1.shape[:-1], dtype=torch.float32, device=xy1.device) \
        if weights is None else weights.to(torch.float32)
    t1 = normalization_transform(xy1, w > 0)
    t2 = normalization_transform(xy2, w > 0)
    h1 = to_homogeneous(xy1) @ t1.transpose(-1, -2)
    h2 = to_homogeneous(xy2) @ t2.transpose(-1, -2)
    x1, y1 = h1[..., 0], h1[..., 1]
    x2, y2 = h2[..., 0], h2[..., 1]
    one = torch.ones_like(x1)
    a = torch.stack([x2 * x1, x2 * y1, x2, y2 * x1, y2 * y1, y2, x1, y1, one],
                    dim=-1)  # (…, N, 9)
    a = a * w[..., None]
    gram = a.transpose(-1, -2) @ a
    f = smallest_eigvec(gram).reshape(*gram.shape[:-2], 3, 3)
    f = t2.transpose(-1, -2) @ f @ t1
    # project to rank 2 (zero the smallest singular value)
    u, s, vt = torch.linalg.svd(f)
    s = torch.cat([s[..., :2], torch.zeros_like(s[..., 2:])], dim=-1)
    f = (u * s[..., None, :]) @ vt
    norm = torch.linalg.matrix_norm(f)[..., None, None]
    return f / torch.clamp(norm, min=1e-12)


def epipolar_residuals(f: torch.Tensor, xy1: torch.Tensor, xy2: torch.Tensor,
                       kind: str = "sampson") -> torch.Tensor:
    """Residuals of x2^T F x1 for (…, 3, 3) F and (N, 2) points → (…, N).

    kind='algebraic' is the raw bilinear value; 'sampson' is the first-order
    geometric distance in pixels."""
    h1 = to_homogeneous(xy1)
    h2 = to_homogeneous(xy2)
    fx1 = h1 @ f.transpose(-1, -2)   # (…, N, 3) = F x1
    ftx2 = h2 @ f                    # (…, N, 3) = F^T x2
    alg = (h2 * fx1).sum(-1)
    if kind == "algebraic":
        return alg
    denom = fx1[..., 0] ** 2 + fx1[..., 1] ** 2 + ftx2[..., 0] ** 2 \
        + ftx2[..., 1] ** 2
    return alg / torch.sqrt(torch.clamp(denom, min=1e-12))


class RansacResult(NamedTuple):
    f: torch.Tensor              # (3, 3) best fundamental matrix
    inliers: torch.Tensor        # (N,) bool
    num_inliers: torch.Tensor    # () int32
    best_sample: torch.Tensor    # (S,) int32 indices of the winning sample


def draw_samples(generator: torch.Generator, mask: torch.Tensor,
                 num_samples: int, sample_size: int) -> torch.Tensor:
    """(num_samples, sample_size) int64 indices drawn uniformly with
    replacement over the valid correspondences, on the device (no host
    read of the count)."""
    n = mask.shape[0]
    count = torch.clamp(mask.sum(), min=1)
    valid_idx = front_indices(mask, n)
    u = torch.rand((num_samples, sample_size), generator=generator,
                   device=mask.device)
    u = torch.minimum((u * count).to(torch.int64), count - 1)
    return valid_idx[u]


def _inlier_test(r: torch.Tensor, threshold: float, signed: bool):
    return (r <= threshold) if signed else (r.abs() <= threshold)


def ransac_fundamental(sample_idx: torch.Tensor, xy1: torch.Tensor,
                       xy2: torch.Tensor, mask: torch.Tensor,
                       threshold: float, residual: str = "sampson",
                       signed_residual: bool = False, refit: bool = True,
                       lo_iterations: int = 3) -> RansacResult:
    """RANSAC over the F hypotheses of ``sample_idx`` (H, S), all estimated
    and scored at once; the winner (first of the highest inlier count) is
    locally optimized by ``lo_iterations`` refit-on-inliers rounds, each
    kept only if the consensus does not shrink."""
    fs = eight_point_fundamental(xy1[sample_idx], xy2[sample_idx])  # (H,3,3)
    r = epipolar_residuals(fs, xy1, xy2, kind=residual)              # (H, N)
    counts = (_inlier_test(r, threshold, signed_residual) & mask).sum(-1)
    best = torch.argmax(counts)
    f = fs[best]
    inliers = _inlier_test(epipolar_residuals(f, xy1, xy2, kind=residual),
                           threshold, signed_residual) & mask
    if refit:
        for _ in range(max(1, lo_iterations)):
            f2 = eight_point_fundamental(xy1, xy2,
                                         weights=inliers.to(torch.float32))
            r2 = epipolar_residuals(f2, xy1, xy2, kind=residual)
            inliers2 = _inlier_test(r2, threshold, signed_residual) & mask
            better = inliers2.sum() >= inliers.sum()
            f = torch.where(better, f2, f)
            inliers = torch.where(better, inliers2, inliers)
    return RansacResult(f=f, inliers=inliers,
                        num_inliers=inliers.sum().to(torch.int32),
                        best_sample=sample_idx[best].to(torch.int32))


def essential_from_fundamental(f: torch.Tensor, k1: torch.Tensor,
                               k2: torch.Tensor) -> torch.Tensor:
    """E = K2^T F K1."""
    return k2.T @ f @ k1


def decompose_essential(e: torch.Tensor):
    """E → 4 candidate poses (R (4,3,3), t (4,3)), det(R) = +1."""
    u, _, vt = torch.linalg.svd(e)
    w = torch.tensor([[0.0, -1.0, 0.0], [1.0, 0.0, 0.0], [0.0, 0.0, 1.0]],
                     dtype=e.dtype, device=e.device)
    r1 = u @ w @ vt
    r2 = u @ w.T @ vt
    r1 = r1 * torch.sign(torch.linalg.det(r1))
    r2 = r2 * torch.sign(torch.linalg.det(r2))
    t = u[:, 2]
    t = t / torch.clamp(torch.linalg.vector_norm(t), min=1e-12)
    return torch.stack([r1, r1, r2, r2]), torch.stack([t, -t, t, -t])
