"""Absolute pose from 2D-3D correspondences, RANSAC DLT-PnP (port of
photogrammetry_tpu/sfm/pnp.py).

All RANSAC hypotheses are estimated and scored as one batch; the 12-vector
null space of each DLT system is the smallest eigenvector of its 12x12
Gram matrix.  As in ``sfm/epipolar.py``, RANSAC is two steps —
``draw_pnp_samples`` draws the (H, 6) sample indices from a
``torch.Generator``, ``ransac_pnp`` is a function of those indices — so a
test can feed it the JAX package's own draws.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch

from photogrammetry_tpu_torch.core.camera import normalize_pixels
from photogrammetry_tpu_torch.sfm.epipolar import smallest_eigvec, svd_or_nan
from photogrammetry_tpu_torch.utils.indexing import take_row


def dlt_pnp(points_w: torch.Tensor, xn: torch.Tensor,
            weights: torch.Tensor | None = None):
    """Direct linear transform for pose: (R, t) with xn ~ π(R X + t).

    points_w (…, N, 3) world points; xn (…, N, 2) normalized image
    coordinates; weights optional (…, N) row weights.  Returns
    (r (…, 3, 3), t (…, 3)); needs >= 6 effective correspondences.
    """
    n = points_w.shape[-2]
    w = (torch.ones(points_w.shape[:-1], dtype=torch.float32,
                    device=points_w.device)
         if weights is None else weights.to(torch.float32))
    # condition the 3D side: centroid shift + isotropic scale to mean norm
    # sqrt(3)
    wsum = torch.clamp(w.sum(-1), min=1.0)[..., None]
    c = (points_w * w[..., None]).sum(-2) / wsum
    xc = points_w - c[..., None, :]
    norms = torch.sqrt((xc * xc).sum(-1))
    scale = math.sqrt(3.0) / torch.clamp((norms * w).sum(-1, keepdim=True)
                                         / wsum, min=1e-12)
    xs = xc * scale[..., None]

    xh = torch.cat([xs, torch.ones_like(xs[..., :1])], dim=-1)    # (…,N,4)
    zeros = torch.zeros_like(xh)
    u, v = xn[..., 0:1], xn[..., 1:2]
    row1 = torch.cat([xh, zeros, -u * xh], dim=-1)                # (…,N,12)
    row2 = torch.cat([zeros, xh, -v * xh], dim=-1)
    a = torch.cat([row1 * w[..., None], row2 * w[..., None]], dim=-2)
    gram = a.transpose(-1, -2) @ a
    p = smallest_eigvec(gram).reshape(*gram.shape[:-2], 3, 4)

    # undo the 3D normalization: P = P' @ [[sI, -sc], [0, 1]]
    eye = torch.eye(3, dtype=xs.dtype, device=xs.device)
    top = torch.cat([scale[..., None] * eye,
                     (-scale * c)[..., :, None]], dim=-1)          # (…,3,4)
    bottom = torch.eye(4, dtype=xs.dtype, device=xs.device)[3:].expand(
        *top.shape[:-2], 1, 4)
    p = p @ torch.cat([top, bottom], dim=-2)

    p = p * torch.sign(torch.linalg.det(p[..., :3]))[..., None, None]
    uu, ss, vt = svd_or_nan(p[..., :3])
    r = uu @ vt
    r = torch.where((torch.linalg.det(r) < 0)[..., None, None], -r, r)
    s_mean = torch.clamp(ss.mean(-1), min=1e-12)
    return r, p[..., 3] / s_mean[..., None]


def pnp_reprojection_errors(r, t, points_w, xy, k):
    """Pixel reprojection errors (…, N) and depths (…, N) for pose (r, t)
    (with optional leading dims on r (…, 3, 3), t (…, 3))."""
    pc = points_w @ r.transpose(-1, -2) + t[..., None, :]
    z = pc[..., 2]
    zs = torch.where(z.abs() < 1e-9, 1e-9, z)
    px = k[0, 0] * pc[..., 0] / zs + k[0, 2]
    py = k[1, 1] * pc[..., 1] / zs + k[1, 2]
    d = torch.stack([px, py], dim=-1) - xy
    return torch.sqrt((d * d).sum(-1)), z


class PnPResult(NamedTuple):
    r: torch.Tensor              # (3, 3) world→camera rotation
    t: torch.Tensor              # (3,) translation
    inliers: torch.Tensor        # (N,) bool
    num_inliers: torch.Tensor    # () int32


def draw_pnp_samples(generator: torch.Generator, mask: torch.Tensor,
                     num_samples: int, sample_size: int = 6) -> torch.Tensor:
    """(num_samples, sample_size) int64 indices, each row drawn without
    replacement from the valid correspondences (uniform keys, invalid rows
    keyed 2.0 so they sort last, stable argsort, first ``sample_size``) —
    the JAX draw with a torch generator."""
    u = torch.rand((num_samples, mask.shape[0]), generator=generator,
                   device=mask.device)
    u = torch.where(mask, u, 2.0)
    return torch.argsort(u, dim=-1, stable=True)[:, :sample_size]


def _inliers(r, t, points_w, xy, mask, k, threshold):
    err, z = pnp_reprojection_errors(r, t, points_w, xy, k)
    return (err <= threshold) & (z > 0) & mask


def ransac_pnp(sample_idx: torch.Tensor, points_w: torch.Tensor,
               xy: torch.Tensor, mask: torch.Tensor, k: torch.Tensor,
               threshold: float = 3.0, refit: bool = True) -> PnPResult:
    """RANSAC absolute pose over the hypotheses of ``sample_idx`` (H, S).

    points_w: (N, 3) landmarks; xy: (N, 2) pixel observations; mask: (N,)
    valid correspondences; threshold: inlier reprojection error (px).  An
    inlier must also have positive depth.  The winner is the first of the
    highest inlier count; with refit=True it is re-estimated on its full
    inlier set and kept only if at least as many inliers survive.
    """
    xn = normalize_pixels(xy, k)
    rs, ts = dlt_pnp(points_w[sample_idx], xn[sample_idx])   # (H,3,3),(H,3)
    counts = _inliers(rs, ts, points_w, xy, mask, k, threshold).sum(-1)
    best = torch.argmax(counts)
    r, t = take_row(rs, best), take_row(ts, best)
    inliers = _inliers(r, t, points_w, xy, mask, k, threshold)
    if refit:
        r2, t2 = dlt_pnp(points_w, xn, weights=inliers.to(torch.float32))
        inl2 = _inliers(r2, t2, points_w, xy, mask, k, threshold)
        better = inl2.sum() >= inliers.sum()
        r = torch.where(better, r2, r)
        t = torch.where(better, t2, t)
        inliers = torch.where(better, inl2, inliers)
    return PnPResult(r=r, t=t, inliers=inliers,
                     num_inliers=inliers.sum().to(torch.int32))
