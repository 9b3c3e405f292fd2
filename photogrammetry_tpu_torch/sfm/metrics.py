"""Trajectory evaluation: Umeyama alignment + ATE (port of
photogrammetry_tpu/sfm/metrics.py)."""
from __future__ import annotations

import torch

from photogrammetry_tpu_torch.sfm.epipolar import svd_or_nan


def align_umeyama(est: torch.Tensor, gt: torch.Tensor,
                  with_scale: bool = True):
    """Similarity transform (s, R, t) minimizing ||gt - (s R est + t)||.

    est, gt: (N, 3) corresponding positions.
    """
    mu_e = est.mean(0)
    mu_g = gt.mean(0)
    ec = est - mu_e
    gc = gt - mu_g
    cov = gc.T @ ec / est.shape[0]
    u, d, vt = svd_or_nan(cov)
    ones = torch.ones(3, dtype=est.dtype, device=est.device)
    flip = torch.tensor([1.0, 1.0, -1.0], dtype=est.dtype, device=est.device)
    s_fix = torch.where(torch.linalg.det(u) * torch.linalg.det(vt) < 0,
                        flip, ones)
    r = (u * s_fix[None, :]) @ vt
    if with_scale:
        var_e = (ec ** 2).sum(-1).mean()
        s = (d * s_fix).sum() / torch.clamp(var_e, min=1e-12)
    else:
        s = torch.ones((), dtype=est.dtype, device=est.device)
    t = mu_g - s * (r @ mu_e)
    return s, r, t


def absolute_trajectory_error(est: torch.Tensor, gt: torch.Tensor,
                              with_scale: bool = True) -> torch.Tensor:
    """RMSE of aligned camera positions (the standard monocular ATE)."""
    s, r, t = align_umeyama(est, gt, with_scale)
    aligned = est @ (s * r).T + t
    return torch.sqrt(((aligned - gt) ** 2).sum(-1).mean())


def trajectory_ate(rs, ts, gt_centers) -> float:
    """ATE, in float64 on the CPU, of the camera centres -R^T t of (F, 3, 3)
    rotations and (F, 3) translations (arrays, lists or tensors on any
    device) against (F, 3) ground-truth centres."""
    def f64(x):
        return torch.as_tensor(x).detach().cpu().to(torch.float64)

    c = -torch.einsum("fji,fj->fi", f64(rs), f64(ts))
    return float(absolute_trajectory_error(c, f64(gt_centers)))
