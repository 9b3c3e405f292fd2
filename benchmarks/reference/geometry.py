"""Plain reference of the geometry the cells are judged by: trajectory
error after a similarity alignment, rotation and direction angles, the
bundle adjustment's robust cost and Gauss-Newton decrement at a given
state, and a two-view relative pose solver (normalized 8-point RANSAC,
essential decomposition, cheirality) that the pose cell's control runs.

NumPy and plain PyTorch; nothing of the port.  ``quantize`` rounds a
tensor to the control's precision after each stage (identity for the
reference).
"""
from __future__ import annotations

import numpy as np
import torch


def to_bf16(x: torch.Tensor) -> torch.Tensor:
    """``x`` rounded to bfloat16 and back to its own dtype."""
    return x.to(torch.bfloat16).to(x.dtype)


def ate(est_centers: np.ndarray, gt_centers: np.ndarray) -> float:
    """RMSE of the estimated camera centres after the least-squares
    similarity (Umeyama) onto the true ones, float64."""
    e = np.asarray(est_centers, np.float64)
    g = np.asarray(gt_centers, np.float64)
    mu_e, mu_g = e.mean(0), g.mean(0)
    ec, gc = e - mu_e, g - mu_g
    u, d, vt = np.linalg.svd(gc.T @ ec / len(e))
    fix = np.ones(3)
    if np.linalg.det(u) * np.linalg.det(vt) < 0:
        fix[2] = -1.0
    r = (u * fix) @ vt
    s = (d * fix).sum() / max((ec ** 2).sum(-1).mean(), 1e-12)
    aligned = s * ec @ r.T + mu_g
    return float(np.sqrt(((aligned - g) ** 2).sum(-1).mean()))


def rotation_deg(r_est: np.ndarray, r_true: np.ndarray) -> float:
    c = (np.trace(np.asarray(r_true, np.float64).T
                  @ np.asarray(r_est, np.float64)) - 1.0) / 2.0
    return float(np.degrees(np.arccos(np.clip(c, -1.0, 1.0))))


def direction_deg(t_est: np.ndarray, t_true: np.ndarray) -> float:
    a = np.asarray(t_est, np.float64)
    b = np.asarray(t_true, np.float64)
    c = a @ b / max(np.linalg.norm(a) * np.linalg.norm(b), 1e-300)
    return float(np.degrees(np.arccos(np.clip(c, -1.0, 1.0))))


def relative_pose(r1, t1, r2, t2):
    """Camera 2's pose in camera 1's frame from world-to-camera poses."""
    r = r2 @ r1.T
    return r, t2 - r @ t1


def _skew(v):
    z = torch.zeros_like(v[..., 0])
    return torch.stack([torch.stack([z, -v[..., 2], v[..., 1]], -1),
                        torch.stack([v[..., 2], z, -v[..., 0]], -1),
                        torch.stack([-v[..., 1], v[..., 0], z], -1)], -2)


def ba_residuals(rs, ts, points, obs, mask, k, huber: float = 3.0):
    """Residuals and robust cost of a BA state, in the tensors' dtype:
    projection of every landmark in every camera, residual to its
    observation where observed and in front (depth > 1e-6), Huber cost
    (quadratic to ``huber`` px, linear beyond) summed.  Returns (r (n, 2),
    weights sqrt(Huber IRLS weight) (n,), camera index (n,), landmark
    index (n,), camera-frame point (n, 3), cost)."""
    pc = torch.einsum("fij,tj->fti", rs, points) + ts[:, None, :]
    z = pc[..., 2]
    valid = mask & (z > 1e-6)
    fi, ti = torch.nonzero(valid, as_tuple=True)
    p = pc[fi, ti]
    zs = p[:, 2]
    pred = torch.stack([k[0, 0] * p[:, 0] / zs + k[0, 2],
                        k[1, 1] * p[:, 1] / zs + k[1, 2]], -1)
    r = pred - obs[fi, ti]
    rn = torch.sqrt((r * r).sum(-1) + 1e-12)
    cost = torch.where(rn <= huber, 0.5 * rn ** 2,
                       huber * (rn - 0.5 * huber)).sum()
    wt = torch.sqrt(torch.clamp(huber / rn, max=1.0))
    return r, wt, fi, ti, p, cost


def ba_decrement(rs, ts, points, obs, mask, k, fixed_camera: int = 0,
                 huber: float = 3.0, damping: float = 1e-6):
    """(cost, Gauss-Newton decrement g^T (H + damping diag H)^-1 g / 2,
    valid observations) of the robust (IRLS) least-squares problem at a
    state, in float64:
    J over the free cameras' left-multiplied twists (all but
    ``fixed_camera``) and the observed landmarks' positions, built whole."""
    f64 = dict(dtype=torch.float64)
    rs, ts, points, obs, k = (x.to(**f64) for x in (rs, ts, points, obs, k))
    r, wt, fi, ti, p, cost = ba_residuals(rs, ts, points, obs, mask, k,
                                          huber)
    n = len(fi)
    zi = 1.0 / p[:, 2]
    zero = torch.zeros_like(zi)
    dpi = torch.stack([
        torch.stack([k[0, 0] * zi, zero, -k[0, 0] * p[:, 0] * zi ** 2], -1),
        torch.stack([zero, k[1, 1] * zi, -k[1, 1] * p[:, 1] * zi ** 2], -1),
    ], -2)                                                      # (n, 2, 3)
    j_cam = torch.cat([dpi @ -_skew(p), dpi], -1) * wt[:, None, None]
    j_pt = dpi @ rs[fi] * wt[:, None, None]
    f = rs.shape[0]
    cams = [c for c in range(f) if c != fixed_camera]
    cam_col = torch.full((f,), -1, dtype=torch.int64, device=rs.device)
    cam_col[cams] = torch.arange(len(cams), device=rs.device) * 6
    used = torch.unique(ti)
    pt_col = torch.full((points.shape[0],), -1, dtype=torch.int64,
                        device=rs.device)
    pt_col[used] = 6 * len(cams) + torch.arange(len(used),
                                                device=rs.device) * 3
    ncol = 6 * len(cams) + 3 * len(used)
    jac = torch.zeros((n, 2, ncol), **f64, device=rs.device)
    rows = torch.arange(n, device=rs.device)
    free = cam_col[fi] >= 0
    for c in range(6):
        jac[rows[free], :, cam_col[fi[free]] + c] = j_cam[free][:, :, c]
    for c in range(3):
        jac[rows, :, pt_col[ti] + c] = j_pt[:, :, c]
    jac = jac.reshape(2 * n, ncol)
    res = (r * wt[:, None]).reshape(-1)
    h = jac.T @ jac
    g = -jac.T @ res
    h = h + damping * torch.diag(torch.diag(h)) \
        + 1e-12 * torch.eye(ncol, **f64, device=rs.device)
    step = torch.linalg.solve(h, g)
    return float(cost), float(0.5 * g @ step), n


def eight_point(x1, x2, weights, quantize):
    """(..., 3, 3) F of unit norm and rank 2 from normalized homogeneous
    points (..., N, 3): the null vector of the weighted design matrix."""
    a = quantize(torch.stack([x2[..., 0] * x1[..., 0], x2[..., 0] * x1[..., 1],
                              x2[..., 0], x2[..., 1] * x1[..., 0],
                              x2[..., 1] * x1[..., 1], x2[..., 1],
                              x1[..., 0], x1[..., 1],
                              torch.ones_like(x1[..., 0])], -1))
    a = a * weights[..., None]
    gram = quantize(a.transpose(-1, -2) @ a)
    f = torch.linalg.eigh(gram).eigenvectors[..., :, 0]
    f = f.reshape(*f.shape[:-1], 3, 3)
    u, s, vt = torch.linalg.svd(f)
    s = torch.cat([s[..., :2], torch.zeros_like(s[..., 2:])], -1)
    return quantize((u * s[..., None, :]) @ vt)


def _normalizer(xy):
    c = xy.mean(0)
    s = np.sqrt(2.0) / torch.sqrt(((xy - c) ** 2).sum(-1).mean())
    t = torch.eye(3, dtype=xy.dtype, device=xy.device)
    t[0, 0] = t[1, 1] = s
    t[0, 2] = -s * c[0]
    t[1, 2] = -s * c[1]
    return t


def sampson(f, x1, x2, quantize):
    """(..., N) Sampson distances of pixel points (N, 3) under (..., 3, 3)
    F."""
    fx1 = quantize(x1 @ f.transpose(-1, -2))
    ftx2 = quantize(x2 @ f)
    num = quantize((x2 * fx1).sum(-1)) ** 2
    den = fx1[..., 0] ** 2 + fx1[..., 1] ** 2 + ftx2[..., 0] ** 2 \
        + ftx2[..., 1] ** 2
    return torch.sqrt(quantize(num / torch.clamp(den, min=1e-30)))


def pose_from_f(f, xy1, xy2, inliers, k, dtype=torch.float64,
                quantize=lambda x: x):
    """Camera 2's (R, unit t) that F implies: E = K^T F K decomposed into
    its four candidates, the one with the most ``inliers`` triangulated
    (linear DLT) in front of both cameras."""
    dev = xy1.device
    f = torch.as_tensor(f, device=dev).to(dtype)
    kd = torch.as_tensor(k, device=dev).to(dtype)
    u, _, vt = (quantize(x) for x in
                torch.linalg.svd(quantize(kd.T @ f @ kd)))
    wm = torch.tensor([[0.0, -1.0, 0.0], [1.0, 0.0, 0.0], [0.0, 0.0, 1.0]],
                      dtype=dtype, device=dev)
    kinv = torch.linalg.inv(kd)
    one = torch.ones_like(xy1[:, :1], dtype=dtype)
    xn1 = (torch.cat([xy1.to(dtype), one], -1) @ kinv.T)[inliers]
    xn2 = (torch.cat([xy2.to(dtype), one], -1) @ kinv.T)[inliers]
    p1 = torch.cat([torch.eye(3, dtype=dtype, device=dev),
                    torch.zeros((3, 1), dtype=dtype, device=dev)], 1)
    best, best_count = None, -1
    for rot in (u @ wm @ vt, u @ wm.T @ vt):
        rot = quantize(rot * torch.sign(torch.linalg.det(rot)))
        for tr in (u[:, 2], -u[:, 2]):
            p2 = torch.cat([rot, tr[:, None]], 1)
            a = torch.stack([xn1[:, 0:1] * p1[2] - p1[0],
                             xn1[:, 1:2] * p1[2] - p1[1],
                             xn2[:, 0:1] * p2[2] - p2[0],
                             xn2[:, 1:2] * p2[2] - p2[1]], 1)
            xh = torch.linalg.svd(a).Vh[:, -1]
            pts = xh[:, :3] / xh[:, 3:]
            front = (pts[:, 2] > 0) & ((pts @ rot.T + tr)[:, 2] > 0)
            if int(front.sum()) > best_count:
                best, best_count = (rot, tr), int(front.sum())
    return (best[0].double().cpu().numpy(), best[1].double().cpu().numpy())


def epipolar_consensus(xy1, xy2, rng: np.random.Generator,
                       num_samples: int = 2000, threshold: float = 1.5,
                       quantize=lambda x: x, dtype=torch.float64,
                       keep_best: bool = False):
    """RANSAC over ``num_samples`` normalized 8-point hypotheses drawn
    from ``rng``, scored by Sampson distance, and a refit on the best
    consensus: (F, inlier mask as a tensor) of matched pixel points
    (N, 2); with ``keep_best`` the best hypothesis instead where it holds
    more points than the refit."""
    dev = xy1.device
    one = torch.ones_like(xy1[:, :1], dtype=dtype)
    x1p = torch.cat([xy1.to(dtype), one], -1)
    x2p = torch.cat([xy2.to(dtype), one], -1)
    t1, t2 = _normalizer(x1p[:, :2]), _normalizer(x2p[:, :2])
    x1n, x2n = quantize(x1p @ t1.T), quantize(x2p @ t2.T)
    idx = torch.as_tensor(rng.integers(0, len(xy1), (num_samples, 8)),
                          device=dev)
    ones = torch.ones((num_samples, 8), dtype=dtype, device=dev)
    fs = quantize(t2.T @ eight_point(x1n[idx], x2n[idx], ones, quantize)
                  @ t1)
    inl = sampson(fs, x1p, x2p, quantize) <= threshold
    best = int(torch.argmax(inl.sum(-1)))
    f = quantize(t2.T @ eight_point(x1n, x2n, inl[best].to(dtype), quantize)
                 @ t1)
    refit = sampson(f, x1p, x2p, quantize) <= threshold
    if keep_best and int(inl[best].sum()) > int(refit.sum()):
        return fs[best], inl[best]
    return f, refit


def two_view_pose(xy1, xy2, k, rng: np.random.Generator,
                  num_samples: int = 2000, threshold: float = 1.5,
                  quantize=lambda x: x, dtype=torch.float64):
    """``epipolar_consensus`` and the pose its F implies: (R, unit t, F,
    inlier mask) of matched pixel points (N, 2)."""
    f, inl = epipolar_consensus(xy1, xy2, rng, num_samples, threshold,
                                quantize, dtype)
    r, t = pose_from_f(f, xy1, xy2, inl, k, dtype, quantize)
    return r, t, f, inl.cpu().numpy()
