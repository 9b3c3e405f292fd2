"""Plain reference of the loop-closure stage that ``run_sfm --loop-closure``
runs after SfM: place recognition over the frame-pair grid, candidate
selection, the loop edges' trimmed bearing Procrustes, the SE(3) pose
graph (its cost, its Gauss-Newton decrement and an LM run to convergence)
and the n-view DLT re-triangulation under given poses.

Written from the mathematics the port states in the docstrings of
``sfm/loop_closure.py`` and ``sfm/pose_graph.py``, in float64 NumPy and
plain PyTorch (float64 operands, which TF32 does not touch); it imports
nothing of the port or of JAX.  The same file is the tier-1 tests'
``tests/_loop_reference.py`` and the benchmark's
``benchmarks/reference/loop.py``.

Departures from the port, each on purpose:
- Hamming distances are counted in float64 from the 0/1 bits (exact), not
  on tensor cores; argmins take the first index among equals, as
  ``ops/match.py`` documents.
- Among candidates of equal count the docstrings name no order: the later
  pair comes first, the order of the port's (count, i, j) sort, descending.
- The Procrustes fit solves its 3x3 SVD in float64; the port's runs in
  float32.
- The pose graph's Jacobians are central differences in float64 over each
  node's left increment; the port takes them by forward-mode autodiff.  The
  Gauss-Newton decrement does not depend on the chart of the increments,
  and the step of the LM run only on how far its Jacobian is off.
- The LM run goes on until a step no longer lowers the cost, where the
  port runs a fixed number of iterations.
- The n-view DLT takes the smallest right singular vector of the stacked
  rows; the port takes the smallest eigenvector of their 4x4 Gram matrix
  with a 1e-12 ridge, the same minimiser squared in its conditioning
  (``dlt_nview`` returns that conditioning a track).
"""
from __future__ import annotations

import numpy as np
import torch

INT_INF = 2 ** 31 - 1


# -- place recognition -------------------------------------------------------

def hamming(bits_a, mask_a, bits_b, mask_b) -> torch.Tensor:
    """(..., Na, Nb) int64 Hamming distances between the rows of two (...,
    N, P) 0/1 bit tensors; INT_INF where either keypoint is masked out."""
    a = bits_a.to(torch.float64)
    b = bits_b.to(torch.float64)
    # 0/1 products summed in float64: exact for P < 2**53
    d = (a.sum(-1)[..., :, None] + b.sum(-1)[..., None, :]
         - 2.0 * a @ b.transpose(-1, -2)).to(torch.int64)
    m = mask_a.bool()[..., :, None] & mask_b.bool()[..., None, :]
    return torch.where(m, d, torch.full_like(d, INT_INF))


def mutual_nearest(dist: torch.Tensor, threshold: int) -> torch.Tensor:
    """(..., Na) bool: row r's nearest column c (the first among equals) has
    r as its nearest row (the first among equals) and lies within
    ``threshold``."""
    best_c = torch.argmin(dist, dim=-1)                       # (..., Na)
    best_r = torch.argmin(dist, dim=-2)                       # (..., Nb)
    d = torch.gather(dist, -1, best_c[..., None])[..., 0]
    rows = torch.arange(dist.shape[-2], device=dist.device)
    back = torch.gather(best_r, -1, best_c)
    return (back == rows) & (d <= threshold) & (d < INT_INF)


def match_counts(bits, masks, threshold: int) -> np.ndarray:
    """(F, F) int64 counts of mutual-nearest matches within ``threshold``
    for every frame pair, frame i's keypoints the rows of pair (i, j)."""
    bits = torch.as_tensor(bits)
    masks = torch.as_tensor(masks)
    f = bits.shape[0]
    out = np.zeros((f, f), np.int64)
    for i in range(f):
        d = hamming(bits[i].expand(f, -1, -1), masks[i].expand(f, -1),
                    bits, masks)
        out[i] = mutual_nearest(d, threshold).sum(-1).cpu().numpy()
    return out


def matches(bits_r, mask_r, bits_c, mask_c, threshold: int):
    """(rows, cols) int64 index arrays of the mutual-nearest matches of the
    rows' keypoints among the columns'."""
    bits_r, mask_r, bits_c, mask_c = (torch.as_tensor(x) for x in
                                      (bits_r, mask_r, bits_c, mask_c))
    d = hamming(bits_r, mask_r, bits_c, mask_c)
    ok = mutual_nearest(d, threshold)
    rows = torch.nonzero(ok)[:, 0]
    return (rows.cpu().numpy(),
            torch.argmin(d, dim=-1)[rows].cpu().numpy())


def select_candidates(counts, min_gap: int, min_matches: int,
                      max_candidates: int) -> list:
    """Pairs (i, j) with j - i >= min_gap and a count of at least
    ``min_matches``, strongest first (the later pair first among equal
    counts), at most ``max_candidates``."""
    counts = np.asarray(counts)
    f = counts.shape[0]
    got = [(int(counts[i, j]), i, j) for i in range(f)
           for j in range(i + min_gap, f) if counts[i, j] >= min_matches]
    got.sort(key=lambda c: (-c[0], -c[1], -c[2]))
    return [(i, j) for _, i, j in got[:max_candidates]]


# -- the loop edge's rotation ------------------------------------------------

def _same(x):
    return x


def bearings(xy, k, quantize=_same) -> np.ndarray:
    """(N, 3) unit bearing vectors K^-1 (x, y, 1) / |.| of pixels."""
    xy = np.asarray(xy, np.float64)
    h = np.concatenate([xy, np.ones((len(xy), 1))], 1) \
        @ np.linalg.inv(np.asarray(k, np.float64)).T
    return quantize(h / np.linalg.norm(h, axis=1, keepdims=True))


def trimmed_procrustes(xy1, xy2, mask, k, rounds: int = 3,
                       quantize=_same):
    """The rotation R with bearing(xy2) ~ R bearing(xy1), fitted in
    ``rounds`` rounds: each fits the weighted orthogonal Procrustes
    rotation (sum of w b2 b1^T = U S V^T, R = U diag(1, 1, det(U V^T))
    V^T) to the kept bearings, then keeps those whose residual |b2 - R b1|
    is below 3 x the mean residual of the kept.  Returns (R, the count
    kept after the last round, the margin: the least distance of a kept
    bearing's residual to its round's cut, over the cut, a cut that a
    rounding of that size or more could move a bearing across).
    ``quantize`` rounds the bearings and the 3x3 sum (the control's lower
    precision)."""
    b1 = bearings(xy1, k, quantize)
    b2 = bearings(xy2, k, quantize)
    w = np.asarray(mask, np.float64)
    r = np.eye(3)
    margin = np.inf
    for _ in range(rounds):
        u, _, vt = np.linalg.svd(quantize((b2 * w[:, None]).T @ b1))
        d = np.sign(np.linalg.det(u @ vt))
        r = u @ np.diag([1.0, 1.0, d]) @ vt
        resid = np.linalg.norm(b2 - b1 @ r.T, axis=1)
        mean = (resid * w).sum() / max(w.sum(), 1.0)
        cut = 3.0 * mean + 1e-9
        if w.any():
            margin = min(margin, float(np.abs(resid - cut)[w > 0].min()
                                       / cut))
        w = w * (resid < cut)
    return r, int(w.sum()), margin


def rotation_deg(r_a, r_b) -> float:
    """The angle (degrees) of the rotation between two rotations, from
    atan2(|sin|, cos) of R_a^T R_b (an arccos of the trace alone reads
    float32 rounding of the matrices as ~0.02 degrees)."""
    return float(np.degrees(np.linalg.norm(so3_log(
        np.asarray(r_a, np.float64).T @ np.asarray(r_b, np.float64)))))


# -- SE(3) --------------------------------------------------------------------

def hat(w):
    w = np.asarray(w, np.float64)
    z = np.zeros(w.shape[:-1])
    return np.stack([np.stack([z, -w[..., 2], w[..., 1]], -1),
                     np.stack([w[..., 2], z, -w[..., 0]], -1),
                     np.stack([-w[..., 1], w[..., 0], z], -1)], -2)


def so3_exp(w):
    """Rodrigues: (..., 3) axis-angle -> (..., 3, 3)."""
    w = np.asarray(w, np.float64)
    th = np.linalg.norm(w, axis=-1)[..., None, None]
    k = hat(w)
    small = th < 1e-8
    safe = np.where(small, 1.0, th)
    a = np.where(small, 1.0 - th ** 2 / 6.0, np.sin(safe) / safe)
    b = np.where(small, 0.5 - th ** 2 / 24.0, (1.0 - np.cos(safe)) / safe ** 2)
    return np.eye(3) + a * k + b * (k @ k)


def so3_log(r):
    """(..., 3, 3) -> (..., 3) axis-angle, the angle from atan2(|sin|,
    cos)."""
    r = np.asarray(r, np.float64)
    vee = np.stack([r[..., 2, 1] - r[..., 1, 2], r[..., 0, 2] - r[..., 2, 0],
                    r[..., 1, 0] - r[..., 0, 1]], -1)
    s = np.linalg.norm(vee, axis=-1) / 2.0
    c = (np.trace(r, axis1=-2, axis2=-1) - 1.0) / 2.0
    th = np.arctan2(s, c)
    small = s < 1e-8
    scale = np.where(small, 0.5 + th ** 2 / 12.0,
                     th / (2.0 * np.where(small, 1.0, s)))
    return scale[..., None] * vee


def _v_matrices(w):
    """(V, V^-1) of the SE(3) exponential's translation part."""
    th2 = (np.asarray(w) ** 2).sum(-1)[..., None, None]
    th = np.sqrt(th2)
    k = hat(w)
    small = th < 1e-6
    safe = np.where(small, 1.0, th)
    b = np.where(small, 0.5 - th2 / 24.0, (1.0 - np.cos(safe)) / safe ** 2)
    c = np.where(small, 1.0 / 6.0 - th2 / 120.0,
                 (safe - np.sin(safe)) / safe ** 3)
    half = safe / 2.0
    d = np.where(small, 1.0 / 12.0 + th2 / 720.0,
                 (1.0 - half * np.cos(half) / np.sin(half)) / safe ** 2)
    eye = np.eye(3)
    return eye + b * k + c * (k @ k), eye - 0.5 * k + d * (k @ k)


def se3_exp(xi):
    """Twist (..., 6) [w | v] -> (R, t) = (exp(w), V(w) v)."""
    xi = np.asarray(xi, np.float64)
    v, _ = _v_matrices(xi[..., :3])
    return so3_exp(xi[..., :3]), (v @ xi[..., 3:, None])[..., 0]


def se3_log(r, t):
    """(R, t) -> twist (..., 6) [w | V(w)^-1 t]."""
    w = so3_log(r)
    _, vinv = _v_matrices(w)
    return np.concatenate([w, (vinv @ np.asarray(t, np.float64)[..., None])
                           [..., 0]], -1)


def relative_pose(r_i, t_i, r_j, t_j):
    """Z with T_j = Z o T_i for world-to-camera poses."""
    r = r_j @ np.swapaxes(r_i, -1, -2)
    return r, t_j - (r @ t_i[..., None])[..., 0]


def centers(rs, ts) -> np.ndarray:
    return -np.einsum("fji,fj->fi", np.asarray(rs, np.float64),
                      np.asarray(ts, np.float64))


# -- the pose graph -----------------------------------------------------------

def chain_graph(rs, ts, loop_edges, loop_rs, loop_ts,
                odometry_weight: float = 1.0, loop_weight: float = 4.0):
    """The loop-closure graph: the odometry chain (t-1, t) measured at the
    given poses, then the loop edges with their measurements.  Returns
    (edges (E, 2), z_rs (E, 3, 3), z_ts (E, 3), weights (E,))."""
    rs = np.asarray(rs, np.float64)
    ts = np.asarray(ts, np.float64)
    f = len(rs)
    zr, zt = relative_pose(rs[:-1], ts[:-1], rs[1:], ts[1:])
    edges = [(t - 1, t) for t in range(1, f)] + [tuple(e) for e in
                                                 loop_edges]
    z_rs = np.concatenate([zr, np.asarray(loop_rs, np.float64)
                           .reshape(-1, 3, 3)])
    z_ts = np.concatenate([zt, np.asarray(loop_ts, np.float64)
                           .reshape(-1, 3)])
    w = [odometry_weight] * (f - 1) + [loop_weight] * len(loop_edges)
    return (np.asarray(edges, np.int64).reshape(-1, 2), z_rs, z_ts,
            np.asarray(w, np.float64))


def residuals(rs, ts, graph) -> np.ndarray:
    """(E, 6) r_ij = log_SE3(T_j o (Z_ij T_i)^-1)."""
    edges, z_rs, z_ts, _ = graph
    rs = np.asarray(rs, np.float64)
    ts = np.asarray(ts, np.float64)
    i, j = edges[:, 0], edges[:, 1]
    pr = z_rs @ rs[i]
    pt = (z_rs @ ts[i][..., None])[..., 0] + z_ts
    er = rs[j] @ np.swapaxes(pr, -1, -2)
    et = ts[j] - (er @ pt[..., None])[..., 0]
    return se3_log(er, et)


def cost(rs, ts, graph) -> float:
    """1/2 sum of w_ij |r_ij|^2."""
    r = residuals(rs, ts, graph)
    return float(0.5 * (graph[3][:, None] * r * r).sum())


def _perturb(rs, ts, node: int, xi):
    dr, dt = se3_exp(xi)
    rs = rs.copy()
    ts = ts.copy()
    rs[node] = dr @ rs[node]
    ts[node] = dr @ ts[node] + dt
    return rs, ts


def _normal_equations(rs, ts, graph, free, step: float = 1e-6):
    """(H, g) of the weighted Gauss-Newton model over the free nodes' left
    increments (6 a node), the Jacobian by central differences."""
    edges, _, _, w = graph
    rs = np.asarray(rs, np.float64)
    ts = np.asarray(ts, np.float64)
    r0 = residuals(rs, ts, graph)
    col = {n: 6 * c for c, n in enumerate(free)}
    jac = np.zeros((len(edges), 6, 6 * len(free)))
    for n in free:
        touched = np.nonzero((edges[:, 0] == n) | (edges[:, 1] == n))[0]
        if not len(touched):
            continue
        sub = (edges[touched], graph[1][touched], graph[2][touched],
               w[touched])
        for a in range(6):
            xi = np.zeros(6)
            xi[a] = step
            plus = residuals(*_perturb(rs, ts, n, xi), sub)
            minus = residuals(*_perturb(rs, ts, n, -xi), sub)
            jac[touched, :, col[n] + a] = (plus - minus) / (2 * step)
    sw = np.sqrt(w)[:, None, None]
    jw = (jac * sw).reshape(-1, 6 * len(free))
    rw = (r0 * sw[..., 0]).reshape(-1)
    return jw.T @ jw, jw.T @ rw


def _solve(h, g):
    try:
        return np.linalg.solve(h, g)
    except np.linalg.LinAlgError:
        return np.linalg.lstsq(h, g, rcond=None)[0]


def gn_decrement(rs, ts, graph, fixed=(0,)) -> float:
    """g^T H^-1 g / 2: how far one Gauss-Newton step of the graph's cost
    would lower it from these poses, the ``fixed`` nodes frozen (node 0,
    the gauge)."""
    free = [n for n in range(len(rs)) if n not in set(fixed)]
    h, g = _normal_equations(rs, ts, graph, free)
    return float(0.5 * g @ _solve(h, g))


def lm(rs, ts, graph, fixed=(0,), init_lambda: float = 1e-4,
       max_iterations: int = 200):
    """Levenberg-Marquardt to convergence: the step of (H + lambda
    diag(H)) d = -g over the free nodes' left increments, kept where it
    lowers the cost (lambda halved) and refused where not (lambda x 4),
    until ten refusals in a row or ``max_iterations``.  Returns (rs, ts,
    final cost, initial cost)."""
    rs = np.asarray(rs, np.float64).copy()
    ts = np.asarray(ts, np.float64).copy()
    free = [n for n in range(len(rs)) if n not in set(fixed)]
    c0 = c = cost(rs, ts, graph)
    lam, refused = init_lambda, 0
    for _ in range(max_iterations):
        h, g = _normal_equations(rs, ts, graph, free)
        d = _solve(h + lam * np.diag(np.maximum(np.diag(h), 1e-6)), -g)
        cand_rs, cand_ts = rs.copy(), ts.copy()
        for c_, n in enumerate(free):
            cand_rs, cand_ts = _perturb(cand_rs, cand_ts, n,
                                        d[6 * c_:6 * c_ + 6])
        new = cost(cand_rs, cand_ts, graph)
        if new < c:
            rs, ts, c = cand_rs, cand_ts, new
            lam, refused = max(lam * 0.5, 1e-12), 0
        else:
            lam, refused = min(lam * 4.0, 1e8), refused + 1
            if refused >= 10:
                break
    return rs, ts, c, c0


# -- re-triangulation -----------------------------------------------------------

def dlt_nview(obs, mask, rs, ts, k, quantize=_same):
    """Each track's point from all its observing views: the smallest right
    singular vector of the rows x_n P[2] - P[0], y_n P[2] - P[1] (normalized
    coordinates, P = [R | t]) of every view that observes it.  obs (F, T,
    2), mask (F, T), rs (F, 3, 3), ts (F, 3) -> (points (T, 3), depths
    (F, T) in each view, condition (T,)).  ``quantize`` rounds the rows
    (the control).  The condition s_1^2 / (s_3^2 - s_4^2) of the singular
    values s_1 >= ... >= s_4 is how far a rounding of the rows' 4x4 Gram
    matrix, relative to its size, can turn the solution: float32's 1.2e-7
    times it."""
    obs = np.asarray(obs, np.float64)
    mask = np.asarray(mask, bool)
    rs = np.asarray(rs, np.float64)
    ts = np.asarray(ts, np.float64)
    k = np.asarray(k, np.float64)
    xn = (obs[..., 0] - k[0, 2]) / k[0, 0]
    yn = (obs[..., 1] - k[1, 2]) / k[1, 1]
    p = np.concatenate([rs, ts[:, :, None]], 2)                  # (F, 3, 4)
    a1 = xn[..., None] * p[:, None, 2] - p[:, None, 0]            # (F, T, 4)
    a2 = yn[..., None] * p[:, None, 2] - p[:, None, 1]
    a = np.concatenate([a1, a2], 0) * np.concatenate([mask, mask])[..., None]
    a = quantize(np.swapaxes(a, 0, 1))                            # (T, 2F, 4)
    _, sv, vt = np.linalg.svd(a)
    xh = vt[:, -1]                                                # (T, 4)
    den = np.where(np.abs(xh[:, 3]) < 1e-300, 1e-300, xh[:, 3])
    pts = xh[:, :3] / den[:, None]
    depths = np.einsum("fj,tj->ft", rs[:, 2], pts) + ts[:, None, 2]
    cond = sv[:, 0] ** 2 / np.maximum(sv[:, 2] ** 2 - sv[:, 3] ** 2, 1e-300)
    return pts, depths, cond


def project(points, rs, ts, k) -> np.ndarray:
    """(F, T, 2) pixels of the points (T, 3) in every view."""
    cam = np.einsum("fij,tj->fti", np.asarray(rs, np.float64),
                    np.asarray(points, np.float64)) \
        + np.asarray(ts, np.float64)[:, None]
    uvw = cam @ np.asarray(k, np.float64).T
    return uvw[..., :2] / uvw[..., 2:3]
