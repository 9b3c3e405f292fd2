"""Bundle adjustment: Levenberg-Marquardt with a Schur-complement reduced
camera system (port of photogrammetry_tpu/sfm/ba.py).

Observations are a dense (F frames, T tracks) grid with a validity mask.
Residuals and the analytic Jacobians J_cam (F,T,2,6) / J_pt (F,T,2,3) are
elementwise tensor code; H_pp is (T,3,3) block-diagonal and inverted in
closed form; the reduced camera system S = H_cc - W H_pp^-1 W^T is a dense
(6F, 6F) matrix whose off-diagonal products come from the hand-written
kernel ``kernels/schur.py`` (on CUDA tensors) and is solved with
``torch.linalg.solve_ex``.  Pose increments are left-multiplicative SE(3)
twists; Huber IRLS weights are folded into r and J.

The LM loop runs a fixed number of iterations; accept/reject is a
``torch.where`` on the device, so a BA reads nothing back to the host, and
on CUDA a repeated call replays the loop as one cached CUDA graph.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from photogrammetry_tpu_torch.core.lie import se3_exp, so3_hat, so3_log
from photogrammetry_tpu_torch.kernels.schur import (
    schur_products, schur_products_plain,
)
from photogrammetry_tpu_torch.utils import graphs
from photogrammetry_tpu_torch.utils.profiling import count, span


class BAProblem(NamedTuple):
    obs: torch.Tensor       # (F, T, 2) observed pixel (x, y)
    mask: torch.Tensor      # (F, T) bool
    k: torch.Tensor         # (3, 3) intrinsics


class BAState(NamedTuple):
    rs: torch.Tensor        # (F, 3, 3) world->cam rotations
    ts: torch.Tensor        # (F, 3) world->cam translations
    points: torch.Tensor    # (T, 3) landmarks (world)


class BAResult(NamedTuple):
    state: BAState
    cost: torch.Tensor
    initial_cost: torch.Tensor
    iterations: int


def project(rs, ts, points, k):
    """(F,3,3),(F,3),(T,3) → pixel (F,T,2), depth (F,T), camera coords."""
    pc = torch.einsum("fij,tj->fti", rs, points) + ts[:, None, :]
    z = pc[..., 2]
    zs = torch.where(z.abs() < 1e-9, 1e-9, z)
    x = k[0, 0] * pc[..., 0] / zs + k[0, 2]
    y = k[1, 1] * pc[..., 1] / zs + k[1, 2]
    return torch.stack([x, y], dim=-1), z, pc


def residuals_and_jacobians(state: BAState, prob: BAProblem,
                            huber_delta: float = 3.0):
    """Weighted residuals r (F,T,2), J_cam (F,T,2,6), J_pt (F,T,2,3), the
    robust cost and the valid-observation count.  Invalid and
    behind-camera observations are zero-weighted."""
    rs, ts, points = state
    pred, z, pc = project(rs, ts, points, prob.k)
    r = pred - prob.obs
    valid = prob.mask & (z > 1e-6)
    rn = torch.sqrt((r * r).sum(-1) + 1e-12)
    hw = torch.clamp(huber_delta / rn, max=1.0)
    sw = torch.sqrt(valid.to(torch.float32) * hw)

    fx = prob.k[0, 0]
    fy = prob.k[1, 1]
    zinv = 1.0 / torch.where(z.abs() < 1e-9, 1e-9, z)
    zeros = torch.zeros_like(z)
    dpi = torch.stack([
        torch.stack([fx * zinv, zeros, -fx * pc[..., 0] * zinv ** 2], -1),
        torch.stack([zeros, fy * zinv, -fy * pc[..., 1] * zinv ** 2], -1),
    ], -2)                                                   # (F,T,2,3)
    # dp/d(delta_w) = -[p]x ; dp/d(delta_v) = I  (left increment)
    j_cam_w = dpi @ -so3_hat(pc)                             # (F,T,2,3)
    j_cam = torch.cat([j_cam_w, dpi], dim=-1)                # (F,T,2,6)
    j_pt = dpi @ rs[:, None]                                 # (F,T,2,3)

    r = r * sw[..., None]
    j_cam = j_cam * sw[..., None, None]
    j_pt = j_pt * sw[..., None, None]

    quad = 0.5 * rn ** 2
    lin = huber_delta * (rn - 0.5 * huber_delta)
    cost = (torch.where(rn <= huber_delta, quad, lin)
            * valid.to(torch.float32)).sum()
    return r, j_cam, j_pt, cost, valid.sum()


def _inv3(m):
    """Batched closed-form 3x3 inverse (…,3,3)."""
    a, b, c = m[..., 0, 0], m[..., 0, 1], m[..., 0, 2]
    d, e, f = m[..., 1, 0], m[..., 1, 1], m[..., 1, 2]
    g, h, i = m[..., 2, 0], m[..., 2, 1], m[..., 2, 2]
    co_a = e * i - f * h
    co_b = -(d * i - f * g)
    co_c = d * h - e * g
    det = a * co_a + b * co_b + c * co_c
    det = torch.where(det.abs() < 1e-12, 1e-12, det)
    adj = torch.stack([
        torch.stack([co_a, -(b * i - c * h), b * f - c * e], -1),
        torch.stack([co_b, a * i - c * g, -(a * f - c * d)], -1),
        torch.stack([co_c, -(a * h - b * g), a * e - b * d], -1),
    ], -2)
    return adj / det[..., None, None]


def landmark_terms(r, j_cam, j_pt, lam, plain: bool = False):
    """The landmark-side terms of one damped Gauss-Newton step, summed over
    the landmarks of ``r`` (all of them, or one shard's).

    r (F,T,2) weighted residuals; j_cam (F,T,2,6); j_pt (F,T,2,3); lam the
    LM damping (scalar tensor).  H_pp is block-diagonal, so each landmark's
    damped block and its inverse stay with the landmark.  ``plain=True``
    forms the Schur products with their plain version on any device.
    Returns the camera-side sums (h_cc (F,6,6) undamped, b_c (F,6), s_off
    (F,F,6,6) = W Hpp^-1 W^T, corr (F,6) = W Hpp^-1 b_p) and what
    ``back_substitute`` needs (w_cp (F,T,6,3), b_p (T,3), hpp_inv (T,3,3)).
    """
    dev = r.device
    h_cc = torch.einsum("ftri,ftrj->fij", j_cam, j_cam)          # (F,6,6)
    h_pp = torch.einsum("ftri,ftrj->tij", j_pt, j_pt)            # (T,3,3)
    w_cp = torch.einsum("ftri,ftrj->ftij", j_cam, j_pt)          # (F,T,6,3)
    b_c = -torch.einsum("ftri,ftr->fi", j_cam, r)                # (F,6)
    b_p = -torch.einsum("ftri,ftr->ti", j_pt, r)                 # (T,3)

    eye3 = torch.eye(3, device=dev)
    h_pp = h_pp + lam * (h_pp * eye3) + 1e-8 * eye3
    hpp_inv = _inv3(h_pp)                                         # (T,3,3)

    # the off-diagonal products of S = H_cc - W Hpp^-1 W^T
    w_hinv = torch.einsum("ftij,tjk->ftik", w_cp, hpp_inv)       # (F,T,6,3)
    products = schur_products_plain if plain else schur_products
    s_off, corr = products(w_hinv.contiguous(), w_cp.contiguous(),
                           b_p.contiguous())
    return (h_cc, b_c, s_off, corr), (w_cp, b_p, hpp_inv)


def camera_step(h_cc, b_c, s_off, corr, lam, fixed_cameras):
    """The camera increments (F,6) from the reduced camera system
    S = H_cc - s_off (dense (6F, 6F)), right-hand side b_c - corr: H_cc
    damped by lam, gauge cameras (``fixed_cameras`` 0) frozen."""
    f = h_cc.shape[0]
    dev = h_cc.device
    eye6 = torch.eye(6, device=dev)
    h_cc = h_cc + lam * (h_cc * eye6) + 1e-8 * eye6
    ar = torch.arange(f, device=dev)
    s = -s_off
    s[ar, ar] = s[ar, ar] + h_cc
    rhs = b_c - corr

    # freeze gauge cameras: zero their rows/cols, identity diagonal
    fc = fixed_cameras.to(torch.float32)
    s = s * (fc[:, None, None, None] * fc[None, :, None, None])
    s[ar, ar] = s[ar, ar] + (1.0 - fc)[:, None, None] * eye6
    rhs = rhs * fc[:, None]

    s_mat = s.permute(0, 2, 1, 3).reshape(6 * f, 6 * f)
    delta_c = torch.linalg.solve_ex(s_mat, rhs.reshape(-1, 1))[0]
    return delta_c.reshape(f, 6) * fc[:, None]


def back_substitute(w_cp, b_p, hpp_inv, delta_c):
    """The landmark increments (T,3) given the camera increments."""
    rhs_p = b_p - torch.einsum("ftij,fi->tj", w_cp, delta_c)
    return (hpp_inv @ rhs_p[..., None])[..., 0]


def schur_solve(r, j_cam, j_pt, lam, fixed_cameras,
                h_prior=None, b_prior=None, plain: bool = False):
    """One damped Gauss-Newton step via the Schur complement.

    r (F,T,2) weighted residuals; j_cam (F,T,2,6); j_pt (F,T,2,3); lam the
    LM damping (scalar tensor); fixed_cameras (F,) float, 0 freezes a
    camera.  h_prior (F,) / b_prior (F,6): the pose-prior block w^2 I and
    its right-hand side.  ``plain=True`` forms the Schur products with
    their plain version on any device.  Returns (delta_cam (F,6),
    delta_pt (T,3)).
    """
    (h_cc, b_c, s_off, corr), back = landmark_terms(r, j_cam, j_pt, lam,
                                                    plain)
    if h_prior is not None:
        h_cc = h_cc + h_prior[:, None, None] * torch.eye(6, device=r.device)
        b_c = b_c + b_prior
    delta_c = camera_step(h_cc, b_c, s_off, corr, lam, fixed_cameras)
    return delta_c, back_substitute(*back, delta_c)


def apply_step(state: BAState, delta_c, delta_p,
               update_points: bool = True) -> BAState:
    """Left-multiplicative pose update + landmark update."""
    dr, dt = se3_exp(delta_c)
    rs = dr @ state.rs
    ts = (dr @ state.ts[..., None])[..., 0] + dt
    points = state.points + delta_p if update_points else state.points
    return BAState(rs=rs, ts=ts, points=points)


def _lm_loop(state: BAState, prob: BAProblem, fixed_cameras, prior_rs,
             prior_ts, *, num_iterations, huber_delta, init_lambda,
             optimize_points, use_pose_prior, prior_weight, plain,
             tally=False):
    """``bundle_adjust``'s LM loop: (state, cost, initial cost, accepted),
    ``accepted`` the number of accepted steps (0-dim) where ``tally``, else
    None.  Each accept flag also goes to the counter ``ba.lm_accepted``,
    which records nothing inside a capture."""
    f = state.rs.shape[0]
    dev = state.rs.device
    if fixed_cameras is None:
        fixed_cameras = torch.ones((f,), device=dev)
        fixed_cameras[0] = 0.0
    w2 = float(prior_weight) ** 2

    def prior_terms(st):
        """(energy, b_prior (F,6)) of the pose-anchor residuals."""
        v_rot = so3_log(st.rs @ prior_rs.transpose(-1, -2))
        v_t = st.ts - prior_ts
        e = 0.5 * w2 * ((v_rot ** 2).sum() + (v_t ** 2).sum())
        return e, -w2 * torch.cat([v_rot, v_t], dim=-1)

    _, _, _, cost, nvalid = residuals_and_jacobians(state, prob, huber_delta)
    if use_pose_prior:
        cost = cost + prior_terms(state)[0]
    cost0 = cost
    lam = torch.full((), init_lambda, dtype=torch.float32, device=dev)
    h_pr = torch.full((f,), w2, device=dev) if use_pose_prior else None
    accepts = []
    for _ in range(num_iterations):
        r, j_cam, j_pt, _, _ = residuals_and_jacobians(state, prob,
                                                       huber_delta)
        if not optimize_points:
            j_pt = torch.zeros_like(j_pt)
        b_pr = prior_terms(state)[1] if use_pose_prior else None
        delta_c, delta_p = schur_solve(r, j_cam, j_pt, lam, fixed_cameras,
                                       h_prior=h_pr, b_prior=b_pr,
                                       plain=plain)
        cand = apply_step(state, delta_c, delta_p, optimize_points)
        _, _, _, new_cost, new_nvalid = residuals_and_jacobians(
            cand, prob, huber_delta)
        if use_pose_prior:
            new_cost = new_cost + prior_terms(cand)[0]
        # support guard: validity is state-dependent, so a diverged step
        # that throws observations behind the cameras lowers the cost for
        # free; reject any step losing > 10% of the current support
        support_ok = new_nvalid.to(torch.float32) >= \
            0.9 * nvalid.to(torch.float32)
        accept = (new_cost < cost) & torch.isfinite(new_cost) & support_ok
        count("ba.lm_accepted", accept)
        if tally:
            accepts.append(accept)
        state = BAState(*(torch.where(accept, a, b)
                          for a, b in zip(cand, state)))
        cost = torch.where(accept, new_cost, cost)
        nvalid = torch.where(accept, new_nvalid, nvalid)
        lam = torch.where(accept, torch.clamp(lam * 0.5, min=1e-9),
                          torch.clamp(lam * 4.0, max=1e6))
    accepted = None
    if tally:
        accepted = (torch.stack(accepts).sum() if accepts else
                    torch.zeros((), dtype=torch.int64, device=dev))
    return state, cost, cost0, accepted


# -- the LM loop as a cached CUDA graph --------------------------------------
#
# ``utils.graphs.LoopCache``: a CUDA solve whose key (the input layouts, the
# device and every Python argument) was seen before replays a capture of
# ``_lm_loop``.

_CACHE = graphs.LoopCache(_lm_loop, "ba")


def _solve(args, opts):
    """(state, cost, initial cost) of the LM loop: eager, captured or
    replayed, as the device, the capture state and the cache decide."""
    return _CACHE.solve(args, opts)


def bundle_adjust(state: BAState, prob: BAProblem,
                  num_iterations: int = 20,
                  huber_delta: float = 3.0,
                  init_lambda: float = 1e-3,
                  fixed_cameras: torch.Tensor | None = None,
                  optimize_points: bool = True,
                  use_pose_prior: bool = False,
                  prior_rs: torch.Tensor | None = None,
                  prior_ts: torch.Tensor | None = None,
                  prior_weight: float = 0.0,
                  plain: bool = False) -> BAResult:
    """Levenberg-Marquardt bundle adjustment (fixed iteration count).

    fixed_cameras: (F,) float mask, 0 freezes a camera (default: camera 0,
    the gauge).  optimize_points=False gives motion-only BA.
    use_pose_prior=True adds the trajectory anchor
    w^2/2 (||log(R R_p^T)||^2 + ||t - t_p||^2) per camera toward
    (prior_rs, prior_ts), included in the LM accept test.  A step is
    accepted when it lowers the cost, is finite and keeps >= 90% of the
    valid observations; recording (``utils.profiling``) counts the
    iterations in ``ba.lm_iterations`` and each accept flag in
    ``ba.lm_accepted``.  ``plain=True`` runs the Schur products' plain
    version on any device (the reference run on the card).

    On CUDA a call whose arguments repeat an earlier call's shapes and
    options replays a cached CUDA graph of the loop (the same kernels and
    bits; the cache above ``_solve``), captured on the key's second call,
    and runs eagerly on its first call, on the call that finds the cache
    full and inside another capture.  Recording counts
    ``ba.graph_replays`` (a capture's own replay included),
    ``ba.graph_captures`` and ``ba.eager_solves`` (CUDA calls run
    eagerly).
    """
    with span("ba.solve", iterations=num_iterations):
        args = (state, prob, fixed_cameras, prior_rs, prior_ts)
        opts = dict(num_iterations=int(num_iterations),
                    huber_delta=float(huber_delta),
                    init_lambda=float(init_lambda),
                    optimize_points=bool(optimize_points),
                    use_pose_prior=bool(use_pose_prior),
                    prior_weight=float(prior_weight), plain=bool(plain))
        state, cost, cost0 = _solve(args, opts)
        count("ba.lm_iterations", num_iterations)
        return BAResult(state=state, cost=cost, initial_cost=cost0,
                        iterations=num_iterations)
