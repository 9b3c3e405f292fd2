"""Pose-graph optimization, SE(3) and Sim(3) (port of
photogrammetry_tpu/sfm/pose_graph.py).

Nodes are world→camera poses; an edge (i, j) carries a measured relative
transform Z_ij with the convention T_j ≈ Z_ij ∘ T_i and residual
r_ij = log_SE3(T_j ∘ (Z_ij T_i)^-1) ∈ R^6 (Sim(3): a 7th row, the
log-scale error).

Per-edge Jacobians with respect to the left-increment twists of both
endpoints come from forward-mode autodiff at the zero increment,
``torch.func.vmap(torch.func.jacfwd(...))`` over ``core/lie.py``, as the
JAX package takes them with ``jax.vmap(jax.jacfwd(...))``.  Forward mode
matters: the ``torch.where`` small-angle branches of ``so3_exp`` /
``se3_exp`` evaluate ``(1 - cos θ) / θ²`` at θ = 0 in the branch that is
not selected; forward mode drops that branch's tangent, reverse mode
would multiply its infinite derivative by a zero cotangent and return NaN.

The normal equations are assembled densely at (6N, 6N) ((7N, 7N) for
Sim(3)) from one-hot edge incidences as a matrix product (a fixed
summation order, where ``index_put_(accumulate=True)`` on CUDA adds in no
fixed order) and solved with ``torch.linalg.solve_ex`` (no error check, so
no host read; a singular step gives a non-finite cost and is rejected).
The LM loop runs a fixed ``num_iterations`` on the device, accept/reject
by ``torch.where`` on the cost, as JAX runs it in one ``lax.scan``; on
CUDA a repeated solve replays the loop as one cached CUDA graph
(``utils.graphs.LoopCache``).
"""
from __future__ import annotations

from typing import NamedTuple

import torch
from torch.func import jacfwd, vmap

from photogrammetry_tpu_torch.core.lie import se3_exp, se3_log
from photogrammetry_tpu_torch.utils import graphs
from photogrammetry_tpu_torch.utils.profiling import count, span


class PoseGraph(NamedTuple):
    edges: torch.Tensor     # (E, 2) int32 node indices (i, j)
    z_rs: torch.Tensor      # (E, 3, 3) measured relative rotations
    z_ts: torch.Tensor      # (E, 3) measured relative translations
    weights: torch.Tensor   # (E,) float32 edge information weights


def relative_pose(r_i, t_i, r_j, t_j):
    """Z such that T_j = Z ∘ T_i for world→cam poses (batched)."""
    r = r_j @ r_i.transpose(-1, -2)
    t = t_j - (r @ t_i[..., None])[..., 0]
    return r, t


def _mv(m, v):
    return (m @ v[..., None])[..., 0]


def _edge_residual(r_i, t_i, r_j, t_j, z_r, z_t):
    """log_SE3(T_j ∘ (Z T_i)^-1) as a 6-vector (batched)."""
    pr = z_r @ r_i                        # predicted R_j
    pt = _mv(z_r, t_i) + z_t              # predicted t_j
    er = r_j @ pr.transpose(-1, -2)
    et = t_j - _mv(er, pt)
    return se3_log(er, et)


def _edge_residual_perturbed(xi_i, xi_j, r_i, t_i, r_j, t_j, z_r, z_t):
    dri, dti = se3_exp(xi_i)
    drj, dtj = se3_exp(xi_j)
    return _edge_residual(dri @ r_i, _mv(dri, t_i) + dti,
                          drj @ r_j, _mv(drj, t_j) + dtj, z_r, z_t)


def _per_edge(f):
    """One edge's f and its value, for jacfwd(has_aux=True).  The edge's
    arguments get a leading axis of one: on 0-d tensors forward mode
    returns float64 tangents for a division by a Python float (torch
    2.13), which the Taylor branches of the lie functions take."""
    def g(*args):
        r = f(*(a[None] for a in args))[0]
        return r, r
    return g


_se3_terms = vmap(jacfwd(_per_edge(_edge_residual_perturbed),
                         argnums=(0, 1), has_aux=True))


def _edge_terms(rs, ts, graph: PoseGraph):
    """Residuals (E, 6) and Jacobians (E, 6, 6) x2 at the zero increment."""
    ii = graph.edges[:, 0].long()
    jj = graph.edges[:, 1].long()
    zero = rs.new_zeros((ii.shape[0], 6))
    (j_i, j_j), r = _se3_terms(zero, zero, rs[ii], ts[ii], rs[jj], ts[jj],
                               graph.z_rs, graph.z_ts)
    return r, j_i, j_j


class PoseGraphResult(NamedTuple):
    rs: torch.Tensor
    ts: torch.Tensor
    cost: torch.Tensor           # () final cost, on the device
    initial_cost: torch.Tensor


def _fixed(n: int, fixed_nodes, like: torch.Tensor) -> torch.Tensor:
    """(n,) float: 1 for free nodes, 0 for frozen ones (node 0 by default,
    the gauge; made on the device, where writing a Python 0 into a card
    tensor synchronises)."""
    if fixed_nodes is None:
        return (torch.arange(n, device=like.device) > 0).to(like.dtype)
    return torch.as_tensor(fixed_nodes, device=like.device).to(like.dtype)


def _normal_equations(r, j_i, j_j, ii, jj, w, n: int, dim: int):
    """The weighted normal equations (H (N dim, N dim), b (N dim,)) of the
    given edges, assembled densely from the stacked Jacobian."""
    sw = torch.sqrt(w)[:, None]
    r = r * sw
    j_i = j_i * sw[..., None]
    j_j = j_j * sw[..., None]
    eye_n = torch.eye(n, dtype=r.dtype, device=r.device)
    # the stacked Jacobian (E dim, N dim): each edge's blocks at its nodes
    jac = (eye_n[ii][:, None, :, None] * j_i[:, :, None, :]
           + eye_n[jj][:, None, :, None] * j_j[:, :, None, :])
    jac = jac.reshape(-1, n * dim)
    return jac.T @ jac, -(jac.T @ r.reshape(-1))


def _damped_step(h, b, fn, lam, dim: int):
    """The increment (N, dim) of the normal equations (h, b): the diagonal
    damped by lam * max(diag, 1e-6), frozen nodes pinned."""
    n = fn.shape[0]
    f = fn.repeat_interleave(dim)
    diag = torch.diagonal(h)
    h = h + torch.diag(lam * torch.clamp(diag, min=1e-6))
    h = h * (f[:, None] * f[None, :]) + torch.diag(1.0 - f)
    b = b * f
    delta = torch.linalg.solve_ex(h, b[:, None])[0][:, 0]
    return delta.reshape(n, dim) * fn[:, None]


def _lm_step(r, j_i, j_j, ii, jj, w, fn, lam, dim: int):
    """The damped Gauss-Newton increment (N, dim) of one LM step over all
    edges."""
    h, b = _normal_equations(r, j_i, j_j, ii, jj, w, fn.shape[0], dim)
    return _damped_step(h, b, fn, lam, dim)


def _lm_iterations(cost_of, step, state, init_lambda: float,
                   num_iterations: int, tally: bool = False):
    """LM over a tuple of state tensors: ``step(state, lam)`` proposes,
    the proposal is kept where its cost is lower, λ halves (down to 1e-10)
    or quadruples (up to 1e8); all on the device.  Returns (state, cost,
    initial cost, accepted), ``accepted`` the number of accepted steps
    (0-dim) where ``tally``, else None.  Each accept flag also goes to
    the counter ``pose_graph.lm_accepted`` (held on the device), which
    records nothing inside a capture."""
    cost0 = cost_of(state)
    cost = cost0
    lam = torch.full_like(cost0, init_lambda)
    accepts = []
    for _ in range(num_iterations):
        prop = step(state, lam)
        new_cost = cost_of(prop)
        accept = new_cost < cost
        count("pose_graph.lm_accepted", accept)
        if tally:
            accepts.append(accept)
        state = tuple(torch.where(accept, p, s)
                      for p, s in zip(prop, state))
        cost = torch.where(accept, new_cost, cost)
        lam = torch.where(accept, torch.clamp(lam * 0.5, min=1e-10),
                          torch.clamp(lam * 4.0, max=1e8))
    accepted = None
    if tally:
        accepted = (torch.stack(accepts).sum() if accepts else
                    torch.zeros((), dtype=torch.int64, device=cost0.device))
    return state, cost, cost0, accepted


def _lm(cost_of, step, state, init_lambda: float, num_iterations: int):
    """``_lm_iterations`` run eagerly, for a step that a capture cannot
    hold (the distributed one's collectives): (state, cost, initial
    cost).  Recording (``utils.profiling``), the span ``pose_graph.solve``
    covers it and ``pose_graph.lm_iterations`` counts the iterations."""
    with span("pose_graph.solve", iterations=num_iterations):
        state, cost, cost0, _ = _lm_iterations(cost_of, step, state,
                                               init_lambda, num_iterations)
        count("pose_graph.lm_iterations", num_iterations)
    return state, cost, cost0


# -- the LM loops as cached CUDA graphs --------------------------------------
#
# ``utils.graphs.LoopCache``: on CUDA a solve whose key (the input layouts,
# the device, the iteration count and λ) was seen before replays a capture
# of its loop, which takes tensors alone: the state, the graph and the
# free-node mask.


def _solve(cache: graphs.LoopCache, args, num_iterations: int,
           init_lambda: float):
    """(state, cost, initial cost) of the cache's loop on ``args``.
    Recording, the span ``pose_graph.solve`` covers it (copy-in, replay
    or eager loop, copies out) and ``pose_graph.lm_iterations`` counts the
    iterations."""
    opts = dict(num_iterations=int(num_iterations),
                init_lambda=float(init_lambda))
    with span("pose_graph.solve", iterations=num_iterations):
        out = cache.solve(args, opts)
        count("pose_graph.lm_iterations", num_iterations)
    return out


def _se3_loop(rs, ts, graph: PoseGraph, fn, *, num_iterations: int,
              init_lambda: float, tally: bool = False):
    """``optimize_pose_graph``'s LM loop: ((rs, ts), cost, initial cost,
    accepted steps or None)."""
    ii = graph.edges[:, 0].long()
    jj = graph.edges[:, 1].long()
    w = graph.weights

    def cost_of(state):
        rs, ts = state
        r = _edge_residual(rs[ii], ts[ii], rs[jj], ts[jj], graph.z_rs,
                           graph.z_ts)
        return 0.5 * (w[:, None] * r * r).sum()

    def step(state, lam):
        rs, ts = state
        r, j_i, j_j = _edge_terms(rs, ts, graph)
        delta = _lm_step(r, j_i, j_j, ii, jj, w, fn, lam, 6)
        dr, dt = se3_exp(delta)
        return dr @ rs, _mv(dr, ts) + dt

    return _lm_iterations(cost_of, step, (rs, ts), init_lambda,
                          num_iterations, tally)


_SE3_GRAPHS = graphs.LoopCache(_se3_loop, "pose_graph")


def optimize_pose_graph(rs: torch.Tensor, ts: torch.Tensor,
                        graph: PoseGraph, num_iterations: int = 20,
                        init_lambda: float = 1e-4,
                        fixed_nodes: torch.Tensor | None = None
                        ) -> PoseGraphResult:
    """LM pose-graph optimization on the tensors' device; node 0 frozen by
    default (gauge).  On CUDA a call whose tensors repeat an earlier
    call's layouts, with the same options, replays a cached CUDA graph of
    the loop (the same kernels and bits), captured on the key's second
    call; recording counts ``pose_graph.graph_replays``,
    ``pose_graph.graph_captures`` and ``pose_graph.eager_solves``."""
    fn = _fixed(rs.shape[0], fixed_nodes, ts)
    (rs, ts), cost, cost0 = _solve(_SE3_GRAPHS, (rs, ts, graph, fn),
                                   num_iterations, init_lambda)
    return PoseGraphResult(rs=rs, ts=ts, cost=cost, initial_cost=cost0)


# --------------------------------------------------------------- Sim(3)

class PoseGraphSim3(NamedTuple):
    """Similarity pose graph: nodes are world->cam Sim(3) transforms
    x_cam = s R x_w + t; an edge carries (z_r, z_t, z_s) with the
    convention S_j ~= Z o S_i, i.e. pred R_j = z_r R_i, pred s_j =
    z_s s_i, pred t_j = z_s z_r t_i + z_t.  SE(3) graphs cannot absorb
    monocular scale drift; the Sim(3) graph spreads the log-scale error
    over the trajectory."""
    edges: torch.Tensor     # (E, 2) int32
    z_rs: torch.Tensor      # (E, 3, 3)
    z_ts: torch.Tensor      # (E, 3)
    z_ss: torch.Tensor      # (E,) measured relative scales
    weights: torch.Tensor   # (E,)


def _sim3_edge_residual(r_i, t_i, g_i, r_j, t_j, g_j, z_r, z_t, z_s):
    """(7,) residual: log of the relative-similarity error
    E = Z o S_i o S_j^{-1} (identity when the edge is satisfied); g = log s.
    A zero-baseline revisit edge (z_t = 0, z_s = 1) is satisfied exactly
    when the two camera centres coincide, for any scales."""
    s_ratio = torch.exp(g_i - g_j)                 # s_i / s_j
    rij = r_i @ r_j.transpose(-1, -2)
    er = z_r @ rij
    et = z_s[..., None] * _mv(z_r, t_i - s_ratio[..., None] * _mv(rij, t_j)) \
        + z_t
    es = torch.log(z_s) + g_i - g_j
    return torch.cat([se3_log(er, et), es[..., None]], dim=-1)


def _sim3_edge_residual_perturbed(xi_i, xi_j, r_i, t_i, g_i,
                                  r_j, t_j, g_j, z_r, z_t, z_s):
    dri, dti = se3_exp(xi_i[..., :6])
    drj, dtj = se3_exp(xi_j[..., :6])
    return _sim3_edge_residual(dri @ r_i, _mv(dri, t_i) + dti,
                               g_i + xi_i[..., 6],
                               drj @ r_j, _mv(drj, t_j) + dtj,
                               g_j + xi_j[..., 6], z_r, z_t, z_s)


_sim3_terms = vmap(jacfwd(_per_edge(_sim3_edge_residual_perturbed),
                          argnums=(0, 1), has_aux=True))


def _sim3_edge_terms(rs, ts, gs, graph: PoseGraphSim3):
    ii = graph.edges[:, 0].long()
    jj = graph.edges[:, 1].long()
    zero = rs.new_zeros((ii.shape[0], 7))
    (j_i, j_j), r = _sim3_terms(zero, zero, rs[ii], ts[ii], gs[ii], rs[jj],
                                ts[jj], gs[jj], graph.z_rs, graph.z_ts,
                                graph.z_ss)
    return r, j_i, j_j


class PoseGraphSim3Result(NamedTuple):
    rs: torch.Tensor
    ts: torch.Tensor        # SE(3)-folded: t / s, so C = -R^T t directly
    scales: torch.Tensor    # (N,) optimized per-node scales
    cost: torch.Tensor
    initial_cost: torch.Tensor


def _sim3_loop(rs, ts, gs, graph: PoseGraphSim3, fn, *,
               num_iterations: int, init_lambda: float,
               tally: bool = False):
    """``optimize_pose_graph_sim3``'s LM loop over (rs, ts, gs = log
    scale): ((rs, ts, gs), cost, initial cost, accepted steps or None)."""
    ii = graph.edges[:, 0].long()
    jj = graph.edges[:, 1].long()
    w = graph.weights

    def cost_of(state):
        rs, ts, gs = state
        r = _sim3_edge_residual(rs[ii], ts[ii], gs[ii], rs[jj], ts[jj],
                                gs[jj], graph.z_rs, graph.z_ts, graph.z_ss)
        return 0.5 * (w[:, None] * r * r).sum()

    def step(state, lam):
        rs, ts, gs = state
        r, j_i, j_j = _sim3_edge_terms(rs, ts, gs, graph)
        delta = _lm_step(r, j_i, j_j, ii, jj, w, fn, lam, 7)
        dr, dt = se3_exp(delta[:, :6])
        return dr @ rs, _mv(dr, ts) + dt, gs + delta[:, 6]

    return _lm_iterations(cost_of, step, (rs, ts, gs), init_lambda,
                          num_iterations, tally)


_SIM3_GRAPHS = graphs.LoopCache(_sim3_loop, "pose_graph")


def optimize_pose_graph_sim3(rs: torch.Tensor, ts: torch.Tensor,
                             graph: PoseGraphSim3,
                             num_iterations: int = 20,
                             init_lambda: float = 1e-4,
                             fixed_nodes: torch.Tensor | None = None
                             ) -> PoseGraphSim3Result:
    """LM Sim(3) pose-graph optimization; node 0 frozen (gauge: its pose
    and its unit scale).  Input poses are SE(3) (initial scales 1); the
    returned (rs, ts) have each node's optimized scale folded into its
    translation (C_i = -R_i^T t_i).  On CUDA a repeated call replays a
    cached CUDA graph of the loop, as ``optimize_pose_graph``'s does."""
    n = rs.shape[0]
    fn = _fixed(n, fixed_nodes, ts)
    (rs, ts, gs), cost, cost0 = _solve(
        _SIM3_GRAPHS, (rs, ts, ts.new_zeros(n), graph, fn), num_iterations,
        init_lambda)
    scales = torch.exp(gs)
    # fold the scale into the translation: C_i = -R^T t / s  ->  t' = t / s
    return PoseGraphSim3Result(rs=rs, ts=ts / scales[:, None], scales=scales,
                               cost=cost, initial_cost=cost0)
