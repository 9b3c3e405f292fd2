"""Distributed pose-graph optimisation: edges sharded over a mesh axis
(port of photogrammetry_tpu/parallel/dist_pose_graph.py).

Each rank owns an edge shard (in a SLAM deployment, the edges of its
submaps) and builds its partial Gauss-Newton system; ``all_reduce`` over
the axis assembles the global one, the solve is replicated and the
updates are identical on every rank.  The per-edge residuals and
Jacobians are ``sfm/pose_graph.py``'s; the LM loop is its ``_lm`` (a
fixed number of iterations, accept/reject by ``torch.where``, nothing
read back).

  'dense' — the (6N, 6N) normal equations of the shard, one all-reduce of
            H and one of b a step, direct solve.
  'cg'    — H is never formed: block-Jacobi preconditioned conjugate
            gradient whose matvec is computed edge by edge from the shard;
            an all-reduce of b and of the (N, 6, 6) block diagonal a step,
            and of H v a CG step (a static trip count, converged states
            held by guarding the step sizes, as in the JAX package).
  'auto'  — 'dense' for N <= 64, else 'cg'.

Every scatter over nodes is a product with one-hot incidence matrices: a
fixed summation order, where ``index_add_`` on CUDA adds in no fixed
order and ranks on two cards could part.
"""
from __future__ import annotations

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from photogrammetry_tpu_torch.core.lie import se3_exp
from photogrammetry_tpu_torch.sfm.pose_graph import (
    PoseGraph, PoseGraphResult, _damped_step, _edge_residual, _edge_terms,
    _fixed, _lm, _mv, _normal_equations,
)


def pad_graph(graph: PoseGraph, multiple: int) -> PoseGraph:
    """Pad the edge set to a multiple of the mesh size with zero-weight
    self-edges (i = j = 0, identity measurement: no contribution)."""
    e = graph.edges.shape[0]
    pad = (-e) % multiple
    if pad == 0:
        return graph
    ref = graph.z_ts
    eye = torch.eye(3, dtype=ref.dtype, device=ref.device)
    return PoseGraph(
        edges=torch.cat([graph.edges, graph.edges.new_zeros((pad, 2))]),
        z_rs=torch.cat([graph.z_rs, eye.expand(pad, 3, 3)]),
        z_ts=torch.cat([graph.z_ts, ref.new_zeros((pad, 3))]),
        weights=torch.cat([graph.weights, graph.weights.new_zeros((pad,))]))


def _shard(graph: PoseGraph, rank: int, n: int) -> PoseGraph:
    e = graph.edges.shape[0]
    if e % n:
        raise ValueError(f"distributed_optimize_pose_graph: {e} edges do "
                         f"not split over {n} ranks (use pad_graph)")
    return PoseGraph(*(x.narrow(0, rank * (e // n), e // n) for x in graph))


def distributed_optimize_pose_graph(rs, ts, graph: PoseGraph,
                                    mesh: DeviceMesh,
                                    num_iterations: int = 20,
                                    init_lambda: float = 1e-4,
                                    fixed_nodes=None, axis: str = "tracks",
                                    solver: str = "auto",
                                    cg_iterations: int = 100
                                    ) -> PoseGraphResult:
    """``optimize_pose_graph`` with the edges sharded over ``axis``: the
    global graph on every rank, its edge count a multiple of the axis size
    (``pad_graph``).  ``solver``: 'dense', 'cg' or 'auto' (the module
    docstring).  Every rank returns the same result."""
    n = rs.shape[0]
    if solver == "auto":
        solver = "dense" if n <= 64 else "cg"
    if solver not in ("dense", "cg"):
        raise ValueError(f"unknown solver {solver!r}")
    group = mesh.get_group(axis)
    g = _shard(graph, mesh.get_local_rank(axis), dist.get_world_size(group))
    fn = _fixed(n, fixed_nodes, ts)
    ii = g.edges[:, 0].long()
    jj = g.edges[:, 1].long()
    w = g.weights

    def psum(x):
        dist.all_reduce(x, group=group)
        return x

    def cost_of(state):
        rs, ts = state
        r = _edge_residual(rs[ii], ts[ii], rs[jj], ts[jj], g.z_rs, g.z_ts)
        return psum(0.5 * (w[:, None] * r * r).sum())

    def dense_delta(rs, ts, lam):
        r, j_i, j_j = _edge_terms(rs, ts, g)
        h, b = _normal_equations(r, j_i, j_j, ii, jj, w, n, 6)
        return _damped_step(psum(h), psum(b), fn, lam, 6)

    def cg_delta(rs, ts, lam):
        return _cg_delta(rs, ts, g, ii, jj, w, fn, lam, psum, cg_iterations)

    delta_of = dense_delta if solver == "dense" else cg_delta

    def step(state, lam):
        rs, ts = state
        dr, dt = se3_exp(delta_of(rs, ts, lam))
        return dr @ rs, _mv(dr, ts) + dt

    (rs, ts), cost, cost0 = _lm(cost_of, step, (rs, ts), init_lambda,
                                num_iterations)
    return PoseGraphResult(rs=rs, ts=ts, cost=cost, initial_cost=cost0)


def _cg_delta(rs, ts, g, ii, jj, w, fn, lam, psum, cg_iterations):
    """The LM increment (N, 6) by matrix-free PCG over the edge shard:
    H v = psum(J^T (J v)) edge by edge plus the damping, the gauge nodes
    pinned; block-Jacobi preconditioner from the psummed diagonal blocks."""
    n = rs.shape[0]
    r, j_i, j_j = _edge_terms(rs, ts, g)
    sw = torch.sqrt(w)[:, None]
    r = r * sw
    j_i = j_i * sw[..., None]
    j_j = j_j * sw[..., None]
    eye_n = torch.eye(n, dtype=r.dtype, device=r.device)
    inc_i, inc_j = eye_n[ii].T, eye_n[jj].T          # (N, E) incidences
    fmask = fn[:, None]                               # 1 free, 0 gauge
    eye6 = torch.eye(6, dtype=r.dtype, device=r.device)

    def scatter(x_i, x_j):
        """Σ over edges of x_i at node i and x_j at node j: (N, ...)."""
        shape = x_i.shape[1:]
        return (inc_i @ x_i.reshape(x_i.shape[0], -1)
                + inc_j @ x_j.reshape(x_j.shape[0], -1)).reshape(n, *shape)

    b = psum(scatter(-torch.einsum("eri,er->ei", j_i, r),
                     -torch.einsum("eri,er->ei", j_j, r))) * fmask
    hdiag = psum(scatter(torch.einsum("eri,erj->eij", j_i, j_i),
                         torch.einsum("eri,erj->eij", j_j, j_j)))
    dd = torch.diagonal(hdiag, dim1=-2, dim2=-1)     # (N, 6)
    damp = lam * torch.clamp(dd, min=1e-6)
    hdiag = hdiag + damp[:, :, None] * eye6
    # gauge-fixed nodes act as identity rows
    hdiag = (hdiag * fn[:, None, None]
             + (1.0 - fn)[:, None, None] * eye6)
    minv = torch.linalg.inv_ex(hdiag)[0]             # block-Jacobi

    def matvec(v):
        v = v * fmask
        u = (torch.einsum("erc,ec->er", j_i, v[ii])
             + torch.einsum("erc,ec->er", j_j, v[jj]))
        hv = psum(scatter(torch.einsum("erc,er->ec", j_i, u),
                          torch.einsum("erc,er->ec", j_j, u)))
        return (hv + damp * v) * fmask

    def precond(v):
        return _mv(minv, v) * fmask

    x = torch.zeros_like(b)
    res = b                                           # b - H @ 0
    z = precond(res)
    p = z
    rz = (res * z).sum()
    for _ in range(cg_iterations):
        hp = matvec(p)
        php = (p * hp).sum()
        ok = (php > 1e-20) & (rz > 1e-20)
        alpha = torch.where(ok, rz / torch.where(ok, php, 1.0), 0.0)
        x = x + alpha * p
        res = res - alpha * hp
        z = precond(res)
        rz2 = (res * z).sum()
        beta = torch.where(ok, rz2 / torch.where(rz > 1e-20, rz, 1.0), 0.0)
        p = z + beta * p
        rz = rz2
    return x * fmask
