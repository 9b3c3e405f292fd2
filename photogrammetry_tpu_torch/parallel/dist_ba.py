"""Distributed Schur-complement bundle adjustment over the ranks of a mesh
axis (port of photogrammetry_tpu/parallel/dist_ba.py).

Landmarks (tracks) are partitioned over the ranks: rank r owns landmarks
[r T/n, (r+1) T/n).  Each rank builds the normal-equation terms of its
shard — H_pp is block-diagonal, so its inverse never leaves the shard —
with the Schur products ``W Hpp^-1 W^T`` and ``W Hpp^-1 b_p`` from the
Schur kernel on the shard (``kernels/schur.py``), and ONE packed
``all_reduce`` of (h_cc, b_c, s_off, W Hpp^-1 b_p) assembles the reduced
camera system.  Every rank then solves the small replicated camera system
and back-substitutes its own landmarks.  The cost and the valid count of a
candidate are closed by a second packed ``all_reduce``.  The LM loop runs
a fixed number of iterations with the accept logic of ``bundle_adjust``
as ``torch.where`` on the device: nothing is read back inside it, as JAX
runs it in one ``lax.scan``.  After the loop one ``all_reduce`` of a
zero-filled (T, 3) buffer that holds each rank's own slice rebuilds the
global landmarks (gloo has no ``all_gather`` on CUDA tensors), so every
rank returns the same global result.

The JAX package also runs its unmodified ``bundle_adjust`` on sharded
arrays (GSPMD inserts the collectives).  The port does not: its kernels
take plain tensors, and DTensor refuses mixed operands; ``shard_problem``
places the inputs as DTensors, and ``distributed_bundle_adjust`` takes
those as well as global tensors.
"""
from __future__ import annotations

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor import DTensor, Replicate, distribute_tensor

from photogrammetry_tpu_torch.parallel.mesh import track_sharding
from photogrammetry_tpu_torch.sfm.ba import (
    BAProblem, BAResult, BAState, apply_step, back_substitute, camera_step,
    landmark_terms, residuals_and_jacobians,
)


def shard_problem(state: BAState, prob: BAProblem, mesh: DeviceMesh,
                  axis: str = "tracks"):
    """(state, prob) as DTensors on ``mesh``: landmarks sharded over
    ``axis`` (points on dim 0, obs and mask on dim 1), cameras and K
    replicated.  Each rank keeps its slice of its own global tensors: no
    collective (``src_data_rank=None``)."""
    repl = [Replicate()] * mesh.ndim

    def place(x, placements):
        return distribute_tensor(x, mesh, placements, src_data_rank=None)

    state = BAState(rs=place(state.rs, repl), ts=place(state.ts, repl),
                    points=place(state.points,
                                 track_sharding(mesh, 0, 2, axis)))
    prob = BAProblem(obs=place(prob.obs, track_sharding(mesh, 1, 3, axis)),
                     mask=place(prob.mask, track_sharding(mesh, 1, 2, axis)),
                     k=place(prob.k, repl))
    return state, prob


def _local(x, dim: int, rank: int, n: int):
    """This rank's landmark slice along ``dim`` of a global tensor, or the
    local part of a DTensor."""
    if isinstance(x, DTensor):
        return x.to_local()
    t = x.shape[dim]
    return x.narrow(dim, rank * (t // n), t // n)


def _full(x):
    return x.to_local() if isinstance(x, DTensor) else x


def distributed_bundle_adjust(state: BAState, prob: BAProblem,
                              mesh: DeviceMesh, num_iterations: int = 20,
                              huber_delta: float = 3.0,
                              init_lambda: float = 1e-3,
                              fixed_cameras: torch.Tensor | None = None,
                              axis: str = "tracks",
                              plain: bool = False) -> BAResult:
    """LM bundle adjustment with the Schur step sharded over ``axis``.

    ``state`` and ``prob`` are the global problem, the same on every rank,
    or ``shard_problem``'s DTensors.  Semantics match ``bundle_adjust``
    (damping, the 0.9 support guard, λ x0.5 down to 1e-9 or x4 up to
    1e6); the landmark count must be a multiple of the axis size.
    ``plain=True`` forms the Schur products with their plain version.
    Every rank returns the same global ``BAResult``.
    """
    group = mesh.get_group(axis)
    n = dist.get_world_size(group)
    rank = mesh.get_local_rank(axis)
    t = state.points.shape[0]
    if t % n:
        raise ValueError(f"distributed_bundle_adjust: {t} landmarks do not "
                         f"split over {n} ranks (pad the track capacity)")
    rs, ts, k = _full(state.rs), _full(state.ts), _full(prob.k)
    points = _local(state.points, 0, rank, n)
    local_prob = BAProblem(obs=_local(prob.obs, 1, rank, n),
                           mask=_local(prob.mask, 1, rank, n), k=k)
    f = rs.shape[0]
    dev = rs.device
    if fixed_cameras is None:
        fixed_cameras = torch.ones((f,), device=dev)
        fixed_cameras[0] = 0.0
    fixed_cameras = torch.as_tensor(fixed_cameras, device=dev)

    def cost_of(st):
        _, _, _, c, nv = residuals_and_jacobians(st, local_prob, huber_delta)
        # one packed all-reduce of (cost, nvalid) instead of two
        cn = torch.stack([c, nv.to(torch.float32)])
        dist.all_reduce(cn, group=group)
        return cn[0], cn[1]

    def step(st, lam):
        r, j_cam, j_pt, _, _ = residuals_and_jacobians(st, local_prob,
                                                       huber_delta)
        sums, back = landmark_terms(r, j_cam, j_pt, lam, plain)
        # one packed all-reduce closes all four cross-shard sums
        packed = torch.cat([x.reshape(-1) for x in sums])
        dist.all_reduce(packed, group=group)
        h_cc, b_c, s_off, corr = (
            part.reshape(x.shape) for part, x in
            zip(packed.split([x.numel() for x in sums]), sums))
        delta_c = camera_step(h_cc, b_c, s_off, corr, lam, fixed_cameras)
        return apply_step(st, delta_c, back_substitute(*back, delta_c))

    st = BAState(rs=rs, ts=ts, points=points)
    cost0, nvalid = cost_of(st)
    cost = cost0
    lam = torch.tensor(init_lambda, dtype=torch.float32, device=dev)
    for _ in range(num_iterations):
        cand = step(st, lam)
        new_cost, new_nvalid = cost_of(cand)
        # the support guard of bundle_adjust: reject steps that lower the
        # cost by throwing observations behind the cameras
        support_ok = new_nvalid >= 0.9 * nvalid
        accept = (new_cost < cost) & torch.isfinite(new_cost) & support_ok
        st = BAState(*(torch.where(accept, a, b) for a, b in zip(cand, st)))
        cost = torch.where(accept, new_cost, cost)
        nvalid = torch.where(accept, new_nvalid, nvalid)
        lam = torch.where(accept, torch.clamp(lam * 0.5, min=1e-9),
                          torch.clamp(lam * 4.0, max=1e6))

    # the global landmarks: each rank's slice in a zero-filled buffer
    pts = torch.zeros((t, 3), dtype=st.points.dtype, device=dev)
    pts[rank * (t // n):(rank + 1) * (t // n)] = st.points
    dist.all_reduce(pts, group=group)
    return BAResult(state=BAState(rs=st.rs, ts=st.ts, points=pts),
                    cost=cost, initial_cost=cost0,
                    iterations=num_iterations)
