"""Loop-closure detection + pose-graph construction (port of
photogrammetry_tpu/sfm/loop_closure.py).

Place recognition is brute-force appearance matching: every frame pair's
mutual-nearest BRIEF match count over the F x F pair grid.  The JAX package
computes it as a ``lax.map`` over rows of a ``vmap`` of the Hamming matrix;
here the Hamming kernel's batched entry takes a chunk of pairs a launch
(``kernels/hamming.hamming_distance_matrix_pairs``, the pair in
``blockIdx.z``), and the mutual-nearest counts of the chunk are one batched
reduction (``ops/match.mutual_nearest_counts``).  All F² pairs are
computed, as in JAX: with tied distances ``counts[i, j]`` and
``counts[j, i]`` come from different argmins.  Accepted loop pairs get a
relative-pose measurement and become extra pose-graph edges beside the
odometry chain (``sfm/pose_graph.py``).

Measurement modes: 'rotation' (a trimmed bearing-Procrustes rotation; the
edge constrains orientation only), 'revisit' (the same rotation with a
zero-baseline translation that pins the two centres together),
'essential' (RANSAC → essential → cheirality, the unit translation
rescaled to the current baseline) and, in ``close_loops``,
'revisit_sim3' (revisit edges with a measured relative scale in a Sim(3)
graph).  Random draws come from a ``torch.Generator`` where JAX takes a
key.  ``plain=True`` runs the kernels' plain versions throughout.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from photogrammetry_tpu_torch import resolve_device
from photogrammetry_tpu_torch.kernels import hamming
from photogrammetry_tpu_torch.ops.match import mutual_nearest_counts
from photogrammetry_tpu_torch.sfm.epipolar import svd_or_nan
from photogrammetry_tpu_torch.sfm.frontend import match_pair
from photogrammetry_tpu_torch.sfm.pose_graph import (
    PoseGraph, PoseGraphSim3, optimize_pose_graph, optimize_pose_graph_sim3,
    relative_pose,
)
from photogrammetry_tpu_torch.sfm.triangulate import triangulate_dlt
from photogrammetry_tpu_torch.sfm.two_view import two_view_pipeline
from photogrammetry_tpu_torch.utils.profiling import count, span
from photogrammetry_tpu_torch.utils.reductions import nanmedian

# The largest (Q, K, K) int32 distance tensor one launch writes: 1 GiB is
# 1,024 pairs at K = 512 (all 529 of F = 23 in one launch; F = 64's 4 GiB
# grid in four).  JAX's lax.map keeps one row of the grid live instead.
PAIR_BUDGET_BYTES = 1 << 30
SHORTLIST = 64          # pairs fully matched past DENSE_MAX_FRAMES frames
DENSE_MAX_FRAMES = 64


def pair_chunk(k: int) -> int:
    """Pairs a launch: as many (K, K) int32 matrices as fit
    PAIR_BUDGET_BYTES (at least one, at most the kernel's MAX_PAIRS)."""
    return max(1, min(hamming.MAX_PAIRS,
                      PAIR_BUDGET_BYTES // (4 * k * k or 1)))


def pair_match_counts(bits: torch.Tensor, masks: torch.Tensor,
                      ii: torch.Tensor, jj: torch.Tensor, threshold: int,
                      plain: bool = False) -> torch.Tensor:
    """(Q,) int32 mutual-nearest match counts of the frame pairs (ii[q] as
    rows, jj[q] as columns) under ``threshold``: one Hamming launch per
    chunk of ``pair_chunk`` pairs, never one per pair."""
    dist_fn = (hamming.hamming_distance_matrix_pairs_plain if plain
               else hamming.hamming_distance_matrix_pairs)
    chunk = pair_chunk(bits.shape[1])
    ii = ii.to(torch.int32).contiguous()
    jj = jj.to(torch.int32).contiguous()
    out = [mutual_nearest_counts(dist_fn(bits, masks, ii[s:s + chunk],
                                         jj[s:s + chunk]), threshold)
           for s in range(0, ii.shape[0], chunk)]
    return torch.cat(out) if out else ii.new_zeros((0,))


def pairwise_match_counts(bits: torch.Tensor, masks: torch.Tensor,
                          threshold: int, plain: bool = False
                          ) -> torch.Tensor:
    """(F, K, P) descriptor bits + (F, K) masks → (F, F) int32 counts of
    mutual-nearest Hamming matches under ``threshold`` for every frame pair
    (frame i's keypoints as the rows of pair (i, j))."""
    f = bits.shape[0]
    idx = torch.arange(f, dtype=torch.int32, device=bits.device)
    counts = pair_match_counts(bits.contiguous(), masks.contiguous(),
                               idx.repeat_interleave(f), idx.repeat(f),
                               threshold, plain)
    return counts.reshape(f, f)


def detect_loop_closures(counts, min_gap: int = 3, min_matches: int = 30,
                         max_candidates: int = 8) -> list[tuple[int, int]]:
    """Host-side candidate selection from the (F, F) match-count matrix.

    A pair (i, j), j - i >= min_gap, is a loop candidate when its match
    count reaches ``min_matches``; the strongest ``max_candidates`` are
    returned (strongest first).  Temporal neighbors are odometry, not loops.
    """
    counts = np.asarray(counts)
    f = counts.shape[0]
    cand = [(int(counts[i, j]), i, j)
            for i in range(f) for j in range(i + min_gap, f)
            if counts[i, j] >= min_matches]
    cand.sort(reverse=True)
    return [(i, j) for _, i, j in cand[:max_candidates]]


def _as_f32(x, dev) -> torch.Tensor:
    if not isinstance(x, torch.Tensor):
        x = np.array(x, dtype=np.float32)
    return torch.as_tensor(x, dtype=torch.float32, device=dev)


def build_pose_graph(rs, ts, loop_edges, loop_measurements,
                     odometry_weight: float = 1.0, loop_weight: float = 1.0,
                     device=None) -> PoseGraph:
    """Odometry chain from the estimated trajectory + measured loop edges.

    Args:
      rs, ts: (F, 3, 3), (F, 3) current world→camera pose estimates
        (tensors, whose device the graph takes, or arrays: then ``device``,
        default CUDA).
      loop_edges: list of (i, j) frame index pairs.
      loop_measurements: list of (z_r (3,3), z_t (3,)) measured relative
        poses, convention T_j = Z ∘ T_i (pose_graph.relative_pose).
    """
    if device is None:
        device = rs.device if isinstance(rs, torch.Tensor) else "cuda"
    dev = resolve_device(device)
    rs = _as_f32(rs, dev)
    ts = _as_f32(ts, dev)
    f = rs.shape[0]
    zr, zt = relative_pose(rs[:-1], ts[:-1], rs[1:], ts[1:])
    z_rs = [zr] + [_as_f32(m[0], dev)[None] for m in loop_measurements]
    z_ts = [zt] + [_as_f32(m[1], dev)[None] for m in loop_measurements]
    edges = [(t - 1, t) for t in range(1, f)] + [tuple(e) for e in
                                                 loop_edges]
    w = [odometry_weight] * (f - 1) + [loop_weight] * len(loop_edges)
    return PoseGraph(
        edges=torch.tensor(edges, dtype=torch.int32,
                           device=dev).reshape(-1, 2),
        z_rs=torch.cat(z_rs), z_ts=torch.cat(z_ts),
        weights=torch.tensor(w, dtype=torch.float32, device=dev))


def rotation_from_bearings(xy1: torch.Tensor, xy2: torch.Tensor,
                           mask: torch.Tensor, k: torch.Tensor):
    """Trimmed Kabsch: rotation R with bearing(xy2) ≈ R @ bearing(xy1).

    For a revisit (near-zero baseline) the epipolar problem degenerates but
    the motion field is pure rotation of the bearing vectors, so a weighted
    orthogonal-Procrustes fit (3x3 SVD) recovers R far more accurately than
    an essential decomposition.  Three rounds drop residual outliers beyond
    3x the mean inlier residual.  Returns (R, kept_count) on the device.
    """
    kinv = torch.linalg.inv_ex(k.to(torch.float32))[0]

    def bear(xy):
        xy = xy.to(torch.float32)
        h = torch.cat([xy, torch.ones_like(xy[:, :1])], 1) @ kinv.T
        return h / torch.linalg.vector_norm(h, dim=1, keepdim=True)

    b1 = bear(xy1)
    b2 = bear(xy2)
    w = mask.to(torch.float32)
    r = torch.eye(3, device=b1.device)
    for _ in range(3):
        m = (b2 * w[:, None]).T @ b1
        u, _, vt = svd_or_nan(m)
        d = torch.sign(torch.linalg.det(u @ vt))
        r = u @ torch.diag(torch.stack([torch.ones_like(d),
                                        torch.ones_like(d), d])) @ vt
        resid = torch.linalg.vector_norm(b2 - b1 @ r.T, dim=1)
        mean = (resid * w).sum() / torch.clamp(w.sum(), min=1.0)
        w = w * (resid < 3.0 * mean + 1e-9)
    return r, w.sum().to(torch.int32)


def measure_loop_edges(features, rs, ts, k, loop_pairs, config,
                       generator: torch.Generator | None = None,
                       num_samples: int = 512, mode: str = "rotation",
                       plain: bool = False):
    """Relative-pose measurements for accepted loop pairs.

    features: list of DescribedFrame (sfm.frontend), on one device.
    Returns (measurements, support counts), measurement convention
    T_j = Z ∘ T_i.

    mode='rotation': the rotation from the bearing-Procrustes fit and
    z_t = t_j - z_r @ t_i from the *current* estimate, so the edge's
    translation residual is exactly zero there and the edge constrains
    orientation only.  mode='revisit': the same rotation and z_t = 0, a
    zero-baseline edge that pins the two centres together.
    mode='essential': the RANSAC → essential → cheirality two-view pipeline
    (draws from ``generator``); the unit translation rescaled to the
    current estimated baseline |C_j - C_i|.
    """
    if mode not in ("rotation", "revisit", "essential"):
        raise ValueError(f"unknown loop-edge mode {mode!r}")
    dev = features[0].bits.device
    rs = _as_f32(rs, dev)
    ts = _as_f32(ts, dev)
    k = _as_f32(k, dev)
    centers = -torch.einsum("fji,fj->fi", rs, ts)
    out, support = [], []
    for i, j in loop_pairs:
        # rows = frame j keypoints, cols = frame i; both paths return
        # (r, t) mapping cam-j coords → cam-i coords, so Z_ij = (r, t)^-1
        m = match_pair(features[j], features[i], config, plain=plain)
        if mode == "essential":
            tv = two_view_pipeline(generator, m.xy1, m.xy2, m.mask, k,
                                   num_samples=num_samples, threshold=1.5)
            zr = tv.r.T
            baseline = torch.linalg.vector_norm(centers[j] - centers[i])
            out.append((zr, -tv.r.T @ (tv.t * baseline)))
            support.append(int(tv.num_inliers))
            continue
        r_ji, kept = rotation_from_bearings(m.xy1, m.xy2, m.mask, k)
        zr = r_ji.T
        # z_t from the *measured* z_r, so that the translation residual
        # vanishes at the current estimate ('rotation'); a true revisit
        # returns to the same centre: t_j = z_r t_i, z_t = 0 ('revisit')
        zt = (ts[j] - zr @ ts[i] if mode == "rotation"
              else torch.zeros(3, device=dev))
        out.append((zr, zt))
        support.append(int(kept))
    return out, support


def _median_local_depth(features, rs, ts, k, frame: int, neighbor: int,
                        config, plain: bool = False) -> float:
    """Median two-view triangulated depth at ``frame`` (against a temporal
    neighbor) under the current poses: the local metric scale probe that
    measures a loop edge's relative scale (JAX ``nanmedian`` semantics;
    NaN when no depth is in the gate)."""
    m = match_pair(features[frame], features[neighbor], config, plain=plain)
    r_rel = rs[neighbor] @ rs[frame].T
    t_rel = ts[neighbor] - r_rel @ ts[frame]
    pts, _ = triangulate_dlt(m.xy1, m.xy2, r_rel, t_rel, k, k)
    z = pts[:, 2]
    ok = m.mask & (z > 1e-3) & (z < 1e3)
    return float(nanmedian(torch.where(ok, z, torch.nan)))


def _shortlist_counts(bits, masks, f_total, min_gap, threshold, plain):
    """Place recognition past DENSE_MAX_FRAMES frames: a bag-of-bits global
    descriptor (the masked mean of each frame's bits, one (F, P) matrix)
    ranks all pairs by one F x F distance, and only the best SHORTLIST
    pairs that respect ``min_gap`` are fully matched, in one batched
    launch.  Returns the (F, F) numpy counts (0 off the shortlist)."""
    w = masks.to(torch.float32)
    denom = torch.clamp(w.sum(dim=1, keepdim=True), min=1.0)
    global_d = torch.einsum("fkp,fk->fp", bits.to(torch.float32), w) / denom
    d2 = ((global_d[:, None] - global_d[None]) ** 2).sum(-1)
    gap_ok = np.triu(np.ones((f_total, f_total), bool), k=min_gap)
    d2_np = np.where(gap_ok, d2.cpu().numpy(), np.inf)
    shortlist = min(SHORTLIST, gap_ok.sum())
    flat = np.argsort(d2_np.ravel())[:shortlist]
    cand = [(int(i // f_total), int(i % f_total)) for i in flat
            if np.isfinite(d2_np.ravel()[i])]
    counts = np.zeros((f_total, f_total), np.int32)
    count("loop.pairs_matched", len(cand))
    if cand:
        ii, jj = (torch.tensor(x, dtype=torch.int32, device=bits.device)
                  for x in zip(*cand))
        got = pair_match_counts(bits, masks, ii, jj, threshold, plain)
        counts[tuple(np.asarray(cand).T)] = got.cpu().numpy()
    return counts


def close_loops(features, rs, ts, k, config,
                generator: torch.Generator | None = None, min_gap: int = 3,
                min_matches: int = 30, num_iterations: int = 20,
                mode: str = "rotation", loop_weight: float = 4.0,
                min_support: int | None = None, max_candidates: int = 8,
                plain: bool = False):
    """End-to-end loop closure: detect → measure → build graph → optimize,
    on the features' device.

    Returns (rs, ts, info dict).  No accepted edge ⇒ the poses come back
    as they were passed.  Every measured edge is gated on its geometric
    support (the Procrustes trim survivors, or the RANSAC inliers in
    'essential' mode) and dropped below ``min_support`` (default
    ``min_matches``): appearance alone admits perceptual aliasing.
    Rejected pairs are in info['rejected_edges'].  ``generator`` (default:
    seeded 0, as JAX's default key is PRNGKey(0)) draws the 'essential'
    samples.  Up to DENSE_MAX_FRAMES frames every pair is matched; past
    that a global-descriptor shortlist picks the pairs.  Where a graph was
    solved, info also holds the accepted edges' support (``inliers``), their
    ``measurements`` ((z_r, z_t) on the device, T_j = Z ∘ T_i) and the
    graph's ``cost`` and ``initial_cost``.

    Spans (``utils.profiling``): ``loop.detect`` (the pair counts, their
    read to the host, the candidate selection) and ``loop.measure``;
    counters ``loop.pairs_matched`` (pairs fully matched),
    ``loop.candidates`` and ``loop.edges_accepted``.
    """
    dev = features[0].bits.device
    if generator is None:
        generator = torch.Generator(device=dev).manual_seed(0)
    if min_support is None:
        min_support = min_matches
    bits = torch.stack([f.bits for f in features])
    masks = torch.stack([f.points.mask for f in features])
    f_total = bits.shape[0]
    with span("loop.detect"):
        if f_total <= DENSE_MAX_FRAMES:
            counts = pairwise_match_counts(
                bits, masks, config.hamming_threshold, plain).cpu().numpy()
            count("loop.pairs_matched", f_total * f_total)
        else:
            counts = _shortlist_counts(bits, masks, f_total, min_gap,
                                       config.hamming_threshold, plain)
        pairs = detect_loop_closures(counts, min_gap=min_gap,
                                     min_matches=min_matches,
                                     max_candidates=max_candidates)
    count("loop.candidates", len(pairs))
    if not pairs:
        return rs, ts, {"loop_edges": [], "rejected_edges": [],
                        "counts": counts}
    with span("loop.measure"):
        meas, inl = measure_loop_edges(
            features, rs, ts, k, pairs, config, generator,
            mode="revisit" if mode == "revisit_sim3" else mode, plain=plain)
    kept = [(p, z, s) for p, z, s in zip(pairs, meas, inl)
            if s >= min_support]
    rejected = [(p, s) for p, s in zip(pairs, inl) if s < min_support]
    count("loop.edges_accepted", len(kept))
    if not kept:
        return rs, ts, {"loop_edges": [], "rejected_edges": rejected,
                        "counts": counts}
    pairs, meas, inl = ([t[i] for t in kept] for i in range(3))
    rs_d = _as_f32(rs, dev)
    ts_d = _as_f32(ts, dev)
    if mode != "revisit_sim3":
        graph = build_pose_graph(rs_d, ts_d, pairs, meas,
                                 loop_weight=loop_weight)
        res = optimize_pose_graph(rs_d, ts_d, graph,
                                  num_iterations=num_iterations)
        return res.rs, res.ts, {"loop_edges": pairs, "inliers": inl,
                                "measurements": meas,
                                "rejected_edges": rejected,
                                "counts": counts, "cost": float(res.cost),
                                "initial_cost": float(res.initial_cost)}
    # Sim(3) loop closing: each revisit edge carries a measured relative
    # scale, the ratio of the median triangulated depths at its two frames
    # (the same scene at a revisit, so the ratio is the accumulated
    # relative scale), and the Sim(3) graph spreads the log-scale
    # correction over the trajectory
    n = rs_d.shape[0]
    k_d = _as_f32(k, dev)
    se3 = build_pose_graph(rs_d, ts_d, [], [])
    scales_meas = []
    for i, j in pairs:
        di = _median_local_depth(features, rs_d, ts_d, k_d, i,
                                 min(i + 1, n - 1) if i + 1 != j
                                 else max(i - 1, 0), config, plain)
        dj = _median_local_depth(features, rs_d, ts_d, k_d, j,
                                 max(j - 1, 0) if j - 1 != i
                                 else min(j + 1, n - 1), config, plain)
        # a probe without a valid in-gate depth is NaN, which would poison
        # every LM step: a unit scale measurement for that edge instead
        if not (math.isfinite(di) and math.isfinite(dj)):
            scales_meas.append(1.0)
        else:
            scales_meas.append(float(np.clip(dj / max(di, 1e-9), 0.05,
                                             20.0)))
    graph7 = PoseGraphSim3(
        edges=torch.cat([se3.edges, torch.tensor(pairs, dtype=torch.int32,
                                                 device=dev)]),
        z_rs=torch.cat([se3.z_rs, torch.stack([zr for zr, _ in meas])]),
        z_ts=torch.cat([se3.z_ts, torch.zeros((len(pairs), 3),
                                              device=dev)]),
        z_ss=torch.tensor([1.0] * (n - 1) + scales_meas, device=dev),
        weights=torch.tensor([1.0] * (n - 1)
                             + [loop_weight * 10.0] * len(pairs),
                             device=dev))
    res = optimize_pose_graph_sim3(rs_d, ts_d, graph7,
                                   num_iterations=num_iterations)
    return res.rs, res.ts, {"loop_edges": pairs, "inliers": inl,
                            "measurements": meas,
                            "rejected_edges": rejected, "counts": counts,
                            "loop_scales": scales_meas,
                            "cost": float(res.cost),
                            "initial_cost": float(res.initial_cost)}
