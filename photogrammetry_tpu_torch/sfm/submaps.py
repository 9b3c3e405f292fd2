"""Submap-chained SfM: map size beyond one track table (port of
photogrammetry_tpu/sfm/submaps.py).

A TrackTable is a fixed-capacity (F, T) grid, so a long sequence runs out
of tracks.  Here the sequence is split into overlapping windows, each
reconstructed with its own full-capacity table, and the windows are
stitched into one frame:

  1. consecutive submaps share ``overlap`` frames; a similarity (scale + R
     + t, from the overlap's full poses) maps submap i+1 onto the stitched
     frame;
  2. a pose graph over all frames (odometry edges, doubled weight where two
     submaps measure the same edge) smooths the seams;
  3. optionally, a global BA over tracks merged across the seams (exact
     shared observations, union-find), anchored to the pose-graph
     trajectory by a pose prior.

The seam algebra and the track merge are numpy (a copy of the JAX
package's, which the port does not import); the windows, the pose graph
and the global BA run on ``device`` (default CUDA) with the kernels, or
their plain versions with ``plain=True``.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List

import numpy as np
import torch

from photogrammetry_tpu_torch import resolve_device
from photogrammetry_tpu_torch.sfm.ba import BAProblem, BAState, bundle_adjust
from photogrammetry_tpu_torch.sfm.incremental import (
    SfmConfig, SfmResult, _prune_observations, _retriangulate_all,
    run_incremental_sfm_robust,
)
from photogrammetry_tpu_torch.sfm.pose_graph import (
    PoseGraph, optimize_pose_graph, relative_pose,
)
from photogrammetry_tpu_torch.sfm.tracks import TrackTable


@dataclass
class SubmapResult:
    rs: np.ndarray            # (F, 3, 3) stitched world->cam
    ts: np.ndarray            # (F, 3)
    points: np.ndarray        # (sum_i Ti, 3) merged landmark cloud
    submaps: List[SfmResult]  # per-window results (own gauges)
    spans: List[tuple]        # (start, end) frame range per submap
    total_tracks: int         # tracks allocated across all tables
    dropped: int              # capacity drops across all tables

    @property
    def camera_centers(self) -> np.ndarray:
        return -np.einsum("fji,fj->fi", self.rs, self.ts)


def _numpy(x) -> np.ndarray:
    """A table leaf as numpy, its dtype kept (float32 observations stay
    float32: the track merge links them by their exact bytes)."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def _align_sim3_poses(rs_m, ts_m, rs_s, ts_s):
    """Sim3 (s, R_g, t_g) mapping submap gauge onto the stitched gauge from
    FULL overlapping poses: c_s ~= s R_g c_m + t_g and R_s ~= R_m R_g^T.

    Center-only Umeyama is rank-deficient here (a pan's centers are nearly
    collinear, leaving the roll about the pan axis free); the rotations of
    the shared frames pin it: R_g is the chordal mean of R_sf^T R_mf over
    the overlap.
    """
    cm = -np.einsum("fji,fj->fi", rs_m, ts_m)
    cs = -np.einsum("fji,fj->fi", rs_s, ts_s)
    # chordal mean of per-frame relative rotations (projection onto SO(3))
    m = np.einsum("fji,fjk->ik", rs_s, rs_m)  # sum_f R_sf^T R_mf
    u, _, vt = np.linalg.svd(m)
    d = np.diag([1.0, 1.0, np.sign(np.linalg.det(u @ vt))])
    r_g = u @ d @ vt
    mu_m, mu_s = cm.mean(axis=0), cs.mean(axis=0)
    den = np.sum((cm - mu_m) ** 2)
    s = float(np.sqrt(np.sum((cs - mu_s) ** 2) / max(den, 1e-12))) \
        if den > 1e-12 else 1.0
    t_g = mu_s - s * (r_g @ mu_m)
    return s, r_g, t_g


def _apply_sim3(s, r_g, t_g, rs, ts, points=None):
    """Map poses (and optionally points) through X' = s R_g X + t_g:
    camera centers move with the similarity, rotations compose with
    R_g^T."""
    centers = -np.einsum("fji,fj->fi", rs, ts)
    centers2 = centers @ (s * r_g).T + t_g
    rs2 = np.einsum("fij,kj->fik", rs, r_g)   # R_i R_g^T
    ts2 = -np.einsum("fij,fj->fi", rs2, centers2)
    pts2 = None if points is None else points @ (s * r_g).T + t_g
    return rs2, ts2, pts2


def _merge_submap_tracks(results, spans, num_frames: int, capacity: int,
                         loop_links=None):
    """Fuse track identities across submaps into one global (F, T) table.

    Two adjacent submaps observe the SAME detected keypoints in their
    overlap (the frontend is deterministic per frame), so tracks sharing
    exact (frame, xy) observations are one landmark: linked by the xy
    bytes and merged with union-find, a pair only when it shares >= 2
    observations.  ``loop_links`` ((fa, xy_a, fb, xy_b) gated loop
    matches) link tracks across loop edges by eighth-pixel-rounded xy.  A
    merged group holding two keypoints in one frame falls back to its
    largest member.  Returns (obs (F, T, 2) f32, obs_mask (F, T) bool)
    keeping the ``capacity`` best-observed merged tracks.
    """
    parent = {}

    def find(x):
        while parent[x] != x:
            parent[x] = parent[parent[x]]
            x = parent[x]
        return x

    def union(a, b):
        ra, rb = find(a), find(b)
        if ra != rb:
            parent[ra] = rb

    seen = {}          # (global frame, x-bytes, y-bytes) -> node
    rounded = {}       # (global frame, round 8x, round 8y) -> node
    track_obs = {}     # node -> {global_frame: (x, y)}
    links = {}         # (node_a, node_b) -> shared-observation count
    for i, (a, b) in enumerate(spans):
        t_ = results[i].table
        obs = _numpy(t_.obs)
        mask = _numpy(t_.obs_mask)
        n_obs = mask.sum(axis=0)
        for tid in np.nonzero(n_obs >= 2)[0]:
            node = (i, int(tid))
            parent[node] = node
            fr = np.nonzero(mask[:, tid])[0]
            track_obs[node] = {int(a + f): tuple(obs[f, tid]) for f in fr}
            for f in fr:
                key = (int(a + f), obs[f, tid, 0].tobytes(),
                       obs[f, tid, 1].tobytes())
                if key in seen:
                    pair = tuple(sorted((node, seen[key])))
                    links[pair] = links.get(pair, 0) + 1
                else:
                    seen[key] = node
                # loop matches come from a separate frontend pass: looked
                # up at an eighth of a pixel, not by exact float identity
                rkey = (int(a + f), int(round(obs[f, tid, 0] * 8)),
                        int(round(obs[f, tid, 1] * 8)))
                rounded[rkey] = node

    for (fa, xya, fb, xyb) in (loop_links or []):
        ka = (int(fa), int(round(float(xya[0]) * 8)),
              int(round(float(xya[1]) * 8)))
        kb = (int(fb), int(round(float(xyb[0]) * 8)),
              int(round(float(xyb[1]) * 8)))
        na, nb = rounded.get(ka), rounded.get(kb)
        if na is not None and nb is not None and na != nb:
            pair = tuple(sorted((na, nb)))
            links[pair] = links.get(pair, 0) + 2  # a gated loop inlier
            # counts as full support

    # a single shared keypoint says nothing about how the two submaps
    # chained it forward: union only pairs with >= 2 shared observations
    for (na, nb), cnt in links.items():
        if cnt >= 2:
            union(na, nb)

    groups = {}
    for node in parent:
        groups.setdefault(find(node), []).append(node)
    merged = []
    for members in groups.values():
        allobs = {}
        consistent = True
        for m in members:
            for f, xy in track_obs[m].items():
                if f in allobs and allobs[f] != xy:
                    consistent = False  # same frame, different keypoint:
                    break               # two landmarks; reject the merge
                allobs[f] = xy
            if not consistent:
                break
        if consistent:
            merged.append(allobs)
        else:
            merged.append(dict(max((track_obs[m] for m in members),
                                   key=len)))
    merged.sort(key=len, reverse=True)
    merged = merged[:capacity]

    obs = np.zeros((num_frames, capacity, 2), np.float32)
    obs_mask = np.zeros((num_frames, capacity), bool)
    for t_id, allobs in enumerate(merged):
        for f, xy in allobs.items():
            obs[f, t_id] = xy
            obs_mask[f, t_id] = True
    return obs, obs_mask


def refine_submaps_global(rs_all, ts_all, results, spans, k,
                          num_frames: int, capacity: int = 4096,
                          rounds: int = 2, iterations: int = 20,
                          prune_px: float = 3.0,
                          min_depth: float = 1e-3,
                          max_depth: float = 1e3,
                          loop_links=None,
                          prior_weight: float = 300.0, *, device="cuda",
                          plain: bool = False):
    """Cross-seam global refinement: merged tracks → retriangulate from
    the stitched poses → global BA (camera 0 fixed, every camera anchored
    to the input poses with ``prior_weight``) → prune, ``rounds`` times.
    ``loop_links`` fuses tracks across accepted loop edges, so the BA
    carries the pose graph's revisit constraints.  Returns (rs, ts,
    points (N, 3)) as numpy."""
    dev = resolve_device(device)
    obs, obs_mask = _merge_submap_tracks(results, spans, num_frames,
                                         capacity, loop_links=loop_links)
    kmat = torch.as_tensor(np.asarray(k), dtype=torch.float32, device=dev)
    rs = torch.as_tensor(np.asarray(rs_all), dtype=torch.float32,
                         device=dev)
    ts = torch.as_tensor(np.asarray(ts_all), dtype=torch.float32,
                         device=dev)
    table = TrackTable(
        obs=torch.from_numpy(obs).to(dev),
        obs_mask=torch.from_numpy(obs_mask).to(dev),
        points=torch.zeros((capacity, 3), device=dev),
        has_point=torch.zeros((capacity,), dtype=torch.bool, device=dev),
        kp_track=torch.zeros((obs.shape[1],), dtype=torch.int32,
                             device=dev),
        num_tracks=torch.tensor(capacity, dtype=torch.int32, device=dev),
        dropped=torch.tensor(0, dtype=torch.int32, device=dev))
    fixed = torch.ones((num_frames,), device=dev)
    fixed[0] = 0.0
    # the input (pose-graph / loop-closed) poses anchor every round: a
    # pure-reprojection global BA of a long monocular arc drifts into
    # basins the pose graph excluded
    prior_rs, prior_ts = rs, ts
    for _ in range(max(1, rounds)):
        table = _retriangulate_all(table, rs, ts, kmat, min_depth, max_depth)
        table = _prune_observations(table, rs, ts, kmat, prune_px)
        res = bundle_adjust(
            BAState(rs=rs, ts=ts, points=table.points),
            BAProblem(obs=table.obs,
                      mask=table.obs_mask & table.has_point[None, :],
                      k=kmat),
            num_iterations=iterations, fixed_cameras=fixed,
            use_pose_prior=prior_weight > 0, prior_rs=prior_rs,
            prior_ts=prior_ts, prior_weight=prior_weight, plain=plain)
        rs, ts = res.state.rs, res.state.ts
        table = table._replace(points=res.state.points)
    pts = table.points[table.has_point].cpu().numpy()
    return (rs.cpu().numpy().astype(np.float32),
            ts.cpu().numpy().astype(np.float32), pts)


def submap_spans(num_frames: int, submap_frames: int, overlap: int):
    """(start, end) of each window: ``submap_frames`` long, consecutive
    ones sharing ``overlap`` frames, a tail shorter than overlap + 2
    merged into its predecessor."""
    if overlap < 3:
        raise ValueError("overlap must be >= 3 for similarity stitching")
    step = submap_frames - overlap
    if step <= 0:
        raise ValueError("submap_frames must exceed overlap")
    spans = []
    s0 = 0
    while True:
        e0 = min(s0 + submap_frames, num_frames)
        spans.append((s0, e0))
        if e0 >= num_frames:
            break
        s0 += step
    if len(spans) > 1 and spans[-1][1] - spans[-1][0] < overlap + 2:
        spans[-2] = (spans[-2][0], spans[-1][1])
        spans.pop()
    return spans


def _in_stitched_gauge(results, spans, rs_all, ts_all, i):
    """Submap i's poses (and cloud) mapped onto the stitched gauge by the
    similarity fitted on its overlap with the frames stitched so far."""
    a = spans[i][0]
    prev_end = spans[i - 1][1]
    ov = prev_end - a                     # shared frame count
    s, r_g, t_g = _align_sim3_poses(results[i].rs[:ov], results[i].ts[:ov],
                                    rs_all[a:prev_end], ts_all[a:prev_end])
    return ov, (s, r_g, t_g)


def run_submap_sfm(frames, k, config: SfmConfig | None = None,
                   submap_frames: int = 16, overlap: int = 4,
                   seed: int = 0, restarts: int = 3,
                   pose_graph_iterations: int = 15,
                   global_refine_rounds: int = 0,
                   global_track_capacity: int = 4096, *, device="cuda",
                   plain: bool = False) -> SubmapResult:
    """frames (F, H, W) → stitched trajectory + merged cloud.

    ``overlap`` >= 3 (the seam similarity needs >= 3 shared poses); each
    window runs ``run_incremental_sfm_robust`` (seed + i, best of
    ``restarts``, drawing up to 8 while no restart reaches a median
    reprojection error of 0.5 px) with a fresh table.
    """
    config = config or SfmConfig()
    num_frames = len(frames)
    spans = submap_spans(num_frames, submap_frames, overlap)
    dev = resolve_device(device)

    # best of restarts per window: one bad basin in any submap poisons
    # every seam after it
    results = [run_incremental_sfm_robust(frames[a:b], k, config,
                                          seed=seed + i, restarts=restarts,
                                          target_med_px=0.5, max_restarts=8,
                                          device=dev, plain=plain)
               for i, (a, b) in enumerate(spans)]

    # ---- stitch: chain similarities across overlaps -----------------
    rs_all = np.zeros((num_frames, 3, 3), np.float32)
    ts_all = np.zeros((num_frames, 3), np.float32)
    a0, b0 = spans[0]
    rs_all[a0:b0] = results[0].rs
    ts_all[a0:b0] = results[0].ts
    clouds = [results[0].points]
    for i in range(1, len(spans)):
        a, b = spans[i]
        prev_end = spans[i - 1][1]
        ov, sim = _in_stitched_gauge(results, spans, rs_all, ts_all, i)
        rs_i, ts_i, pts_i = _apply_sim3(*sim, results[i].rs, results[i].ts,
                                        results[i].points)
        # shared frames keep the stitched estimate (the pose graph
        # reconciles both below)
        rs_all[prev_end:b] = rs_i[ov:]
        ts_all[prev_end:b] = ts_i[ov:]
        clouds.append(pts_i)

    # ---- pose-graph smoothing over the seams ------------------------
    if len(spans) > 1 and pose_graph_iterations > 0:
        edges, zr, zt, w = [], [], [], []
        for i, (a, b) in enumerate(spans):
            rs_i, ts_i = results[i].rs, results[i].ts
            ov = 0
            if i > 0:  # in the stitched gauge, for a consistent z_t scale
                ov, sim = _in_stitched_gauge(results, spans, rs_all, ts_all,
                                             i)
                rs_i, ts_i, _ = _apply_sim3(*sim, rs_i, ts_i)
            # relative poses in float32, as the JAX package takes them
            r32 = torch.as_tensor(np.asarray(rs_i, np.float32))
            t32 = torch.as_tensor(np.asarray(ts_i, np.float32))
            r_rel, t_rel = relative_pose(r32[:-1], t32[:-1], r32[1:],
                                         t32[1:])
            for f in range(len(rs_i) - 1):
                edges.append((a + f, a + f + 1))
                # edges with both ends among the ov shared frames are
                # measured by two submaps: weight 2; the seam-crossing
                # edge (f == ov - 1) exists in this submap only
                w.append(1.0 if i == 0 or f >= ov - 1 else 2.0)
            zr.append(r_rel)
            zt.append(t_rel)
        graph = PoseGraph(
            edges=torch.tensor(edges, dtype=torch.int32, device=dev),
            z_rs=torch.cat(zr).to(dev), z_ts=torch.cat(zt).to(dev),
            weights=torch.tensor(w, dtype=torch.float32, device=dev))
        out = optimize_pose_graph(torch.as_tensor(rs_all, device=dev),
                                  torch.as_tensor(ts_all, device=dev), graph,
                                  num_iterations=pose_graph_iterations)
        rs_all = out.rs.cpu().numpy().astype(np.float32)
        ts_all = out.ts.cpu().numpy().astype(np.float32)

    # ---- cross-seam global refinement --------------------------------
    points = np.concatenate(clouds, axis=0)
    if len(spans) > 1 and global_refine_rounds > 0:
        rs_all, ts_all, points = refine_submaps_global(
            rs_all, ts_all, results, spans, k, num_frames,
            capacity=global_track_capacity, rounds=global_refine_rounds,
            iterations=config.final_ba_iterations or 20,
            prune_px=config.prune_px, min_depth=config.min_depth,
            max_depth=config.max_depth, device=dev, plain=plain)

    total = sum(int(r.table.num_tracks) for r in results)
    dropped = sum(int(r.table.dropped) for r in results)
    return SubmapResult(rs=rs_all, ts=ts_all, points=points,
                        submaps=results, spans=spans, total_tracks=total,
                        dropped=dropped)
