"""Incremental SfM over an image sequence (port of the staged
sequential-draw loop of photogrammetry_tpu/sfm/incremental.py).

  all frames: batched detect/describe (``precompute_frontend``)
  frame 0:    open tracks
  frame t:    match t-1 and t-2 → epipolar gates → extend tracks;
              until the map exists, defer until frame 0's tracks have moved
              enough, then bootstrap from the (0, t) pair with PnP
              intermediates; afterwards pose init = pose(t-1), rescued by
              RANSAC PnP → motion-only BA → re-associate → triangulate new
              tracks → windowed BA → rescale gauge → prune
  end:        global BA rounds with re-triangulation in between

Every stage is tensor code on the frames' device; the only host reads
before the final export are the bootstrap trigger's median displacement
(one per deferred frame, as in the JAX package; none with
``SfmConfig.read_free``, which bootstraps at min(bootstrap_max_defer,
F-1)), with ``collect_diagnostics`` the per-frame counters (one read a
frame), and with a checkpoint the snapshot itself (state and cost).  Where
the JAX package branches on device data (``lax.cond`` in the PnP stages)
the port computes the branch and selects with ``torch.where``; so it draws
the PnP samples on every steady frame, where JAX splits its key only when
the rescue runs.  All randomness comes from one ``torch.Generator`` on the
device seeded with ``seed``, drawn in JAX's order: the gate, the skip gate,
the bootstrap attempts, then PnP.  Frame indices inside the per-frame
stages are 0-dim tensors on the device (``frame_ids[t]``), so that one
CUDA-graph capture of a steady frame serves every frame.

A steady frame (the map exists) is one function, ``_steady_frame``:
chaining (``_track_frame``), pose (``_localize_frame``) and the map update
(``_map_frame``).  One loop (``_run``) serves both entries and calls it
frame by frame; with ``SfmConfig.fused_steady_steps`` the frames from
t = 2 on go through ``_SteadyStep``, the same function eagerly on the CPU
and as a captured CUDA graph on the card (``utils.graphs.GraphCall`` over
a ``SegmentedGraph``: cut into segments at the ``eigh`` / ``svd`` calls,
which read their error flag back to the host; replayed segment after
segment, each cut's call made between two), captured once for each
(configuration, frame count, device, plain) and reused across
``run_incremental_sfm_robust``'s restarts.  ``run_incremental_sfm_fused``
is the same loop with the step on, its frames after the bootstrap
labelled ``pose_init="scan"``.  All three give the same bits.

With ``SfmConfig.precompute_matching`` every (t, t-1) and (t, t-2) match
and its epipolar gate is computed once after the frontend
(``frontend.precompute_matching``: a chunk of pairs a launch of the
batched Hamming kernel, each pair's gate drawn from its own generator,
whose base seed is one host read of the run's generator), and frame t
chains its tracks from row t of the result.

With ``checkpoint_path`` the state (poses, landmarks, track table)
snapshots every ``checkpoint_every`` frames and at the last frame
(``store/checkpoint.py``, the JAX package's file format), deferred frames
included (not the fused frames, as in the JAX package), and a rerun
resumes after the snapshot's frame.

With ``SfmConfig.mesh`` (a ``parallel.make_mesh`` mesh) the windowed and
the final BA run as ``distributed_bundle_adjust``, landmarks sharded over
the mesh's "tracks" ranks; every rank runs the rest of the run identically
with the same seeds (SPMD), so every rank holds the same result.  The
fused step runs the windowed BA unsharded, as the JAX package's does.

``export=False`` returns a ``DeviceSfmResult`` (poses, costs and the
bootstrap support still on the device); ``export_sfm_result`` makes the
one batched transfer.

While ``utils.profiling`` records, a run is the span ``sfm.sequence``
and its stages the spans under it: ``sfm.frontend``, ``sfm.track``,
``sfm.bootstrap``, ``sfm.localize``, ``sfm.map``, ``sfm.steady_step``,
``sfm.host_read``, ``sfm.checkpoint``, ``sfm.final_ba``, ``sfm.export``.
"""
from __future__ import annotations

import os
import time
from dataclasses import dataclass, replace

import numpy as np
import torch

from photogrammetry_tpu_torch import resolve_device
from photogrammetry_tpu_torch.sfm.ba import (
    BAProblem, BAState, bundle_adjust, project,
)
from photogrammetry_tpu_torch.sfm.epipolar import (
    draw_samples, ransac_fundamental, smallest_eigvec,
)
from photogrammetry_tpu_torch.sfm.frontend import (
    FrontendConfig, frame_features, make_pairs, match_pair,
    precompute_frontend, precompute_matching,
)
from photogrammetry_tpu_torch.sfm.pnp import (
    draw_pnp_samples, pnp_reprojection_errors, ransac_pnp,
)
from photogrammetry_tpu_torch.sfm.tracks import (
    TrackTable, extend_tracks_with_tid, first_last_observations,
    make_track_table, merge_skip_matches, reassociate_to_landmarks,
    start_tracks,
)
from photogrammetry_tpu_torch.sfm.triangulate import triangulate_nview
from photogrammetry_tpu_torch.sfm.two_view import two_view_pipeline
from photogrammetry_tpu_torch.store.checkpoint import (
    load_checkpoint, save_checkpoint,
)
from photogrammetry_tpu_torch.utils.graphs import (
    GraphCall, SegmentedGraph, allow_sync, capture_stream,
)
from photogrammetry_tpu_torch.utils.indexing import put_row, take_row
from photogrammetry_tpu_torch.utils.profiling import span
from photogrammetry_tpu_torch.utils.reductions import nanmedian


@dataclass(frozen=True)
class SfmConfig:
    """The JAX SfmConfig; its field comments hold here.  ``mesh``: a
    ``torch.distributed`` DeviceMesh (``parallel.make_mesh``) for the
    sharded BA, or None."""
    frontend: FrontendConfig = FrontendConfig(
        suppression_radius=4.0, hamming_threshold=80, max_keypoints=512,
        detection_threshold=20.0)
    track_capacity: int = 1024
    ransac_threshold: float = 1.5
    ransac_samples: int = 1000
    # deferred two-view bootstrap: tracks accumulate poseless until the
    # median frame-0 displacement reaches bootstrap_min_disp_px (or
    # bootstrap_max_defer frames pass)
    bootstrap_min_disp_px: float = 50.0
    bootstrap_max_defer: int = 3
    bootstrap_attempts: int = 4
    ba_iterations: int = 30
    window: int = 8               # BA window (frames)
    final_ba_iterations: int = 30
    final_refine_rounds: int = 2
    use_pnp: bool = True
    pnp_threshold: float = 4.0
    pnp_samples: int = 512
    min_pnp_inliers: int = 6      # the DLT minimal-sample size
    pnp_rescue_px: float = 16.0
    nview_triangulation: bool = True
    reassociate: bool = True
    reassociate_px: float = 4.0
    min_depth: float = 1e-3
    max_depth: float = 1e3
    prune_px: float = 3.0         # reprojection-error observation pruning
    collect_diagnostics: bool = True
    frontend_chunk: int = 16
    # > 1: the pyramid frontend (frontend.detect_and_describe_*_pyramid);
    # keypoint capacity becomes octaves x frontend.max_keypoints, so scale
    # track_capacity with it
    pyramid_octaves: int = 1
    # match and gate every (t, t-1) / (t, t-2) pair up front, a chunk of
    # frontend_chunk pairs a batched Hamming launch
    precompute_matching: bool = False
    mesh: object = None
    # the steady frames (t >= 2, map built) through one step: a captured
    # CUDA graph on the card, the same function eagerly on the CPU; None
    # is off, as in the JAX package.  Frames so run record no
    # diagnostics and take no checkpoint
    fused_steady_steps: bool | None = None
    # no host read before the export: the bootstrap fires at
    # min(bootstrap_max_defer, F-1) instead of on the displacement read
    read_free: bool = False


def _depth_ok(mask, depths, min_depth, max_depth):
    """Per track: every observing view places the point inside the depth
    band."""
    inside = (depths > min_depth) & (depths < max_depth)
    return torch.where(mask, inside, True).all(0)


def _triangulate_tracks(table: TrackTable, rs, ts, k, first, last,
                        min_depth, max_depth) -> TrackTable:
    """DLT-triangulate tracks with >= 2 observations and no landmark yet
    from their first and last observing frames."""
    cap = table.points.shape[0]
    need = (~table.has_point) & (first >= 0) & (last > first)
    ar = torch.arange(cap, device=rs.device)
    f0 = torch.clamp(first, min=0).long()
    f1 = torch.clamp(last, min=0).long()
    p_all = k @ torch.cat([rs, ts[:, :, None]], dim=2)              # (F,3,4)
    xy0, xy1 = table.obs[f0, ar], table.obs[f1, ar]
    p0, p1 = p_all[f0], p_all[f1]
    d = torch.stack([xy0[:, 0, None] * p0[:, 2] - p0[:, 0],
                     xy0[:, 1, None] * p0[:, 2] - p0[:, 1],
                     xy1[:, 0, None] * p1[:, 2] - p1[:, 0],
                     xy1[:, 1, None] * p1[:, 2] - p1[:, 1]], dim=1)
    xh = smallest_eigvec(d.transpose(-1, -2) @ d)
    denom = torch.where(xh[:, 3].abs() < 1e-12, 1e-12, xh[:, 3])
    x = xh[:, :3] / denom[:, None]
    z0 = (rs[f0] @ x[..., None])[:, 2, 0] + ts[f0, 2]
    z1 = (rs[f1] @ x[..., None])[:, 2, 0] + ts[f1, 2]
    ok = (z0 > min_depth) & (z1 > min_depth) & (z0 < max_depth) \
        & (z1 < max_depth)
    accept = need & ok
    return table._replace(points=torch.where(accept[:, None], x,
                                             table.points),
                          has_point=table.has_point | accept)


def _triangulate_tracks_nview(table: TrackTable, rs, ts, k,
                              min_depth, max_depth) -> TrackTable:
    """Triangulate un-pointed tracks with >= 2 observations from all their
    observing views; every view must place the point inside the depth
    band."""
    pts, depths = triangulate_nview(table.obs, table.obs_mask, rs, ts, k)
    need = (~table.has_point) & (table.obs_mask.sum(0) >= 2)
    accept = need & _depth_ok(table.obs_mask, depths, min_depth, max_depth)
    return table._replace(points=torch.where(accept[:, None], pts,
                                             table.points),
                          has_point=table.has_point | accept)


def _retriangulate_all(table: TrackTable, rs, ts, k,
                       min_depth, max_depth) -> TrackTable:
    """Re-triangulate every track with >= 2 observations from the current
    poses, replacing stale landmarks."""
    pts, depths = triangulate_nview(table.obs, table.obs_mask, rs, ts, k)
    accept = (table.obs_mask.sum(0) >= 2) & _depth_ok(
        table.obs_mask, depths, min_depth, max_depth)
    return table._replace(points=torch.where(accept[:, None], pts,
                                             table.points),
                          has_point=accept)


def _median_reproj(r, t, points, obs_t, pnp_mask, kmat):
    """JAX-semantics median reprojection error over ``pnp_mask`` (inf for
    points behind the camera)."""
    err, z = pnp_reprojection_errors(r, t, points, obs_t, kmat)
    e = torch.where(z > 0, err, torch.inf)
    return nanmedian(torch.where(pnp_mask, e, torch.nan))


def _pnp_rescue_device(sample_idx, points, obs_t, pnp_mask, kmat, r_prior,
                       t_prior, min_inliers: int, rescue_px: float,
                       threshold: float):
    """The PnP-rescue decision: RANSAC PnP over the hypotheses
    ``sample_idx`` replaces the prior pose when the prior's median
    reprojection error on the map exceeds ``rescue_px`` and PnP has enough
    inliers and a lower median.  The PnP branch is always computed and
    selected on the device (no host read).

    Returns (r, t, diag) with diag = (rescued, used_pnp, support,
    prior_med, pnp_inliers, pnp_med) as device scalars.
    """
    support = pnp_mask.sum()
    prior_med = _median_reproj(r_prior, t_prior, points, obs_t, pnp_mask,
                               kmat)
    rescue = (support >= min_inliers) & (prior_med > rescue_px)
    pnp = ransac_pnp(sample_idx, points, obs_t, pnp_mask, kmat,
                     threshold=threshold)
    pnp_med = _median_reproj(pnp.r, pnp.t, points, obs_t, pnp_mask, kmat)
    ok = rescue & (pnp.num_inliers >= min_inliers) & (pnp_med < prior_med)
    r = torch.where(ok, pnp.r, r_prior)
    t = torch.where(ok, pnp.t, t_prior)
    diag = (rescue, ok, support, prior_med,
            torch.where(rescue, pnp.num_inliers, 0),
            torch.where(rescue, pnp_med, torch.nan))
    return r, t, diag


def _pnp_init_device(sample_idx, points, obs_i, pnp_mask, kmat, r_prior,
                     t_prior, min_inliers: int, threshold: float):
    """Support-gated RANSAC PnP pose over the hypotheses ``sample_idx``
    (the prior where fewer than ``min_inliers`` correspondences exist),
    selected on the device."""
    pnp = ransac_pnp(sample_idx, points, obs_i, pnp_mask, kmat,
                     threshold=threshold)
    use = pnp_mask.sum() >= min_inliers
    return torch.where(use, pnp.r, r_prior), torch.where(use, pnp.t, t_prior)


def _rescale_gauge(rs, ts, table: TrackTable):
    """Similarity-rescale the reconstruction about camera 0's center so
    ||center_1 - center_0|| == 1 (the two-view bootstrap's unit baseline);
    a no-op while frames 0/1 coincide, the factor clamped to [0.1, 10]."""
    centers = -(rs.transpose(-1, -2) @ ts[..., None])[..., 0]
    baseline = torch.linalg.vector_norm(centers[1] - centers[0])
    s = torch.where(baseline > 1e-9,
                    1.0 / torch.clamp(baseline, min=1e-9), 1.0)
    s = torch.clamp(s, 0.1, 10.0)
    c0 = centers[0]
    new_centers = c0[None, :] + s * (centers - c0[None, :])
    new_ts = -(rs @ new_centers[..., None])[..., 0]
    new_points = c0[None, :] + s * (table.points - c0[None, :])
    return rs, new_ts, table._replace(points=new_points)


def _prune_observations(table: TrackTable, rs, ts, k,
                        prune_px) -> TrackTable:
    """Drop observations of triangulated tracks reprojecting beyond
    ``prune_px`` (or behind the camera), and retire landmarks left with
    fewer than two observations."""
    pred, z, _ = project(rs, ts, table.points, k)
    d = pred - table.obs
    err = torch.sqrt((d * d).sum(-1))
    bad = table.has_point[None, :] & table.obs_mask & \
        ((err > prune_px) | (z <= 0))
    obs_mask = table.obs_mask & ~bad
    has_point = table.has_point & (obs_mask.sum(0) >= 2)
    return table._replace(obs_mask=obs_mask, has_point=has_point)


def _ba_problem(table: TrackTable, kmat) -> BAProblem:
    return BAProblem(obs=table.obs,
                     mask=table.obs_mask & table.has_point[None, :], k=kmat)


def _bootstrap_map(generator, table: TrackTable, rs, ts, kmat,
                   config: SfmConfig, t: int, num_frames: int,
                   plain: bool = False):
    """Initialize the map from the (0, t) track pair + PnP intermediates.

    Runs ``bootstrap_attempts`` independent two-view RANSAC draws; each
    candidate triangulates the (0, t) correspondences, PnP-initializes
    frames 1..t-1 from the fresh landmarks and bundle-adjusts frames 1..t.
    Arbitration, on the device: among candidates whose post-BA support
    (tracks reprojecting within 2 px at positive depth on >= 2 frames) is
    within 10% of the best, the lowest mean supported reprojection error
    wins (the first on a tie).  Returns (rs, ts, table, support).
    """
    with span("sfm.bootstrap", t=t):
        pair_mask = torch.zeros_like(table.obs_mask)
        pair_mask[0] = table.obs_mask[0]
        pair_mask[t] = table.obs_mask[t]
        both = table.obs_mask[0] & table.obs_mask[t]
        dev = rs.device
        fixed = torch.zeros((num_frames,), device=dev)
        fixed[1:t + 1] = 1.0

        cands = []
        for _ in range(max(1, config.bootstrap_attempts)):
            # frame t first: (tv.r, tv.t) maps frame-t coords to frame 0, so
            # frame t's world->cam pose is its inverse
            tv = two_view_pipeline(generator, table.obs[t], table.obs[0], both,
                                   kmat, threshold=config.ransac_threshold,
                                   num_samples=config.ransac_samples)
            rs_c = put_row(rs, t, tv.r.T)
            ts_c = put_row(ts, t, -tv.r.T @ tv.t)
            cand = _triangulate_tracks_nview(
                table._replace(obs_mask=pair_mask), rs_c, ts_c, kmat,
                config.min_depth, config.max_depth)._replace(
                    obs_mask=table.obs_mask)
            for i in range(1, t):
                pnp_mask = cand.obs_mask[i] & cand.has_point
                r_i, t_i = _pnp_init_device(
                    draw_pnp_samples(generator, pnp_mask, config.pnp_samples),
                    cand.points, cand.obs[i], pnp_mask, kmat, rs_c[i], ts_c[i],
                    min_inliers=config.min_pnp_inliers,
                    threshold=config.pnp_threshold)
                rs_c = put_row(rs_c, i, r_i)
                ts_c = put_row(ts_c, i, t_i)
            prob = _ba_problem(cand, kmat)
            res = bundle_adjust(BAState(rs=rs_c, ts=ts_c, points=cand.points),
                                prob, num_iterations=20, fixed_cameras=fixed,
                                plain=plain)
            pred, z, _ = project(*res.state, kmat)
            d = pred - cand.obs
            err = torch.sqrt((d * d).sum(-1))
            okobs = prob.mask & (err < 2.0) & (z > config.min_depth)
            support = (okobs.sum(0) >= 2).sum()
            mean_err = (torch.where(okobs, err, 0.0).sum()
                        / torch.clamp(okobs.sum(), min=1))
            cands.append((support, mean_err, *res.state, cand.has_point))

        sup_a, err_a, rs_a, ts_a, pts_a, hp_a = map(torch.stack, zip(*cands))
        near = sup_a >= 0.9 * sup_a.max().to(torch.float32)
        pick = torch.argmin(torch.where(near, err_a, torch.inf))
        table = table._replace(points=pts_a[pick], has_point=hp_a[pick])
        return rs_a[pick], ts_a[pick], table, sup_a[pick]


class SfmResult:
    """Host-side result: trajectory + landmarks + diagnostics."""

    def __init__(self, rs, ts, table: TrackTable, costs, frame_info=None):
        self.rs = np.asarray(rs)
        self.ts = np.asarray(ts)
        self.table = table
        self.costs = costs
        # per-frame dicts: matches, gated matches, pose-init path taken,
        # PnP support/inlier counts, prior/pnp median reprojection errors
        self.frame_info = frame_info or []

    @property
    def camera_centers(self) -> np.ndarray:
        return -np.einsum("fji,fj->fi", self.rs, self.ts)

    @property
    def points(self) -> np.ndarray:
        hp = self.table.has_point.cpu().numpy()
        return self.table.points.cpu().numpy()[hp]


class DeviceSfmResult:
    """Device-side result, no host read taken: what
    ``run_incremental_sfm(..., export=False)`` returns.  rs (F, 3, 3), ts
    (F, 3), the table and the costs (0-dim tensors) on the device;
    ``pending_support`` the bootstrap frame's info dict and its support (a
    device scalar), or None.  ``export_sfm_result`` reads it back."""

    def __init__(self, rs, ts, table, costs, frame_info, pending_support):
        self.rs = rs
        self.ts = ts
        self.table = table
        self.costs = costs
        self.frame_info = frame_info
        self.pending_support = pending_support


def export_sfm_result(dev: DeviceSfmResult) -> SfmResult:
    """The one batched device-to-host transfer that closes a run: poses,
    costs and the bootstrap support (into its frame's info as
    ``bootstrap_support``)."""
    with span("sfm.export"):
        vals = dev.costs + ([dev.pending_support[1].to(torch.float32)]
                            if dev.pending_support else [])
        scalars = torch.stack(vals).cpu() if vals else torch.zeros(0)
        if dev.pending_support is not None:
            dev.pending_support[0]["bootstrap_support"] = int(scalars[-1])
        return SfmResult(dev.rs.cpu().numpy(), dev.ts.cpu().numpy(), dev.table,
                         [float(c) for c in scalars[:len(dev.costs)]],
                         dev.frame_info)


def _gate(generator, m, config: SfmConfig):
    """Epipolar gate of a match set: mask & RANSAC-F inliers."""
    idx = draw_samples(generator, m.mask, config.ransac_samples // 2, 8)
    return m.mask & ransac_fundamental(idx, m.xy1, m.xy2, m.mask,
                                       config.ransac_threshold).inliers


def _track_frame(generator, feats, pm, cur, table: TrackTable,
                 kp_track_prev2, t, config: SfmConfig, plain: bool,
                 diagnostics: bool):
    """Frame t's track chaining: match frame t-1 and, where frame t-2's
    keypoint map ``kp_track_prev2`` exists, t-2 → epipolar gates → merge →
    extend the table; with ``pm`` row t of the precomputed matches and
    gates instead.  ``cur``: frame t's features; t a 0-dim device index.
    Returns (table, the keypoint -> track map before it, (matches, gated,
    chained) device scalars or None)."""
    with span("sfm.track", t=t):
        fc = config.frontend
        kp_track_prev = table.kp_track
        if pm is not None:
            kp2 = (kp_track_prev2 if kp_track_prev2 is not None
                   else torch.full_like(table.kp_track, -1))
            good = take_row(pm.good1, t)
            tid = merge_skip_matches(kp_track_prev, kp2, take_row(pm.idx1, t),
                                     good, take_row(pm.idx2, t),
                                     take_row(pm.good2, t),
                                     config.track_capacity)
            num = take_row(pm.num1, t)
        else:
            # rows = the current frame's keypoints; only RANSAC-inlier matches
            # may chain tracks
            m = match_pair(cur, frame_features(feats, t - 1), fc, plain=plain)
            good = _gate(generator, m, config)
            if kp_track_prev2 is not None:
                # skip-frame matching: unclaimed keypoints also match t-2
                m2 = match_pair(cur, frame_features(feats, t - 2), fc,
                                plain=plain)
                good2 = _gate(generator, m2, config)
                tid = merge_skip_matches(kp_track_prev, kp_track_prev2,
                                         m.idx2, good, m2.idx2, good2,
                                         config.track_capacity)
            else:
                tid = torch.where(
                    good, kp_track_prev[torch.clamp(m.idx2, min=0).long()],
                    -1).to(torch.int32)
            num = m.num
        table = extend_tracks_with_tid(table, t, cur.xy, cur.points.mask, tid)
        diag = ((num, good.sum(), (tid >= 0).sum()) if diagnostics else None)
        return table, kp_track_prev, diag


def _localize_frame(generator, cur, table: TrackTable, rs, ts, kmat, t,
                    config: SfmConfig, plain: bool):
    """A mapped frame's pose: frame t-1's pose, rescued by RANSAC PnP
    against the map when its median reprojection error exceeds
    ``pnp_rescue_px`` (drawn every frame, chosen on the device) →
    motion-only BA on all frames (camera t free) → map-guided
    re-association of the keypoints whose chain broke.  Returns (table,
    rs, ts, (the PnP decision's device scalars or None, re-associated
    count or None))."""
    with span("sfm.localize", t=t):
        r_prev, t_prev = take_row(rs, t - 1), take_row(ts, t - 1)
        pnp_diag = None
        if config.use_pnp:
            pnp_mask = take_row(table.obs_mask, t) & table.has_point
            r_t, t_t, pnp_diag = _pnp_rescue_device(
                draw_pnp_samples(generator, pnp_mask, config.pnp_samples),
                table.points, take_row(table.obs, t), pnp_mask, kmat,
                r_prev, t_prev, min_inliers=config.min_pnp_inliers,
                rescue_px=config.pnp_rescue_px, threshold=config.pnp_threshold)
        else:
            r_t, t_t = r_prev, t_prev
        rs = put_row(rs, t, r_t)
        ts = put_row(ts, t, t_t)
        frames = torch.arange(rs.shape[0], device=rs.device)
        res = bundle_adjust(BAState(rs=rs, ts=ts, points=table.points),
                            _ba_problem(table, kmat), num_iterations=10,
                            fixed_cameras=(frames == t).to(torch.float32),
                            optimize_points=False, plain=plain)
        rs, ts = res.state.rs, res.state.ts
        n_re = None
        if config.reassociate:
            table, n_re = reassociate_to_landmarks(
                table, t, cur.xy, cur.points.mask, take_row(rs, t),
                take_row(ts, t), kmat, config.reassociate_px)
        return table, rs, ts, (pnp_diag, n_re)


def _bundle_adjust_map(table: TrackTable, rs, ts, kmat, fixed,
                       iterations: int, mesh, plain: bool):
    """BA of the whole map (``distributed_bundle_adjust`` over ``mesh``
    where one is given).  Returns (rs, ts, table, cost)."""
    state = BAState(rs=rs, ts=ts, points=table.points)
    if mesh is not None:
        # imported here: torch.distributed.tensor takes a second
        from photogrammetry_tpu_torch.parallel.dist_ba import (
            distributed_bundle_adjust,
        )

        res = distributed_bundle_adjust(
            state, _ba_problem(table, kmat), mesh, num_iterations=iterations,
            fixed_cameras=fixed, plain=plain)
    else:
        res = bundle_adjust(state, _ba_problem(table, kmat),
                            num_iterations=iterations, fixed_cameras=fixed,
                            plain=plain)
    return (res.state.rs, res.state.ts,
            table._replace(points=res.state.points), res.cost)


def _map_frame(table: TrackTable, rs, ts, kmat, t, config: SfmConfig,
               plain: bool, mesh=None):
    """A posed frame's map update: triangulate new tracks → windowed BA
    (cameras t+1-window..t free, frame 0 the SE(3) gauge) → rescale the
    monocular gauge → prune.  Returns (table, rs, ts, cost)."""
    with span("sfm.map", t=t):
        if config.nview_triangulation:
            table = _triangulate_tracks_nview(table, rs, ts, kmat,
                                              config.min_depth,
                                              config.max_depth)
        else:
            first, last = first_last_observations(table)
            table = _triangulate_tracks(table, rs, ts, kmat, first, last,
                                        config.min_depth, config.max_depth)
        frames = torch.arange(rs.shape[0], device=rs.device)
        fixed = ((frames > t - config.window) & (frames <= t)
                 & (frames > 0)).to(torch.float32)
        rs, ts, table, cost = _bundle_adjust_map(table, rs, ts, kmat, fixed,
                                                 config.ba_iterations, mesh,
                                                 plain)
        # monocular scale gauge: keep the 0-1 baseline at unit length
        rs, ts, table = _rescale_gauge(rs, ts, table)
        table = _prune_observations(table, rs, ts, kmat, config.prune_px)
        return table, rs, ts, cost


def _steady_frame(generator, feats, pm, kmat, carry, t, config: SfmConfig,
                  plain: bool, diagnostics: bool = False, mesh=None):
    """One frame once the map exists: the staged loop's body and the fused
    step.  carry = (table, rs, ts, frame t-2's keypoint -> track map or
    None); t a 0-dim device index.  Returns ((table, rs, ts, frame t-1's
    keypoint -> track map), cost, (chaining, pose) diagnostics)."""
    table, rs, ts, kp_track_prev2 = carry
    cur = frame_features(feats, t)
    table, kp_track_prev, track_diag = _track_frame(
        generator, feats, pm, cur, table, kp_track_prev2, t, config, plain,
        diagnostics)
    table, rs, ts, pose_diag = _localize_frame(generator, cur, table, rs, ts,
                                               kmat, t, config, plain)
    table, rs, ts, cost = _map_frame(table, rs, ts, kmat, t, config, plain,
                                     mesh)
    return (table, rs, ts, kp_track_prev), cost, (track_diag, pose_diag)


def _read_diagnostics(info: dict, track_diag, pose_diag=None) -> None:
    """A frame's counters in one host read, into ``info`` under the JAX
    package's keys."""
    with span("sfm.host_read"):
        pnp, n_re = pose_diag or (None, None)
        vals = [*track_diag, *(pnp or ()), *(() if n_re is None else (n_re,))]
        host = torch.stack([v.to(torch.float64) for v in vals]).tolist()
        info.update(matches=int(host[0]), gated_matches=int(host[1]),
                    chained=int(host[2]))
        if pnp is not None:
            rescued, used, support, prior_med, pnp_inl, pnp_med = host[3:9]
            info.update(pnp_support=int(support), prior_med_px=prior_med)
            if rescued:
                info.update(pnp_inliers=int(pnp_inl), pnp_med_px=pnp_med)
            if used:
                info["pose_init"] = "pnp"
        if n_re is not None:
            info["reassociated"] = int(host[-1])


class _SteadyStep:
    """The fused steady step of one configuration: ``step(feats, pm,
    kmat, carry, t)`` → (carry, cost), ``_steady_frame`` without
    diagnostics or mesh, t a 0-dim device index, drawing from
    ``generator``.

    On the CPU the step runs eagerly.  On CUDA the first call runs it
    eagerly on the capture stream (the warm-up a capture needs: library
    handles and workspaces, kernel loads; its result is that frame's) and
    then captures it (``utils.graphs.GraphCall``: a ``SegmentedGraph`` over
    static copies of its inputs); every later call copies its inputs in
    (feats, pm and kmat only when they are other tensors than last time),
    replays and returns copies of the outputs.  A capture that fails
    raises.  ``warm_up_ms`` and ``capture_ms``: the first call's two parts
    by the host clock, each ending in a synchronize; ``graph``: the
    capture (``segments``, ``cuts``), None before it."""

    def __init__(self, config: SfmConfig, device: torch.device, plain: bool):
        self.config = config
        self.device = device
        self.plain = plain
        self.generator = torch.Generator(device=device)
        self.call: GraphCall | None = None
        self.warm_up_ms = self.capture_ms = None

    @property
    def graph(self) -> SegmentedGraph | None:
        return None if self.call is None else self.call.graph

    def _step(self, feats, pm, kmat, carry, t):
        carry, cost, _ = _steady_frame(self.generator, feats, pm, kmat, carry,
                                       t, self.config, self.plain)
        return carry, cost

    def __call__(self, feats, pm, kmat, carry, t):
        with span("sfm.steady_step", t=t):
            if self.device.type != "cuda":
                return self._step(feats, pm, kmat, carry, t)
            if self.call is None:
                return self._warm_up_and_capture(feats, pm, kmat, carry, t)
            return self.call((feats, pm, kmat, carry, t))

    def _warm_up_and_capture(self, *args):
        dev = self.device
        with allow_sync():
            torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        stream = capture_stream(dev)
        stream.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(stream):
            out = self._step(*args)
        torch.cuda.current_stream(dev).wait_stream(stream)
        with allow_sync():
            torch.cuda.synchronize(dev)
        t1 = time.perf_counter()
        self.call = GraphCall(self._step, args, generators=(self.generator,),
                              reuse=3)
        with allow_sync():
            torch.cuda.synchronize(dev)
        self.warm_up_ms = (t1 - t0) * 1e3
        self.capture_ms = (time.perf_counter() - t1) * 1e3
        return out


# The CUDA captures, one for each (configuration, frame count, device,
# plain): the configuration fixes the keypoint and track capacities, so
# every shape the step sees.  Process-wide, as a jit cache is: the robust
# run's restarts replay the first one's capture.
_STEADY_STEPS: dict = {}


def steady_step(config: SfmConfig, num_frames: int, device,
                plain: bool = False) -> _SteadyStep:
    """The fused steady step for a run of ``num_frames`` frames: a new
    eager one on the CPU, the cached capture on CUDA (shared by the
    configurations that differ only in fields the step does not read:
    ``fused_steady_steps``, ``read_free``, ``collect_diagnostics``)."""
    dev = torch.device(device)
    if dev.type != "cuda":
        return _SteadyStep(config, dev, plain)
    config = replace(config, fused_steady_steps=None, read_free=False,
                     collect_diagnostics=False)
    key = (config, num_frames, dev, plain)
    if key not in _STEADY_STEPS:
        _STEADY_STEPS[key] = _SteadyStep(config, dev, plain)
    return _STEADY_STEPS[key]


def _fit_frames(rs, ts, table: TrackTable, num_frames: int):
    """A resumed state over ``num_frames`` frames: a checkpoint of a shorter
    run gets identity poses and empty observation rows for the frames it
    has not seen (what the longer run holds there at the snapshot's
    frame)."""
    have = rs.shape[0]
    if have > num_frames:
        raise ValueError(f"checkpoint holds {have} frames, the sequence "
                         f"{num_frames}")
    if have == num_frames:
        return rs, ts, table
    more = num_frames - have
    dev = rs.device
    return (torch.cat([rs, torch.eye(3, dtype=rs.dtype, device=dev)
                       .repeat(more, 1, 1)]),
            torch.cat([ts, ts.new_zeros((more, 3))]),
            table._replace(
                obs=torch.cat([table.obs, table.obs.new_zeros(
                    (more, *table.obs.shape[1:]))]),
                obs_mask=torch.cat([table.obs_mask, table.obs_mask.new_zeros(
                    (more, table.obs_mask.shape[1]))])))


def _resume_kp_track(table: TrackTable, prev, done: int) -> TrackTable:
    """The resumed frame's keypoint -> track map, rebuilt by matching its
    keypoints to the stored observation row (nearest within 0.5 px)."""
    d = torch.linalg.vector_norm(prev.xy[:, None, :]
                                 - table.obs[done][None], dim=-1)
    d = torch.where(table.obs_mask[done][None, :], d, 1e9)
    nearest = torch.argmin(d, dim=1)
    ok = (torch.gather(d, 1, nearest[:, None])[:, 0] < 0.5) \
        & prev.points.mask
    return table._replace(
        kp_track=torch.where(ok, nearest, -1).to(torch.int32))


def _sequence_inputs(frames, k, config: SfmConfig, generator, dev, plain):
    """(K, the batched frontend's features, the precomputed matches or
    None, an empty track table, identity poses) for a run on ``dev``."""
    with span("sfm.frontend"):
        fc = config.frontend
        num_frames = len(frames)
        kmat = torch.as_tensor(np.asarray(k), dtype=torch.float32).to(dev)
        # a float32 tensor already on ``dev`` (the dewarp stage's output) is
        # used as it is: no host round trip, no second copy
        if not isinstance(frames, torch.Tensor):
            frames = np.asarray(frames)
        frames_t = torch.as_tensor(frames, dtype=torch.float32,
                                   device=dev).contiguous()
        octaves = max(1, config.pyramid_octaves)
        feats = precompute_frontend(frames_t, make_pairs(fc, device=dev),
                                    fc, chunk=config.frontend_chunk,
                                    octaves=octaves, plain=plain)
        pm = None
        if config.precompute_matching and num_frames >= 2:
            pm = precompute_matching(feats, fc, generator, num_frames,
                                     config.ransac_threshold,
                                     config.ransac_samples // 2,
                                     chunk=config.frontend_chunk, plain=plain)
        table = make_track_table(num_frames, config.track_capacity,
                                 fc.max_keypoints * octaves, device=dev)
        rs = torch.eye(3, device=dev).repeat(num_frames, 1, 1)
        ts = torch.zeros((num_frames, 3), device=dev)
        return kmat, feats, pm, table, rs, ts


def _bootstrap_displacement(table: TrackTable, t: int) -> float:
    """The median displacement (px) of the tracks frame 0 shares with
    frame t, 0 under 16 shared tracks: the adaptive bootstrap trigger's
    one host read."""
    with span("sfm.host_read"):
        both = table.obs_mask[0] & table.obs_mask[t]
        d = table.obs[t] - table.obs[0]
        return float(torch.where(
            both.sum() >= 16,
            nanmedian(torch.where(both, torch.sqrt((d * d).sum(-1)),
                                  torch.nan)),
            0.0))


def _final_ba(table: TrackTable, rs, ts, kmat, config: SfmConfig,
              plain: bool, costs: list):
    """The global BA rounds after the loop (camera 0 the gauge), each
    round after the first re-triangulating every track from the converged
    poses and pruning; each round's cost appended to ``costs``.  Returns
    (table, rs, ts)."""
    with span("sfm.final_ba"):
        if config.final_ba_iterations <= 0 or rs.shape[0] < 2:
            return table, rs, ts
        fixed = torch.ones((rs.shape[0],), device=rs.device)
        fixed[0] = 0.0
        for rnd in range(1 + max(0, config.final_refine_rounds)):
            if rnd > 0:
                table = _retriangulate_all(table, rs, ts, kmat,
                                           config.min_depth, config.max_depth)
                table = _prune_observations(table, rs, ts, kmat,
                                            config.prune_px)
            rs, ts, table, cost = _bundle_adjust_map(
                table, rs, ts, kmat, fixed, config.final_ba_iterations,
                config.mesh, plain)
            rs, ts, table = _rescale_gauge(rs, ts, table)
            costs.append(cost)
        return table, rs, ts


def run_incremental_sfm(frames, k, config: SfmConfig | None = None,
                        seed: int = 0, checkpoint_path: str | None = None,
                        checkpoint_every: int = 4, resume: bool = True,
                        export: bool = True, *, device="cuda",
                        plain: bool = False):
    """frames: (F, H, W) grayscale, a numpy array or a tensor on any device
    (one on ``device`` is not copied); k: (3, 3) intrinsics.

    Runs on ``device`` (default CUDA; raises without a card unless
    ``device='cpu'``).  ``plain=True`` runs the kernels' plain versions
    (FAST, BRIEF, Hamming, Schur) instead of the kernels, the reference
    run on the card.  With ``checkpoint_path`` the state snapshots every
    ``checkpoint_every`` frames and at the last one, and (``resume``) a run
    whose checkpoint exists resumes after its frame; a checkpoint of a
    shorter run is extended to this sequence.  ``export=False`` returns a
    ``DeviceSfmResult`` with no host read taken (it needs
    ``read_free=True``, ``collect_diagnostics=False`` and no checkpoint);
    ``export_sfm_result`` finishes it.
    """
    with span("sfm.sequence", frames=len(frames)):
        return _run(frames, k, config, seed, device, plain, checkpoint_path,
                    checkpoint_every, resume, export)


def _run(frames, k, config, seed, device, plain, checkpoint_path=None,
         checkpoint_every=4, resume=True, export=True, scan=False):
    """The SfM loop of both entries.  ``scan``: ``run_incremental_sfm_fused``'s
    run: every steady frame a step, labelled ``"scan"``; no diagnostics;
    the displacement read whatever ``read_free`` says, and not kept in
    the deferred frames' info; the bootstrap support read at once."""
    config = config or SfmConfig()
    if scan:
        if config.mesh is not None:
            raise ValueError("run_incremental_sfm_fused is single-device: "
                             "SfmConfig.mesh must be None")
        config = replace(config, fused_steady_steps=True,
                         collect_diagnostics=False, read_free=False)
    if not export and (not config.read_free or config.collect_diagnostics
                       or checkpoint_path):
        raise ValueError("export=False needs read_free=True, "
                         "collect_diagnostics=False and no checkpoint_path")
    dev = resolve_device(device)
    num_frames = len(frames)
    # fused_steady_steps None resolves to off, as in the JAX package
    step = (steady_step(config, num_frames, dev, plain)
            if config.fused_steady_steps else None)
    gen = step.generator if step is not None else torch.Generator(device=dev)
    gen.manual_seed(seed)
    kmat, feats, pm, table, rs, ts = _sequence_inputs(frames, k, config, gen,
                                                      dev, plain)
    frame_ids = torch.arange(num_frames, device=dev)
    costs = []
    frame_info = []
    start_frame = 1
    if checkpoint_path and resume and os.path.isfile(checkpoint_path):
        rs, ts, table, done, _ = load_checkpoint(checkpoint_path, device=dev)
        rs, ts, table = _fit_frames(rs, ts, table, num_frames)
        if done + 1 >= num_frames:
            return SfmResult(rs.cpu().numpy(), ts.cpu().numpy(), table,
                             costs, frame_info)
        start_frame = done + 1
        table = _resume_kp_track(table, frame_features(feats, done), done)
        map_ready = bool(table.has_point.any())
    else:
        first = frame_features(feats, 0)
        table = start_tracks(table, 0, first.xy, first.points.mask)
        map_ready = False

    def snapshot(t, table, rs, ts, cost):
        if checkpoint_path and (t % checkpoint_every == 0
                                or t == num_frames - 1):
            with span("sfm.checkpoint"):
                save_checkpoint(checkpoint_path, rs, ts, table, t, metadata={
                    "frame": t, "cost": None if cost is None
                    else float(cost)})

    kp_track_prev2 = None   # frame t-2 keypoint -> track id snapshot
    pending_support = None  # device scalar, read at export

    for t in range(start_frame, num_frames):
        t_dev = frame_ids[t]
        info = {"frame": t, "pose_init": "prior"}
        if map_ready:
            carry = (table, rs, ts, kp_track_prev2)
            if step is not None and t >= 2 and kp_track_prev2 is not None:
                (table, rs, ts, kp_track_prev2), cost = step(
                    feats, pm, kmat, carry, t_dev)
                costs.append(cost)
                frame_info.append({"frame": t, "pose_init":
                                   "scan" if scan else "fused_step"})
                continue
            (table, rs, ts, kp_track_prev), cost, diag = _steady_frame(
                gen, feats, pm, kmat, carry, t_dev, config, plain,
                config.collect_diagnostics, config.mesh)
            costs.append(cost)
            if config.collect_diagnostics:
                _read_diagnostics(info, *diag)
        else:
            table, kp_track_prev, diag = _track_frame(
                gen, feats, pm, frame_features(feats, t_dev), table,
                kp_track_prev2, t_dev, config, plain,
                config.collect_diagnostics)
            if config.collect_diagnostics:
                _read_diagnostics(info, diag)
            force = (t == num_frames - 1) or (t >= config.bootstrap_max_defer)
            trigger = force
            if not config.read_free:
                disp = _bootstrap_displacement(table, t)
                if not scan:
                    info["bootstrap_disp_px"] = round(disp, 1)
                trigger = disp >= config.bootstrap_min_disp_px or force
            if not trigger:
                info.update(pose_init="deferred")
                frame_info.append(info)
                kp_track_prev2 = kp_track_prev
                # deferred frames keep the cadence too: a crash in the
                # poseless phase resumes mid-deferral
                snapshot(t, table, rs, ts, None)
                continue
            rs, ts, table, support = _bootstrap_map(
                gen, table, rs, ts, kmat, config, t, num_frames, plain)
            map_ready = True
            info.update(pose_init="bootstrap", bootstrap_pair=(0, t))
            if scan:
                info["bootstrap_support"] = int(support)
            else:
                pending_support = (info, support)
            table, rs, ts, cost = _map_frame(table, rs, ts, kmat, t_dev,
                                             config, plain, config.mesh)
            costs.append(cost)
        frame_info.append(info)
        kp_track_prev2 = kp_track_prev
        snapshot(t, table, rs, ts, costs[-1])

    table, rs, ts = _final_ba(table, rs, ts, kmat, config, plain, costs)
    result = DeviceSfmResult(rs=rs, ts=ts, table=table, costs=costs,
                             frame_info=frame_info,
                             pending_support=pending_support)
    return export_sfm_result(result) if export else result


def reconstruction_quality(res: SfmResult, k, err_px: float = 2.0,
                           min_depth: float = 0.1):
    """(support, median reprojection error px) of a finished reconstruction:
    support = tracks observed within ``err_px`` at positive depth on >= 2
    frames; the median (JAX semantics) is over all valid observations."""
    t = res.table
    dev = t.points.device
    kmat, rs, ts = (torch.tensor(np.asarray(x), dtype=torch.float32,
                                 device=dev) for x in (k, res.rs, res.ts))
    pred, z, _ = project(rs, ts, t.points, kmat)
    d = pred - t.obs
    err = torch.sqrt((d * d).sum(-1))
    m = t.obs_mask & t.has_point[None, :]
    ok = m & (err < err_px) & (z > min_depth)
    support = int(((ok.sum(0)) >= 2).sum())
    med = float(nanmedian(torch.where(m, err, torch.nan)))
    return support, med


def run_incremental_sfm_robust(frames, k, config: SfmConfig | None = None,
                               seed: int = 0, restarts: int = 3,
                               target_med_px: float | None = None,
                               max_restarts: int = 8,
                               **kwargs) -> SfmResult:
    """Best-of-``restarts`` incremental SfM (seeds seed + 7919 i), chosen
    without ground truth by ``reconstruction_quality``: support first,
    the median reprojection error among candidates within 5% of the best
    support.  ``target_med_px`` keeps drawing (up to ``max_restarts``)
    while no candidate reaches that median.  ``kwargs`` go to
    ``run_incremental_sfm`` (``device``, ``plain``)."""
    candidates = []
    i = 0
    while True:
        res = run_incremental_sfm(frames, k, config, seed=seed + 7919 * i,
                                  **kwargs)
        support, med = reconstruction_quality(res, k)
        res.quality = (support, med)
        candidates.append((support, med, res))
        i += 1
        if i < max(1, restarts):
            continue
        if (target_med_px is not None and i < max_restarts
                and min(c[1] for c in candidates) > target_med_px):
            continue
        break
    smax = max(c[0] for c in candidates)
    best = min((c for c in candidates if c[0] >= 0.95 * smax),
               key=lambda c: c[1])
    return best[2]


def run_incremental_sfm_fused(frames, k, config: SfmConfig | None = None,
                              seed: int = 0, *, device="cuda",
                              plain: bool = False) -> SfmResult:
    """Incremental SfM with every frame after the bootstrap run by the
    fused steady step (``pose_init="scan"``), with no host read between
    them; the same bits as ``run_incremental_sfm`` with the same seed.

    ``run_incremental_sfm``'s loop with the step on: the deferral reads
    each deferred frame's displacement whatever ``read_free`` says, and
    the bootstrap frame's info holds its support, read at the bootstrap.
    No checkpoint and no diagnostics in this mode; needs ``mesh=None``.
    ``device`` and ``plain`` as for ``run_incremental_sfm``.
    """
    with span("sfm.sequence", frames=len(frames)):
        return _run(frames, k, config, seed, device, plain, scan=True)
