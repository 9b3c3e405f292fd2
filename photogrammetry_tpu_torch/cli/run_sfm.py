"""Run incremental SfM over an image sequence; export trajectory + cloud
(port of photogrammetry_tpu/cli/run_sfm.py).

    python -m photogrammetry_tpu_torch.cli.run_sfm [FRAMES_DIR] \\
        [--synthetic-frames 8] [--restarts 3] [--device cuda] \\
        [--distortion-coeffs K1 K2 K3 K4 K5] [--dewarp-cache DIR] \\
        [--oriented-brief] [--pyramid-octaves N] [--precompute-matching] \\
        [--checkpoint PATH [--no-resume]] \\
        [--keyframe-disp PX | --submap-frames N [--submap-overlap N] ...] \\
        [--loop-closure [--loop-mode revisit] [--loop-min-gap N] ...] \\
        [--mesh N]

A directory of frames (sorted), or the built-in synthetic star pan with
exact ground truth for an ATE report → (with ``--distortion-coeffs``) the
lens dewarp of every frame, ``dewarp_frames`` → ``run_incremental_sfm``
(or its best-of-``--restarts`` form; with ``--checkpoint`` a snapshotted
run that resumes from the file; with ``--keyframe-disp`` the map from
displacement-gated keyframes and every other frame localized against it;
with ``--submap-frames`` overlapping submaps stitched by similarities, a
seam pose graph and ``--submap-refine`` rounds of cross-seam global BA) →
(with ``--loop-closure``) place recognition over every frame pair,
loop-edge measurement and the pose-graph correction, then the landmarks
re-triangulated under the corrected poses (submaps: the cross-seam global
BA runs after it instead, with the loop matches fused into its tracks) →
``cloud.ply`` + ``trajectory.json`` and one JSON report line;
``--oriented-brief`` steers the BRIEF pairs by each keypoint's
orientation, ``--pyramid-octaves`` detects and describes on power-of-two
octaves.  ``--mesh N`` shards the windowed and final BA's landmarks over a
world of N ranks (``parallel/``): on ``cuda`` one rank a card over NCCL,
with ``--device cpu`` N gloo processes; the CLI spawns them, or joins the
world a launcher such as ``torchrun`` set up (``WORLD_SIZE``).  Every rank
runs the whole pipeline (SPMD) and rank 0 writes the outputs.
``--precompute-matching`` matches and gates every (t, t-1) and (t, t-2)
frame pair before the loop, a chunk of pairs a batched Hamming launch.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
from types import SimpleNamespace

from photogrammetry_tpu_torch.cli.common import load_gray

LOOP_SEED = 7   # the loop-edge measurement's draws (JAX: PRNGKey(7))
LINK_SEED = 11  # the loop links' epipolar gate (JAX: PRNGKey(11))


def dewarp_frames(frames, coeffs, cache_dir: str, device="cuda",
                  plain: bool = False):
    """The dewarp stage in front of incremental SfM: (F, H, W) frames (numpy
    or tensor) → the float32 tensor of dewarped frames on ``device``.

    The distortion map comes from ``DistortionMapCache(cache_dir)``
    (generated on ``device`` when absent), the stacked frames are uploaded
    once and remapped in one launch of the remap kernel (``plain=True``: the
    plain PyTorch remap), and the result stays on the device for
    ``run_incremental_sfm``.  Spans (``utils.profiling``):
    ``dewarp.map_load``, ``dewarp.map_upload``, ``dewarp.frames_upload``
    and ``dewarp.remap``.
    """
    import torch

    from photogrammetry_tpu_torch import resolve_device
    from photogrammetry_tpu_torch.ops.dewarp import make_distortion_applier
    from photogrammetry_tpu_torch.store.cache import DistortionMapCache
    from photogrammetry_tpu_torch.utils.profiling import span

    dev = resolve_device(device)
    h, w = frames.shape[1:3]
    with span("dewarp.map_load"):
        dmap = DistortionMapCache(cache_dir).get_or_generate(h, w, coeffs,
                                                             device=dev)
    with span("dewarp.map_upload"):
        apply = make_distortion_applier(dmap, (h, w), device=dev,
                                        plain=plain)
    with span("dewarp.frames_upload"):
        stacked = torch.as_tensor(frames).to(device=dev, dtype=torch.float32)
    with span("dewarp.remap"):
        return apply(stacked)


def loop_links(feats, edges, cfg, device):
    """The gated matches of each accepted loop edge as (fa, xy_a, fb,
    xy_b) links for the cross-seam global BA: the mutual matches of the
    edge's frames that pass a RANSAC-F gate of ``ransac_samples // 2``
    hypotheses, drawn edge after edge from a generator seeded
    ``LINK_SEED``."""
    import numpy as np
    import torch

    from photogrammetry_tpu_torch.sfm.epipolar import (
        draw_samples, ransac_fundamental,
    )
    from photogrammetry_tpu_torch.sfm.frontend import match_pair

    gen = torch.Generator(device=device).manual_seed(LINK_SEED)
    links = []
    for fa, fb in edges:
        m = match_pair(feats[fa], feats[fb], cfg.frontend)
        gate = ransac_fundamental(
            draw_samples(gen, m.mask, cfg.ransac_samples // 2, 8), m.xy1,
            m.xy2, m.mask, cfg.ransac_threshold)
        good = (m.mask & gate.inliers).cpu().numpy()
        xy1, xy2 = m.xy1.cpu().numpy(), m.xy2.cpu().numpy()
        links += [(fa, tuple(xy1[i]), fb, tuple(xy2[i]))
                  for i in np.nonzero(good)[0]]
    return links


def close_loops_stage(frames, res, k, cfg, device, *, mode="rotation",
                      min_gap=None, min_matches=30, max_edges=8,
                      submap_refine=2, submap_prior_weight=100.0):
    """The ``--loop-closure`` stage after the SfM run: the frames' features
    (one batched single-scale frontend pass), ``close_loops`` on the run's
    trajectory, then, where the run has one track table (the plain and
    keyframe modes, the latter under its keyframes' poses), every landmark
    re-triangulated under the corrected poses with the run's depth gate (a
    track whose re-triangulation fails in an observing view leaves the
    map).  Submap runs have a table a window instead: with
    ``submap_refine`` > 0 the cross-seam global BA runs on the loop-closed
    trajectory, the loop edges' gated matches fused into its tracks, at
    ``submap_prior_weight``.

    The settings are the CLI's ``--loop-*`` and ``--submap-*`` flags, with
    their defaults: ``mode`` the loop-edge measurement, ``min_gap`` the
    least frame separation of a candidate (None: max(5, F // 4)),
    ``min_matches`` the match count a candidate needs (and the support an
    edge needs), ``max_edges`` the candidates measured at most.

    Updates ``res`` in place; returns (the report's ``loop_closure`` entry,
    ``close_loops``' info: the (F, F) ``counts``, the accepted
    ``loop_edges``, their ``inliers`` (support) and ``measurements`` (on
    the device), the ``rejected_edges`` and, where a graph was solved,
    the pose graph's ``cost`` and ``initial_cost``).  Spans
    (``utils.profiling``): ``sfm.loop`` over the stage, ``loop.features``
    and ``loop.retriangulate``; ``close_loops`` records the rest."""
    import numpy as np
    import torch

    from photogrammetry_tpu_torch.sfm.frontend import (
        frame_features, make_pairs, precompute_frontend,
    )
    from photogrammetry_tpu_torch.sfm.incremental import _depth_ok
    from photogrammetry_tpu_torch.sfm.loop_closure import close_loops
    from photogrammetry_tpu_torch.sfm.submaps import refine_submaps_global
    from photogrammetry_tpu_torch.sfm.triangulate import triangulate_nview
    from photogrammetry_tpu_torch.utils.profiling import span

    num = len(frames)
    if min_gap is None:
        min_gap = max(5, num // 4)
    with span("sfm.loop", frames=num):
        with span("loop.features"):
            stacked = precompute_frontend(
                torch.as_tensor(np.asarray(frames) if not isinstance(
                    frames, torch.Tensor) else frames, dtype=torch.float32,
                    device=device), make_pairs(cfg.frontend, device=device),
                cfg.frontend, chunk=cfg.frontend_chunk)
            feats = [frame_features(stacked, t) for t in range(num)]
        kmat = torch.as_tensor(np.asarray(k), dtype=torch.float32,
                               device=device)
        gen = torch.Generator(device=device).manual_seed(LOOP_SEED)
        rs_lc, ts_lc, info = close_loops(
            feats, torch.as_tensor(res.rs, device=device),
            torch.as_tensor(res.ts, device=device), kmat, cfg.frontend,
            generator=gen, min_gap=min_gap, min_matches=min_matches,
            mode=mode, max_candidates=max_edges)
        rs_lc = torch.as_tensor(rs_lc, dtype=torch.float32, device=device)
        ts_lc = torch.as_tensor(ts_lc, dtype=torch.float32, device=device)
        report = {"loop_edges": [list(p) for p in info["loop_edges"]],
                  "rejected_edges": len(info.get("rejected_edges", []))}
        table = getattr(res, "table", None)
        if table is not None:
            with span("loop.retriangulate"):
                # keyframe mode: the table's rows are the keyframes
                rows = torch.as_tensor(getattr(res, "keyframes",
                                               range(num)), device=device)
                pts, depths = triangulate_nview(table.obs, table.obs_mask,
                                                rs_lc[rows], ts_lc[rows],
                                                kmat)
                has = table.has_point & _depth_ok(
                    table.obs_mask, depths, cfg.min_depth, cfg.max_depth)
                res.table = table._replace(
                    points=torch.where(has[:, None], pts, table.points),
                    has_point=has)
        res.rs, res.ts = rs_lc.cpu().numpy(), ts_lc.cpu().numpy()
        if getattr(res, "submaps", None) is not None and submap_refine > 0:
            res.rs, res.ts, res.points = refine_submaps_global(
                res.rs, res.ts, res.submaps, res.spans, k, num,
                rounds=submap_refine,
                iterations=cfg.final_ba_iterations or 20,
                prune_px=cfg.prune_px, min_depth=cfg.min_depth,
                max_depth=cfg.max_depth,
                loop_links=loop_links(feats, info["loop_edges"], cfg,
                                      device),
                prior_weight=submap_prior_weight, device=device)
    return report, info


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("frames", nargs="?", default=None,
                    help="directory of image frames; omit for the synthetic "
                         "star-pan sequence")
    ap.add_argument("--synthetic-frames", type=int, default=8)
    ap.add_argument("--fx", type=float, default=None)
    ap.add_argument("--cx", type=float, default=None)
    ap.add_argument("--cy", type=float, default=None)
    ap.add_argument("--detection-threshold", type=float, default=20.0)
    ap.add_argument("--oriented-brief", action="store_true",
                    help="steered (rotation-invariant) BRIEF descriptors "
                         "in the tracking frontend (ops/brief.py)")
    ap.add_argument("--pyramid-octaves", type=int, default=1,
                    help=">1 runs the multi-scale pyramid frontend "
                         "(tracking across up to ~2^(octaves-1) of "
                         "apparent-scale change; keypoint and track "
                         "capacity scale with octaves)")
    ap.add_argument("--precompute-matching", action="store_true",
                    help="batched sequence-level matching+gating precompute "
                         "(a chunk of frame pairs a batched Hamming launch "
                         "where the default loop matches pair by pair; "
                         "RANSAC seed streams differ from the default "
                         "sequential draws)")
    ap.add_argument("--frame-stride", type=int, default=1,
                    help="temporal subsampling: keep every Nth frame")
    ap.add_argument("--distortion-coeffs", type=float, nargs=5, default=None,
                    metavar=("K1", "K2", "K3", "K4", "K5"),
                    help="dewarp every frame of FRAMES_DIR with this "
                         "rational radial model before detection (the "
                         "reference's live pipeline order: read -> dewarp "
                         "-> gray -> detect); all zero = no dewarp")
    ap.add_argument("--dewarp-cache", default="data/distortion_maps",
                    help="distortion-map cache dir (with "
                         "--distortion-coeffs)")
    ap.add_argument("--cloud", default="cloud.ply")
    ap.add_argument("--trajectory", default="trajectory.json")
    ap.add_argument("--stats", default=None)
    ap.add_argument("--diagnostics", action="store_true",
                    help="collect per-frame diagnostic counters (one host "
                         "read each)")
    ap.add_argument("--restarts", type=int, default=1,
                    help=">1 runs best-of-K restarts with ground-truth-free "
                         "quality selection")
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; 'cpu' runs the plain "
                         "PyTorch path)")
    ap.add_argument("--checkpoint", default=None,
                    help="snapshot path; reruns resume from the last "
                         "snapshot (store/checkpoint.py)")
    ap.add_argument("--no-resume", action="store_true",
                    help="ignore an existing checkpoint and start fresh")
    ap.add_argument("--loop-closure", action="store_true",
                    help="detect loop closures (place recognition over "
                         "every frame pair) and optimize the pose graph "
                         "after SfM")
    ap.add_argument("--loop-min-gap", type=int, default=None,
                    help="minimum frame separation for a loop candidate; "
                         "default max(5, F//4)")
    ap.add_argument("--loop-min-matches", type=int, default=30)
    ap.add_argument("--loop-max-edges", type=int, default=8,
                    help="max accepted loop edges")
    ap.add_argument("--loop-mode", default="rotation",
                    choices=("rotation", "essential", "revisit",
                             "revisit_sim3"),
                    help="loop-edge measurement: 'rotation' constrains "
                         "orientation only; 'essential' a full relative "
                         "pose at the current baseline; 'revisit' a "
                         "zero-baseline edge that pins revisit centers "
                         "together; 'revisit_sim3' also measures the "
                         "relative scale at each revisit and optimizes a "
                         "Sim(3) pose graph")
    ap.add_argument("--keyframe-disp", type=float, default=0.0,
                    help=">0 builds the map from displacement-gated "
                         "keyframes only (a new keyframe every N px of "
                         "median feature motion) and localizes every "
                         "skipped frame against it (sfm/keyframes.py)")
    ap.add_argument("--submap-frames", type=int, default=0,
                    help=">0 chains overlapping submaps of this many "
                         "frames (sfm/submaps.py): track capacity scales "
                         "with sequence length instead of one fixed table")
    ap.add_argument("--submap-overlap", type=int, default=4)
    ap.add_argument("--submap-prior-weight", type=float, default=100.0,
                    help="trajectory-anchor weight of the cross-seam "
                         "global BA that runs after loop closure (0 = pure "
                         "reprojection); without --loop-closure the "
                         "refine keeps refine_submaps_global's default "
                         "300, as the JAX CLI does")
    ap.add_argument("--submap-refine", type=int, default=2,
                    help="cross-seam global refinement rounds after the "
                         "pose graph (0 disables; with --loop-closure "
                         "they run after it)")
    ap.add_argument("--mesh", type=int, default=0,
                    help=">0 shards the windowed and final BA's landmarks "
                         "over a world of N ranks: one a card over NCCL on "
                         "cuda, N gloo processes with --device cpu")
    args = ap.parse_args(argv)
    if args.restarts > 1 and args.checkpoint:
        ap.error("--restarts and --checkpoint conflict: restart selection "
                 "re-runs from scratch and cannot resume a snapshot")
    if args.checkpoint and args.mesh > 1:
        ap.error("--checkpoint and --mesh > 1 conflict: every rank would "
                 "write the one snapshot file")
    if args.checkpoint and (args.keyframe_disp > 0 or args.submap_frames > 0):
        ap.error("--checkpoint is only supported in the plain incremental "
                 "mode: --keyframe-disp and --submap-frames runs take no "
                 "snapshots (their state spans multiple sub-reconstructions)")

    import torch
    import torch.distributed as dist

    from photogrammetry_tpu_torch import resolve_device
    from photogrammetry_tpu_torch.parallel.mesh import (
        default_backend, init_world, make_mesh, mesh_device,
    )
    from photogrammetry_tpu_torch.parallel.multihost import run_world

    device = resolve_device(args.device)     # fail before loading frames
    if args.mesh <= 0:
        return _run(args, ap, device, None)
    if device.type == "cuda" and args.mesh > torch.cuda.device_count():
        ap.error(f"--mesh {args.mesh} needs {args.mesh} devices; only "
                 f"{torch.cuda.device_count()} visible")
    backend = default_backend(device.type)
    own = not dist.is_initialized()
    if own and args.mesh > 1 and "WORLD_SIZE" not in os.environ:
        # the ranks, spawned here; each re-enters main in its world
        argv = sys.argv[1:] if argv is None else list(argv)
        run_world(_mesh_rank, args.mesh, (argv,), backend=backend,
                  timeout=None, threads=1 if device.type == "cpu" else None)
        return 0
    if own:     # under a launcher, or a world of one
        init_world(backend)
    try:
        if dist.get_world_size() != args.mesh:
            ap.error(f"--mesh {args.mesh} in a world of "
                     f"{dist.get_world_size()} ranks")
        mesh = make_mesh(device_type=device.type)
        return _run(args, ap, mesh_device(mesh), mesh)
    finally:
        if own:
            dist.destroy_process_group()


def _mesh_rank(rank: int, argv: list) -> int:
    """One rank of a spawned ``--mesh`` world: the CLI in its world."""
    return main(argv)


def _run(args, ap, device, mesh) -> int:
    """``_pipeline``; with ``--stats`` under ``utils.profiling``'s
    recording, so that the stats record gains the run's ``spans``
    (``span_summary``) and ``counters`` (``read_counters``)."""
    if not args.stats:
        return _pipeline(args, ap, device, mesh)
    from photogrammetry_tpu_torch.utils import profiling

    profiling.clear()
    with profiling.recording():
        return _pipeline(args, ap, device, mesh)


def _pipeline(args, ap, device, mesh) -> int:
    """The pipeline on ``device``; with ``mesh`` one rank of it, and rank 0
    writes the cloud, the trajectory, the report and the stats."""
    import numpy as np
    import torch

    from photogrammetry_tpu_torch.io.ply import write_ply
    from photogrammetry_tpu_torch.sfm.frontend import FrontendConfig
    from photogrammetry_tpu_torch.sfm.incremental import (
        SfmConfig, reconstruction_quality, run_incremental_sfm,
        run_incremental_sfm_robust,
    )
    from photogrammetry_tpu_torch.sfm.metrics import (
        absolute_trajectory_error,
    )
    from photogrammetry_tpu_torch.utils.profiling import (
        StageTimer, append_stats, read_counters, span_summary,
    )

    writer = mesh is None or mesh.get_rank() == 0
    timer = StageTimer()
    gt_centers = None
    if args.frames is None:
        from photogrammetry_tpu_torch.synth.star_scene import (
            StarSceneConfig, generate_sequence,
        )
        scene = generate_sequence(StarSceneConfig(
            num_frames=args.synthetic_frames, supersample=4))
        frames, k, gt_centers = scene["frames"], scene["k"], scene["centers"]
    else:
        import glob
        import os

        paths = sorted(glob.glob(os.path.join(args.frames, "*")))
        if args.frame_stride > 1:
            paths = paths[::args.frame_stride]
        if len(paths) < 2:
            ap.error(f"need >= 2 frames in {args.frames} "
                     f"(after stride {args.frame_stride})")
        frames = np.stack([load_gray(p) for p in paths])
        h, w = frames.shape[1:3]
        if args.distortion_coeffs is not None and any(args.distortion_coeffs):
            with timer.stage("dewarp"):
                frames = timer.block(dewarp_frames(
                    frames, args.distortion_coeffs, args.dewarp_cache,
                    device))
        fx = args.fx if args.fx is not None else 1.2 * w
        if fx <= 0:
            ap.error(f"--fx must be positive, got {fx}")
        cx = args.cx if args.cx is not None else w / 2
        cy = args.cy if args.cy is not None else h / 2
        k = np.array([[fx, 0, cx], [0, fx, cy], [0, 0, 1]], np.float32)

    octaves = max(1, args.pyramid_octaves)
    cfg = SfmConfig(frontend=FrontendConfig(
        detection_threshold=args.detection_threshold, max_keypoints=512,
        reduction="nms", suppression_radius=4.0, hamming_threshold=80,
        oriented_brief=bool(args.oriented_brief)),
        pyramid_octaves=octaves,
        precompute_matching=bool(args.precompute_matching),
        # headroom for the octave-merged keypoint sets
        track_capacity=1024 * octaves,
        collect_diagnostics=bool(args.diagnostics), mesh=mesh)
    with timer.stage("sfm"):
        if args.keyframe_disp > 0:
            from photogrammetry_tpu_torch.sfm.keyframes import (
                run_keyframed_sfm,
            )

            rs_kf, ts_kf, kf_idx, res, _ = run_keyframed_sfm(
                frames, k, cfg, min_disp_px=args.keyframe_disp,
                restarts=max(1, args.restarts), device=device)
            # the full per-frame trajectory replaces the keyframe-only one
            res.rs, res.ts = rs_kf, ts_kf
            res.keyframes = kf_idx
        elif args.submap_frames > 0:
            from photogrammetry_tpu_torch.sfm.submaps import run_submap_sfm

            # with loop closure the cross-seam global BA waits for the
            # loop-closed trajectory (close_loops_stage)
            res = run_submap_sfm(
                frames, k, cfg, submap_frames=args.submap_frames,
                overlap=args.submap_overlap, restarts=max(1, args.restarts),
                global_refine_rounds=(0 if args.loop_closure
                                      else args.submap_refine),
                device=device)
        elif args.restarts > 1:
            res = run_incremental_sfm_robust(frames, k, cfg,
                                             restarts=args.restarts,
                                             device=device)
        else:
            res = run_incremental_sfm(frames, k, cfg, device=device,
                                      checkpoint_path=args.checkpoint,
                                      resume=not args.no_resume)
    loop_report = None
    if args.loop_closure:
        with timer.stage("loop_closure"):
            loop_report, _ = close_loops_stage(
                frames, res, k, cfg, device, mode=args.loop_mode,
                min_gap=args.loop_min_gap,
                min_matches=args.loop_min_matches,
                max_edges=args.loop_max_edges,
                submap_refine=args.submap_refine,
                submap_prior_weight=args.submap_prior_weight)

    if not writer:
        return 0
    write_ply(args.cloud, res.points)
    centers = res.camera_centers
    traj = {"centers": centers.tolist(), "rotations": res.rs.tolist(),
            "translations": res.ts.tolist()}
    costs = getattr(res, "costs", None)
    report = {"frames": len(frames), "landmarks": len(res.points),
              "final_cost": costs[-1] if costs else None,
              "timings": timer.summary()}
    # ground-truth-free quality (support, median reprojection error px),
    # where one table holds the run: in keyframe mode its rows are the
    # keyframes
    table = getattr(res, "table", None)
    if table is not None:
        rows = list(getattr(res, "keyframes", range(len(res.rs))))
        support, med = reconstruction_quality(
            SimpleNamespace(rs=res.rs[rows], ts=res.ts[rows], table=table),
            k)
        report["quality"] = {"support": support,
                             "median_reproj_px": round(med, 3)}
    if hasattr(res, "spans"):
        report["submaps"] = {"spans": [list(sp) for sp in res.spans],
                             "total_tracks": res.total_tracks,
                             "dropped": res.dropped}
    if hasattr(res, "keyframes"):
        report["keyframes"] = list(res.keyframes)
    if loop_report is not None:
        report["loop_closure"] = loop_report
    if gt_centers is not None:
        report["ate"] = float(absolute_trajectory_error(
            torch.tensor(centers, dtype=torch.float64),
            torch.tensor(gt_centers, dtype=torch.float64)))
    with open(args.trajectory, "w") as fh:
        json.dump(traj, fh)
    print(json.dumps(report))
    print(f"wrote {args.cloud}, {args.trajectory}")
    if args.stats:
        append_stats(args.stats, {**report, "spans": span_summary(),
                                  "counters": read_counters()})
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
