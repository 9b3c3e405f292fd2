#!/usr/bin/env python3
"""Whether a failed submap stitch belongs to the port or to its input: the
same submap runs in the port and in the JAX package, on the CPU, from the
repository root (both packages importable):

    python3 experiments/submap_stitch/run.py [--seeds 0 1 2] \\
        [--size 240 320] [--focal 260] [--pairs port|jax] [--window I]

The sequence is ``chip_smoke.py``'s submaps phase at a reduced size: the
12-frame star-scene pan traversed out and back (23 frames, frame j the same
as frame 22 - j), windows of 12 frames sharing 4 (spans (0, 12), (8, 20),
(16, 23)), ``run_sfm``'s configuration.  For each seed it prints one JSON
line:

- ``port`` and ``jax``: ``run_submap_sfm`` (best of 3 restarts a window,
  the seam pose graph, no global refine) in each package with its own
  draws: each window's ATE against the ground truth of its frames, the
  yaw between its first and last camera beside the ground truth's (the
  ATE of camera centres alone cannot tell a window from its mirror image,
  which turns the other way), and the stitched trajectory's ATE;
- ``jax_on_port_windows``: the JAX package's ``run_submap_sfm`` handed the
  port's window results (its robust SfM patched), so that both stitch the
  same windows: the stitched ATE and the largest pose difference from the
  port's stitch, with and without the seam pose graph.

``--pairs jax`` gives the port the JAX package's BRIEF pair table as
JAX draws it; the port's ``make_pairs`` now draws the same table, so
the two choices agree.  ``--window I``
prints instead, for each seed, one ``run_incremental_sfm`` on window I's
frames in each package: the yaw from its first camera to its last beside
the truth's, and ``reconstruction_quality`` (support, median px), by
which ``run_incremental_sfm_robust`` ranks restarts and against which it
holds its 0.5-px target.
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path
from types import SimpleNamespace

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

SUBMAP_FRAMES, OVERLAP = 12, 4


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--seeds", type=int, nargs="+", default=[0, 1, 2])
    ap.add_argument("--size", type=int, nargs=2, default=[240, 320])
    ap.add_argument("--focal", type=float, default=260.0)
    ap.add_argument("--pairs", choices=("port", "jax"), default="port")
    ap.add_argument("--window", type=int, default=None)
    args = ap.parse_args(argv)

    import jax

    jax.config.update("jax_platforms", "cpu")
    import numpy as np
    import torch

    from photogrammetry_tpu.sfm import frontend as jfront
    from photogrammetry_tpu.sfm import incremental as jinc
    from photogrammetry_tpu.sfm import submaps as jsub
    from photogrammetry_tpu.sfm.frontend import (
        FrontendConfig as JFrontendConfig,
    )
    from photogrammetry_tpu_torch.sfm import incremental as inc
    from photogrammetry_tpu_torch.sfm import submaps as sub
    from photogrammetry_tpu_torch.sfm.frontend import FrontendConfig
    from photogrammetry_tpu_torch.sfm.incremental import SfmConfig
    from photogrammetry_tpu_torch.sfm.metrics import trajectory_ate
    from photogrammetry_tpu_torch.synth.star_scene import (
        StarSceneConfig, intrinsics, pan_trajectory, render_frame,
    )

    torch.set_num_threads(4)
    scene = StarSceneConfig(num_frames=12, image_size=tuple(args.size),
                            focal=args.focal)
    rs, ts, centers = pan_trajectory(scene)
    k = intrinsics(scene)
    pan = np.stack([render_frame(scene, rs[i], ts[i], k)
                    for i in range(12)]).astype(np.float32)
    frames = np.concatenate([pan, pan[-2::-1]])
    gt = np.concatenate([centers, centers[-2::-1]])
    # run_sfm's configuration in each package
    front = dict(detection_threshold=20.0, max_keypoints=512,
                 reduction="nms", suppression_radius=4.0,
                 hamming_threshold=80)
    cfg = SfmConfig(frontend=FrontendConfig(**front),
                    collect_diagnostics=False)
    jcfg = jinc.SfmConfig(frontend=JFrontendConfig(**front),
                          collect_diagnostics=False)

    if args.pairs == "jax":
        table = torch.as_tensor(np.asarray(jfront.make_pairs(jcfg.frontend)))
        inc.make_pairs = lambda config, device="cpu": table.to(device)
    rs_gt = np.concatenate([rs, rs[-2::-1]])

    def yaw_deg(r_first, r_last):
        rel = np.asarray(r_last, np.float64) @ np.asarray(r_first,
                                                          np.float64).T
        return float(np.degrees(np.arctan2(rel[0, 2], rel[0, 0])))

    if args.window is not None:
        a, b = sub.submap_spans(len(frames), SUBMAP_FRAMES,
                                OVERLAP)[args.window]
        for seed in args.seeds:
            port = inc.run_incremental_sfm(frames[a:b], k, cfg, seed=seed,
                                           device="cpu")
            ref = jinc.run_incremental_sfm(frames[a:b], k, jcfg, seed=seed)
            print(json.dumps({
                "seed": seed, "size": args.size, "pairs": args.pairs,
                "window": [a, b], "yaw_deg_true": yaw_deg(rs_gt[a],
                                                          rs_gt[b - 1]),
                "port": dict(yaw_deg=yaw_deg(port.rs[0], port.rs[-1]),
                             quality=inc.reconstruction_quality(port, k)),
                "jax": dict(yaw_deg=yaw_deg(ref.rs[0], ref.rs[-1]),
                            quality=[float(x) for x in
                                     jinc.reconstruction_quality(ref, k)])}),
                flush=True)
        return 0

    def windows(res):
        return dict(
            windows_ate=[trajectory_ate(w.rs, w.ts, gt[a:b])
                         for w, (a, b) in zip(res.submaps, res.spans)],
            windows_yaw_deg=[yaw_deg(w.rs[0], w.rs[-1])
                             for w in res.submaps],
            windows_yaw_deg_true=[yaw_deg(rs_gt[a], rs_gt[b - 1])
                                  for a, b in res.spans])

    for seed in args.seeds:
        port = sub.run_submap_sfm(frames, k, cfg, SUBMAP_FRAMES, OVERLAP,
                                  seed=seed, device="cpu")
        ref = jsub.run_submap_sfm(frames, k, jcfg, SUBMAP_FRAMES, OVERLAP,
                                  seed=seed)
        # the port's windows as numpy, in the shape the JAX stitch reads
        given = [SimpleNamespace(
            rs=np.asarray(w.rs), ts=np.asarray(w.ts),
            points=np.asarray(w.points), quality=w.quality,
            table=SimpleNamespace(obs=w.table.obs.numpy(),
                                  obs_mask=w.table.obs_mask.numpy(),
                                  num_tracks=np.int32(int(w.table.num_tracks)),
                                  dropped=np.int32(int(w.table.dropped))))
            for w in port.submaps]
        robust, port_robust = (jsub.run_incremental_sfm_robust,
                               sub.run_incremental_sfm_robust)
        jsub.run_incremental_sfm_robust = \
            lambda f, *a, seed=0, **kw: given[seed - seed0]
        sub.run_incremental_sfm_robust = \
            lambda f, *a, seed=0, **kw: port.submaps[seed - seed0]
        seed0 = seed
        cross = {}
        try:
            for pg in (0, 15):
                mine, theirs = (
                    run(frames, k, c, SUBMAP_FRAMES, OVERLAP, seed=seed,
                        pose_graph_iterations=pg, **kw)
                    for run, c, kw in ((sub.run_submap_sfm, cfg,
                                        {"device": "cpu"}),
                                       (jsub.run_submap_sfm, jcfg, {})))
                cross[f"pose_graph_{pg}"] = dict(
                    ate=trajectory_ate(theirs.rs, theirs.ts, gt),
                    port_ate=trajectory_ate(mine.rs, mine.ts, gt),
                    max_abs_diff=max(
                        float(np.abs(np.asarray(theirs.rs) - mine.rs).max()),
                        float(np.abs(np.asarray(theirs.ts) - mine.ts).max())))
        finally:
            jsub.run_incremental_sfm_robust = robust
            sub.run_incremental_sfm_robust = port_robust
        print(json.dumps({
            "seed": seed, "size": args.size, "pairs": args.pairs,
            "spans": port.spans,
            "port": dict(**windows(port),
                         ate=trajectory_ate(port.rs, port.ts, gt)),
            "jax": dict(**windows(ref),
                        ate=trajectory_ate(ref.rs, ref.ts, gt)),
            "jax_on_port_windows": cross}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
