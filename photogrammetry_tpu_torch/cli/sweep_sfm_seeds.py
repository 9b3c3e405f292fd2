"""Across-seed ATE sweep of the port's incremental SfM (port of
scripts/sweep_sfm_seeds.py).

The RANSAC seed decides bootstrap basin luck, so single-seed ATE numbers
are noisy; accuracy is judged on the across-seed distribution.  Usage:

    python -m photogrammetry_tpu_torch.cli.sweep_sfm_seeds \\
        [--frames 8] [--seeds 20] [--size 480 640] [--focal 520] \\
        [--restarts 1] [--device cuda] [--plain] \\
        [--distortion-coeffs K1 K2 K3 K4 K5] \\
        [--out-and-back] [--loop-mode revisit] \\
        [--pyramid-octaves 2] [--keyframe-disp PX] [--precompute-matching]

With ``--distortion-coeffs`` the rendered frames are first barrel-distorted
with the synthetic map (what a camera with that lens would capture) and
then go through ``run_sfm``'s dewarp stage, so the sweep is over the
dewarp + SfM path.  ``--plain`` runs the kernels' plain versions.
``--out-and-back`` traverses the pan out and back (2F - 1 frames, frame j
the same as frame 2F - 2 - j: every frame revisited), and ``--loop-mode``
runs ``close_loops`` in that mode after each run (``run_sfm
--loop-closure``'s minimum gap max(5, F // 4) and draws seeded 7) and
reports the ATE after it beside the ATE before.  ``--pyramid-octaves``
runs the pyramid frontend (``run_sfm``'s track capacity 1024 x octaves);
``--keyframe-disp`` runs ``run_keyframed_sfm`` (the full trajectory's ATE,
and the keyframe map's as ``ate_keyframes``).  ``--precompute-matching``
sets ``SfmConfig.precompute_matching`` (the pairs matched in chunks up
front, each pair's gate on its own draws).

Prints one JSON line per seed (ATE, landmarks, support, median
reprojection error) and a summary line: mean / p90 / max ATE and the share
of seeds within the bounds of tests/test_incremental.py (ATE < 0.2,
> 80 landmarks), after loop closure too where it ran.
"""
from __future__ import annotations

import argparse
import json
from types import SimpleNamespace


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--frames", type=int, default=8)
    ap.add_argument("--seeds", type=int, default=20)
    ap.add_argument("--size", type=int, nargs=2, default=(480, 640),
                    metavar=("H", "W"))
    ap.add_argument("--focal", type=float, default=520.0)
    ap.add_argument("--supersample", type=int, default=2)
    ap.add_argument("--restarts", type=int, default=1,
                    help=">1 uses run_incremental_sfm_robust best-of-K "
                         "selection per seed")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--plain", action="store_true",
                    help="run the kernels' plain PyTorch versions")
    ap.add_argument("--distortion-coeffs", type=float, nargs=5, default=None,
                    metavar=("K1", "K2", "K3", "K4", "K5"),
                    help="distort the frames with this lens model, then "
                         "dewarp them in front of the SfM run")
    ap.add_argument("--out-and-back", action="store_true",
                    help="traverse the pan out and back (2F - 1 frames)")
    ap.add_argument("--pyramid-octaves", type=int, default=1,
                    help="run the pyramid frontend on this many octaves")
    ap.add_argument("--keyframe-disp", type=float, default=0.0,
                    help=">0 runs the keyframed SfM at this gate (px)")
    ap.add_argument("--precompute-matching", action="store_true",
                    help="match the frame pairs up front in batched "
                         "chunks (SfmConfig.precompute_matching)")
    ap.add_argument("--loop-mode", default=None,
                    choices=("rotation", "essential", "revisit",
                             "revisit_sim3"),
                    help="close loops in this mode after each run")
    args = ap.parse_args(argv)

    import numpy as np
    import torch

    from photogrammetry_tpu_torch.sfm.incremental import (
        SfmConfig, reconstruction_quality, run_incremental_sfm_robust,
    )
    from photogrammetry_tpu_torch.sfm.metrics import trajectory_ate
    from photogrammetry_tpu_torch.synth.star_scene import (
        StarSceneConfig, generate_sequence,
    )

    scene = generate_sequence(StarSceneConfig(
        num_frames=args.frames, image_size=tuple(args.size),
        focal=args.focal, supersample=args.supersample))
    frames, centers = scene["frames"], scene["centers"]
    if args.out_and_back:
        frames = np.concatenate([frames, frames[-2::-1]])
        centers = np.concatenate([centers, centers[-2::-1]])
    if args.distortion_coeffs is not None:
        import tempfile

        from photogrammetry_tpu_torch.cli.run_sfm import dewarp_frames
        from photogrammetry_tpu_torch.ops.dewarp import (
            generate_synthetic_distortion_map, remap_plain,
        )

        synth = generate_synthetic_distortion_map(
            *args.size, args.distortion_coeffs, device=args.device)
        captured = remap_plain(
            torch.as_tensor(frames).to(synth.device)[..., None], synth)
        with tempfile.TemporaryDirectory() as cache_dir:
            frames = dewarp_frames(captured[..., 0].cpu().numpy(),
                                   args.distortion_coeffs, cache_dir,
                                   args.device, plain=args.plain)
    octaves = max(1, args.pyramid_octaves)
    cfg = SfmConfig(collect_diagnostics=False, pyramid_octaves=octaves,
                    track_capacity=1024 * octaves,
                    precompute_matching=args.precompute_matching)

    feats = None
    if args.loop_mode is not None:
        from photogrammetry_tpu_torch.sfm.frontend import (
            frame_features, make_pairs, precompute_frontend,
        )

        stacked = precompute_frontend(
            torch.as_tensor(np.asarray(frames), dtype=torch.float32,
                            device=args.device),
            make_pairs(cfg.frontend, device=args.device), cfg.frontend,
            chunk=cfg.frontend_chunk, plain=args.plain)
        feats = [frame_features(stacked, t) for t in range(len(frames))]
    rows = []
    for seed in range(args.seeds):
        extra = {}
        if args.keyframe_disp > 0:
            from photogrammetry_tpu_torch.sfm.keyframes import (
                run_keyframed_sfm,
            )

            rs, ts, keyframes, res, info = run_keyframed_sfm(
                frames, scene["k"], cfg, min_disp_px=args.keyframe_disp,
                seed=seed, restarts=args.restarts, device=args.device,
                plain=args.plain)
            extra = dict(keyframes=keyframes,
                         ate_keyframes=trajectory_ate(
                             res.rs, res.ts, centers[keyframes]),
                         fallbacks=sum(bool(i.get("fallback"))
                                       for i in info))
            res.rs, res.ts = rs, ts
            support, med = reconstruction_quality(
                SimpleNamespace(rs=rs[keyframes], ts=ts[keyframes],
                                table=res.table), scene["k"])
        else:
            res = run_incremental_sfm_robust(
                frames, scene["k"], cfg, seed=seed, restarts=args.restarts,
                device=args.device, plain=args.plain)
            support, med = reconstruction_quality(res, scene["k"])
        rows.append(dict(seed=seed,
                         ate=trajectory_ate(res.rs, res.ts, centers),
                         landmarks=len(res.points), support=support,
                         median_px=med, **extra))
        if feats is not None:
            from photogrammetry_tpu_torch.cli.run_sfm import LOOP_SEED
            from photogrammetry_tpu_torch.sfm.loop_closure import (
                close_loops,
            )

            gen = torch.Generator(device=args.device)
            gen.manual_seed(LOOP_SEED)
            rs, ts, info = close_loops(
                feats, torch.as_tensor(res.rs, device=args.device),
                torch.as_tensor(res.ts, device=args.device),
                torch.as_tensor(scene["k"], device=args.device),
                cfg.frontend, generator=gen,
                min_gap=max(5, len(frames) // 4),
                mode=args.loop_mode, plain=args.plain)
            rows[-1].update(ate_loop=trajectory_ate(rs, ts, centers),
                            loop_edges=[list(e) for e in info["loop_edges"]])
        print(json.dumps(rows[-1]), flush=True)
    ates = np.array([r["ate"] for r in rows])
    if feats is not None:
        loop_ates = np.array([r["ate_loop"] for r in rows])
        print(json.dumps({
            "loop_mode": args.loop_mode, "mean_loop": float(loop_ates.mean()),
            "max_loop": float(loop_ates.max()),
            "within_bounds_loop": float(np.mean(
                [r["ate_loop"] < 0.2 and r["landmarks"] > 80
                 for r in rows]))}))
    print(json.dumps({
        "frames": len(frames), "size": list(args.size), "focal": args.focal,
        "seeds": args.seeds, "restarts": args.restarts,
        "device": args.device, "plain": args.plain,
        "distortion_coeffs": args.distortion_coeffs,
        "pyramid_octaves": octaves, "keyframe_disp": args.keyframe_disp,
        "precompute_matching": args.precompute_matching,
        "mean": float(ates.mean()),
        "p90": float(np.percentile(ates, 90)), "max": float(ates.max()),
        "within_bounds": float(np.mean([r["ate"] < 0.2
                                        and r["landmarks"] > 80
                                        for r in rows]))}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
