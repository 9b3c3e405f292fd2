#!/usr/bin/env python3
"""The JAX package's across-seed ATE of the robust SfM run with and
without ``precompute_matching``, on the CPU, from the repository root:

    python3 experiments/precompute_seeds/run.py [--seeds 0 1 2 3 4 5] \\
        [--size 1080 1920] [--focal 1560] [--restarts 3] [--flag on|off|both]

The frames are ``chip_smoke.py``'s: the 12-frame star-scene pan at 1080p,
focal 1560, the default ``SfmConfig`` (diagnostics off).  For each seed and
setting of the flag it prints one JSON line: ATE against the ground-truth
camera centres, landmarks, ``reconstruction_quality`` and seconds; then a
summary line for each setting (mean, max, share within the sfm gate ATE <
0.2 with > 80 landmarks).  The port's counterpart on the card is

    python -m photogrammetry_tpu_torch.cli.sweep_sfm_seeds --frames 12 \\
        --size 1080 1920 --focal 1560 --seeds 6 --restarts 3 \\
        --precompute-matching
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--seeds", type=int, nargs="+", default=list(range(6)))
    ap.add_argument("--size", type=int, nargs=2, default=[1080, 1920])
    ap.add_argument("--focal", type=float, default=1560.0)
    ap.add_argument("--restarts", type=int, default=3)
    ap.add_argument("--flag", choices=("on", "off", "both"), default="on")
    args = ap.parse_args(argv)

    import jax

    jax.config.update("jax_platforms", "cpu")
    import numpy as np

    from photogrammetry_tpu.sfm.incremental import (
        SfmConfig, reconstruction_quality, run_incremental_sfm_robust,
    )
    from photogrammetry_tpu.synth.star_scene import (
        StarSceneConfig, generate_sequence,
    )
    # the ATE as chip_smoke.py and the port's sweep compute it (float64)
    from photogrammetry_tpu_torch.sfm.metrics import trajectory_ate

    scene = generate_sequence(StarSceneConfig(
        num_frames=12, image_size=tuple(args.size), focal=args.focal))
    flags = {"on": [True], "off": [False], "both": [False, True]}[args.flag]
    rows = {flag: [] for flag in flags}
    for seed in args.seeds:
        for flag in flags:
            t0 = time.perf_counter()
            res = run_incremental_sfm_robust(
                scene["frames"], scene["k"], SfmConfig(
                    collect_diagnostics=False, precompute_matching=flag),
                seed=seed, restarts=args.restarts)
            support, med = reconstruction_quality(res, scene["k"])
            row = dict(seed=seed, precompute_matching=flag,
                       ate=trajectory_ate(np.array(res.rs),
                                          np.array(res.ts),
                                          scene["centers"]),
                       landmarks=len(res.points), support=float(support),
                       median_px=float(med),
                       seconds=time.perf_counter() - t0)
            rows[flag].append(row)
            print(json.dumps(row), flush=True)
    for flag, got in rows.items():
        ates = np.array([r["ate"] for r in got])
        print(json.dumps({
            "package": "jax", "device": "cpu", "precompute_matching": flag,
            "size": args.size, "focal": args.focal, "seeds": args.seeds,
            "restarts": args.restarts, "mean": float(ates.mean()),
            "max": float(ates.max()),
            "within_bounds": float(np.mean([r["ate"] < 0.2
                                            and r["landmarks"] > 80
                                            for r in got]))}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
