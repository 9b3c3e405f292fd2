"""Two-view camera pose from an image pair: detect → match → RANSAC →
essential decomposition → triangulation; writes a PLY cloud and scatter
diagnostics (port of photogrammetry_tpu/cli/estimate_pose.py).

    python -m photogrammetry_tpu_torch.cli.estimate_pose IMG1 IMG2 \\
        [--reduction nms|anms|cluster|none] [--motion-filter] \\
        [--pyramid-octaves N] [--oriented-brief] [--num-samples 2000] \\
        [--ransac-threshold 1.5] [--fx F] [--cloud test.ply] \\
        [--plots PREFIX] [--stats LOG] [--device cuda]

The F-only model (the reference's two-view program); the RANSAC samples
come from a ``torch.Generator`` on the device seeded with 0 (the JAX CLI
draws from ``PRNGKey(0)``, a different stream).
"""
from __future__ import annotations

import argparse
import json


def frontend(g1, g2, pairs, config, octaves: int = 1,
             motion_filter: bool = False, plain: bool = False):
    """Two (H, W) float32 tensors → (DescribedFrame, DescribedFrame,
    MatchedPair): the split frontend, or the pyramid's with ``octaves`` >
    1; with ``motion_filter`` the matches pass the motion-smoothness
    prefilter.  ``plain=True`` runs the kernels' plain versions."""
    from photogrammetry_tpu_torch.ops.match import motion_consistency_mask
    from photogrammetry_tpu_torch.sfm.frontend import (
        detect_and_describe, detect_and_describe_pyramid, match_pair,
    )

    if octaves > 1:
        f1, f2 = (detect_and_describe_pyramid(g, pairs, config,
                                              octaves=octaves, plain=plain)
                  for g in (g1, g2))
    else:
        f1, f2 = (detect_and_describe(g, pairs, config, plain)
                  for g in (g1, g2))
    m = match_pair(f1, f2, config, plain)
    if motion_filter:
        mask = motion_consistency_mask(m.xy1, m.xy2, m.mask)
        m = m._replace(mask=mask, num=mask.sum().to(m.num.dtype))
    return f1, f2, m


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("image1")
    ap.add_argument("image2")
    ap.add_argument("--detection-threshold", type=float, default=50.0)
    ap.add_argument("--match-threshold", type=int, default=75)
    ap.add_argument("--reduction", choices=["cluster", "nms", "anms", "none"],
                    default="nms")
    ap.add_argument("--num-samples", type=int, default=2000,
                    help="RANSAC hypotheses (Program.cs:229)")
    ap.add_argument("--ransac-threshold", type=float, default=1.5,
                    help="Sampson inlier threshold, pixels")
    ap.add_argument("--fx", type=float, default=None,
                    help="focal length in pixels (default 1.2*width)")
    ap.add_argument("--oriented-brief", action="store_true",
                    help="steered (rotation-invariant) BRIEF descriptors")
    ap.add_argument("--pyramid-octaves", type=int, default=1,
                    help=">1 runs the multi-scale pyramid frontend "
                         "(scale-invariant matching; 3 is typical)")
    ap.add_argument("--motion-filter", action="store_true",
                    help="GMS-style motion-smoothness prefilter on the "
                         "matches before RANSAC (ops.match."
                         "motion_consistency_mask)")
    ap.add_argument("--cloud", default="test.ply")
    ap.add_argument("--plots", default=None,
                    help="prefix for depth-scatter PNGs (omit to skip)")
    ap.add_argument("--stats", default=None)
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; 'cpu' runs the plain "
                         "PyTorch path)")
    args = ap.parse_args(argv)

    import numpy as np
    import torch

    from photogrammetry_tpu_torch import resolve_device
    from photogrammetry_tpu_torch.cli.common import load_gray
    from photogrammetry_tpu_torch.io.ply import write_ply
    from photogrammetry_tpu_torch.sfm.frontend import (
        FrontendConfig, make_pairs,
    )
    from photogrammetry_tpu_torch.sfm.two_view import two_view_pipeline
    from photogrammetry_tpu_torch.utils.profiling import (
        StageTimer, append_stats,
    )

    device = resolve_device(args.device)     # fail before reading images
    config = FrontendConfig(
        detection_threshold=args.detection_threshold,
        hamming_threshold=args.match_threshold,
        reduction=args.reduction,
        suppression_radius=4.0,
        oriented_brief=args.oriented_brief,
    )
    pairs = make_pairs(config, device=device)
    g1 = torch.from_numpy(load_gray(args.image1)).to(device)
    g2 = torch.from_numpy(load_gray(args.image2)).to(device)
    h, w = g1.shape
    fx = args.fx if args.fx is not None else 1.2 * w
    if fx <= 0:
        raise SystemExit(f"--fx must be positive, got {fx}")
    k = torch.tensor([[fx, 0.0, w / 2.0], [0.0, fx, h / 2.0],
                      [0.0, 0.0, 1.0]], dtype=torch.float32, device=device)

    timer = StageTimer()
    with timer.stage("frontend"):
        f1, f2, m = timer.block(frontend(g1, g2, pairs, config,
                                         args.pyramid_octaves,
                                         args.motion_filter))
    with timer.stage("two_view"):
        # model="fundamental": this CLI mirrors the reference's exact
        # F-only program; auto H/F arbitration lives in the SfM bootstrap.
        gen = torch.Generator(device=device).manual_seed(0)
        out = timer.block(two_view_pipeline(
            gen, m.xy1, m.xy2, m.mask, k, threshold=args.ransac_threshold,
            num_samples=args.num_samples, model="fundamental"))

    inl = (out.inliers & m.mask).cpu().numpy()
    pts = out.points.cpu().numpy()[inl]
    pts = pts[np.isfinite(pts).all(axis=1) & (pts[:, 2] > 0)]
    write_ply(args.cloud, pts)
    if args.plots:
        from photogrammetry_tpu_torch.io.draw import scatter_plot
        from photogrammetry_tpu_torch.io.image import write_image

        write_image(f"{args.plots}_xz.png", scatter_plot(pts[:, 0], pts[:, 2]))
        write_image(f"{args.plots}_xy.png", scatter_plot(pts[:, 0], pts[:, 1]))

    report = {
        "keypoints": [int(f1.points.count), int(f2.points.count)],
        "matches": int(m.num),
        "inliers": int(out.num_inliers),
        "rotation": out.r.cpu().numpy().tolist(),
        "translation": out.t.cpu().numpy().tolist(),
        "cheirality_votes": out.cheirality.cpu().numpy().tolist(),
        "points": int(len(pts)),
        "timings": timer.summary(),
    }
    print(json.dumps(report))
    print(f"wrote {args.cloud}")
    if args.stats:
        append_stats(args.stats, report)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
