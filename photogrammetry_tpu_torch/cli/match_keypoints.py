"""Detect, reduce and match two images; write a side-by-side match overlay
(port of photogrammetry_tpu/cli/match_keypoints.py).

    python -m photogrammetry_tpu_torch.cli.match_keypoints IMG1 IMG2 \\
        [-o matched_combined.png] [--detection-threshold 50] \\
        [--match-threshold 75] [--max-merge-dist 25] \\
        [--reduction cluster|nms|none] [--oriented-brief] [--device cuda]

Each image: FAST (one launch), the reduction (by default the chunked
clustering), BRIEF (one launch); then the Hamming distances (one launch)
and mutual-nearest matching.
"""
from __future__ import annotations

import argparse


def match_images(g1, g2, pairs, config, plain: bool = False):
    """Two (H, W) float32 tensors → (DescribedFrame, DescribedFrame,
    MatchedPair); ``plain=True`` runs the kernels' plain versions."""
    from photogrammetry_tpu_torch.sfm.frontend import (
        detect_and_describe, match_pair,
    )

    f1 = detect_and_describe(g1, pairs, config, plain)
    f2 = detect_and_describe(g2, pairs, config, plain)
    return f1, f2, match_pair(f1, f2, config, plain)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("image1")
    ap.add_argument("image2")
    ap.add_argument("-o", "--output", default="matched_combined.png")
    ap.add_argument("--detection-threshold", type=float, default=50.0)
    ap.add_argument("--match-threshold", type=int, default=75)
    ap.add_argument("--max-merge-dist", type=float, default=25.0)
    ap.add_argument("--reduction", choices=["cluster", "nms", "none"],
                    default="cluster")
    ap.add_argument("--oriented-brief", action="store_true",
                    help="steered (rotation-invariant) BRIEF descriptors "
                         "(ops/brief.py); use for rotated viewpoints")
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; 'cpu' runs the plain "
                         "PyTorch path)")
    args = ap.parse_args(argv)

    import numpy as np
    import torch

    from photogrammetry_tpu_torch import resolve_device
    from photogrammetry_tpu_torch.cli.common import load_gray
    from photogrammetry_tpu_torch.io.draw import (
        draw_lines, draw_squares, join_right,
    )
    from photogrammetry_tpu_torch.io.image import read_image, write_image
    from photogrammetry_tpu_torch.sfm.frontend import (
        FrontendConfig, make_pairs,
    )
    from photogrammetry_tpu_torch.utils.profiling import StageTimer

    device = resolve_device(args.device)     # fail before reading images
    config = FrontendConfig(
        detection_threshold=args.detection_threshold,
        hamming_threshold=args.match_threshold,
        max_merge_dist=args.max_merge_dist,
        reduction=args.reduction,
        oriented_brief=args.oriented_brief,
    )
    pairs = make_pairs(config, device=device)
    timer = StageTimer()
    g1 = torch.from_numpy(load_gray(args.image1)).to(device)
    g2 = torch.from_numpy(load_gray(args.image2)).to(device)
    with timer.stage("detect+describe+match"):
        f1, f2, m = timer.block(match_images(g1, g2, pairs, config))

    mask = m.mask.cpu().numpy()
    xy1 = m.xy1.cpu().numpy()[mask]
    xy2 = m.xy2.cpu().numpy()[mask]
    print(f"{int(f1.points.count)} + {int(f2.points.count)} keypoints, "
          f"{mask.sum()} matches  {timer.summary()}")

    im1 = draw_squares(read_image(args.image1),
                       f1.points.coords[f1.points.mask].cpu().numpy())
    im2 = draw_squares(read_image(args.image2),
                       f2.points.coords[f2.points.mask].cpu().numpy())
    combined = join_right(im1, im2)
    off = im1.shape[1]
    starts = xy1[:, ::-1]                     # (x,y) -> (row,col)
    ends = np.stack([xy2[:, 1], xy2[:, 0] + off], axis=-1)
    combined = draw_lines(combined, starts, ends)
    write_image(args.output, combined)
    print(f"wrote {args.output}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
