"""Calibrate lens-distortion coefficients from images of straight edges
(port of photogrammetry_tpu/cli/calibrate_dewarp.py).

Plumb-line method over Sobel edges + Hough lines + Levenberg-Marquardt;
see ops/calibrate.py.

Usage:
    python -m photogrammetry_tpu_torch.cli.calibrate_dewarp IMG [IMG...] \\
        [--num-lines 8] [--tol 4] [--rounds 3] [--fit-denominator] \\
        [--save-coefficients coeffs.json] [--dewarp-output out.png] \\
        [--device cuda]
"""
from __future__ import annotations

import argparse
import json
import math


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("images", nargs="+")
    ap.add_argument("--num-lines", type=int, default=8)
    ap.add_argument("--tol", type=float, default=4.0,
                    help="point-to-line assignment tolerance (px)")
    ap.add_argument("--rounds", type=int, default=3,
                    help="alternating extract/fit rounds")
    ap.add_argument("--iterations", type=int, default=30,
                    help="LM iterations per round")
    ap.add_argument("--model", default="rational",
                    choices=("rational", "brown"),
                    help="distortion model: the reference's 5-param "
                         "rational, or the even-power Brown model from "
                         "its derivation notes")
    ap.add_argument("--fit-denominator", action="store_true",
                    help="also fit k3..k5 (denominator); default fits the "
                    "numerator pair [k1, k2] like the reference uses")
    ap.add_argument("--save-coefficients", default=None,
                    help="write fitted [k1..k5] to this JSON file")
    ap.add_argument("--dewarp-output", default=None,
                    help="also dewarp the first image with the fit")
    ap.add_argument("--stats", default=None,
                    help="append run stats to this JSON log")
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; 'cpu' runs the plain "
                         "PyTorch path)")
    args = ap.parse_args(argv)

    import torch

    from photogrammetry_tpu_torch import resolve_device
    from photogrammetry_tpu_torch.cli.common import load_gray
    from photogrammetry_tpu_torch.ops.calibrate import (
        assign_points_to_lines, calibrate_distortion, extract_edge_points,
        hough_from_points, undistort_points, undistort_points_brown,
    )
    from photogrammetry_tpu_torch.utils.profiling import (
        StageTimer, append_stats,
    )

    device = resolve_device(args.device)     # fail before loading images
    if args.model == "brown":
        param_mask = [1.0, 1.0, 1.0, 0.0, 0.0]
        undist = undistort_points_brown
    else:
        param_mask = ([1.0] * 5 if args.fit_denominator
                      else [1.0, 1.0, 0.0, 0.0, 0.0])
        undist = undistort_points
    timer = StageTimer()

    # line groups are pooled from every input image (all must share
    # dimensions so one distortion center applies)
    coeffs = torch.zeros(5, device=device)
    result = None
    with timer.stage("calibrate"):
        imgs = [torch.as_tensor(load_gray(p)).to(device) for p in args.images]
        h, w = imgs[0].shape
        for im in imgs:
            if tuple(im.shape) != (h, w):
                raise SystemExit("all calibration images must share "
                                 f"dimensions; got {tuple(im.shape)} vs "
                                 f"{(h, w)}")
        center = torch.tensor([h / 2.0, w / 2.0], device=device)
        extent = math.hypot(h / 2.0, w / 2.0)
        extracted = [extract_edge_points(im) for im in imgs]
        for _ in range(max(1, args.rounds)):
            all_pts, all_masks = [], []
            for pts, val in extracted:
                und = undist(pts, coeffs, center)
                lines = hough_from_points(und, val, center, extent,
                                          num_lines=args.num_lines)
                ti, mask = assign_points_to_lines(und, val, lines, center,
                                                  tol=args.tol)
                all_pts.append(pts[ti])
                all_masks.append(mask)
            result = calibrate_distortion(torch.cat(all_pts),
                                          torch.cat(all_masks), center,
                                          init_coeffs=coeffs,
                                          num_iterations=args.iterations,
                                          param_mask=param_mask,
                                          model=args.model)
            coeffs = result.coeffs
        timer.block(coeffs)

    fitted = [float(c) for c in result.coeffs.cpu()]
    print(json.dumps({
        "coefficients": fitted,
        "model": args.model,
        "initial_cost": float(result.initial_cost),
        "final_cost": float(result.cost),
        "images": args.images,
    }))

    if args.save_coefficients:
        with open(args.save_coefficients, "w") as f:
            json.dump({"coefficients": fitted}, f)
        print(f"wrote {args.save_coefficients}")

    if args.dewarp_output:
        from photogrammetry_tpu_torch.io.image import write_image
        from photogrammetry_tpu_torch.ops.dewarp import (
            generate_distortion_map, generate_distortion_map_brown,
            make_distortion_applier,
        )

        generate = (generate_distortion_map_brown if args.model == "brown"
                    else generate_distortion_map)
        dmap = generate(h, w, fitted, device=device)
        out = make_distortion_applier(dmap, (h, w), device=device)(imgs[0])
        write_image(args.dewarp_output,
                    out.cpu().numpy().astype("uint8"))
        print(f"wrote {args.dewarp_output}")

    if args.stats:
        append_stats(args.stats, {
            "tool": "calibrate_dewarp",
            "images": args.images,
            "coefficients": fitted,
            "final_cost": float(result.cost),
            **timer.summary(),
        })
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
