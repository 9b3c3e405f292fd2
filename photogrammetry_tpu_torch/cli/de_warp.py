"""Dewarp an image through the rational radial model, with map caching and
run-stats logging (port of photogrammetry_tpu/cli/de_warp.py).

    python -m photogrammetry_tpu_torch.cli.de_warp IMAGE [COMMENT] \\
        [-o OUT] [--coefficients K1 K2 K3 K4 K5] [--cache-dir DIR] \\
        [--no-cache] [--stats LOG] [--device cuda]

On a card the remap runs through the CUDA kernel (kernels/remap.py), which
is exact; ``--device cpu`` runs the plain PyTorch remap.
"""
from __future__ import annotations

import argparse


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("image")
    ap.add_argument("comment", nargs="?", default="")
    ap.add_argument("-o", "--output", default=None)
    ap.add_argument("--coefficients", type=float, nargs=5,
                    default=[3e-4, 1e-7, 0.0, 0.0, 0.0])
    ap.add_argument("--cache-dir", default="./data/distortion_maps")
    ap.add_argument("--no-cache", action="store_true")
    ap.add_argument("--fast-apply", action="store_true",
                    help="accepted for compatibility with the JAX CLI, where "
                         "it chose an approximate kernel over the exact "
                         "gather; here the kernel is exact and is the "
                         "default on a card, so the flag does nothing")
    ap.add_argument("--stats", default=None,
                    help="append timing stats to this JSON log")
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; 'cpu' runs the plain "
                         "PyTorch path)")
    args = ap.parse_args(argv)

    from photogrammetry_tpu_torch import resolve_device
    from photogrammetry_tpu_torch.io.image import read_image, write_image
    from photogrammetry_tpu_torch.ops.dewarp import (
        generate_distortion_map, make_distortion_applier,
    )
    from photogrammetry_tpu_torch.store.cache import DistortionMapCache
    from photogrammetry_tpu_torch.utils.profiling import (
        StageTimer, append_stats,
    )

    device = resolve_device(args.device)     # fail before reading the image
    timer = StageTimer()
    img = read_image(args.image)
    h, w = img.shape[:2]

    with timer.stage("generate_map"):
        if args.no_cache:
            dist_map = timer.block(generate_distortion_map(
                h, w, args.coefficients, device=device))
        else:
            dist_map = DistortionMapCache(args.cache_dir).get_or_generate(
                h, w, args.coefficients, device=device)
    with timer.stage("apply_map"):
        apply = make_distortion_applier(dist_map, (h, w), device=device)
        out = timer.block(apply(img))

    out_path = args.output or args.image.rsplit(".", 1)[0] + "_dewarped.png"
    write_image(out_path, out.cpu().numpy())
    stats = timer.summary()
    print(f"{stats}")
    print(f"wrote {out_path}")
    if args.stats:
        append_stats(args.stats, {
            "comment": args.comment,
            "image": args.image,
            "coefficients": args.coefficients,
            "timings": stats,
        })
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
