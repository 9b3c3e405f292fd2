"""Detect FAST keypoints and write an overlay image (port of
photogrammetry_tpu/cli/detect_features.py).

    python -m photogrammetry_tpu_torch.cli.detect_features IMG [-o OUT] \\
        [--threshold 50] [--max-keypoints 4096] [--cache-dir DIR] \\
        [--device cuda]

One FAST launch on the uploaded frame, then the detected pixels in raster
order (the reference's detection order) up to ``--max-keypoints``.
``--cache-dir`` keeps the keypoints in ``store/cache.KeypointCache``
(keyed by the image's content and the threshold).
"""
from __future__ import annotations

import argparse


def detect(gray, threshold: float, max_keypoints: int, plain: bool = False):
    """(H, W) float32 tensor → PaddedPoints in raster order; ``plain=True``
    runs the FAST kernel's plain PyTorch version."""
    from photogrammetry_tpu_torch.kernels import fast_stencil
    from photogrammetry_tpu_torch.ops.fast import extract_keypoints

    score_fn = (fast_stencil.fast_score_map_plain if plain
                else fast_stencil.fast_score_map)
    return extract_keypoints(score_fn(gray, threshold), max_keypoints)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("image")
    ap.add_argument("-o", "--output", default=None)
    ap.add_argument("--threshold", type=float, default=50.0)
    ap.add_argument("--max-keypoints", type=int, default=4096)
    ap.add_argument("--cache-dir", default=None,
                    help="enable the on-disk keypoint cache")
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; 'cpu' runs the plain "
                         "PyTorch path)")
    args = ap.parse_args(argv)

    import torch

    from photogrammetry_tpu_torch import resolve_device
    from photogrammetry_tpu_torch.cli.common import load_gray
    from photogrammetry_tpu_torch.io.draw import draw_squares
    from photogrammetry_tpu_torch.io.image import read_image, write_image
    from photogrammetry_tpu_torch.utils.profiling import StageTimer

    device = resolve_device(args.device)     # fail before reading the image
    timer = StageTimer()
    gray = load_gray(args.image)

    cached = None
    if args.cache_dir:
        from photogrammetry_tpu_torch.store.cache import KeypointCache
        cache = KeypointCache(args.cache_dir)
        cached = cache.get(args.image, threshold=args.threshold)

    if cached is not None:
        coords = cached["coords"]
    else:
        with timer.stage("detect"):
            pts = timer.block(detect(torch.from_numpy(gray).to(device),
                                     args.threshold, args.max_keypoints))
        coords = pts.coords[pts.mask].cpu().numpy()
        if args.cache_dir:
            cache.put(args.image, {"coords": coords},
                      threshold=args.threshold)

    print(f"{len(coords)} keypoints  {timer.summary()}")
    out_path = args.output or args.image.rsplit(".", 1)[0] + "_detected.png"
    overlay = draw_squares(read_image(args.image), coords)
    write_image(out_path, overlay)
    print(f"wrote {out_path}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
