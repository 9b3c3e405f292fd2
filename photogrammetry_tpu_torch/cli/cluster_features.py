"""Detect + cluster keypoints and write an overlay image (port of
photogrammetry_tpu/cli/cluster_features.py).

    python -m photogrammetry_tpu_torch.cli.cluster_features IMG [-o OUT] \\
        [--threshold 50] [--max-merge-dist 25] [--chunks 4 4] [--exact] \\
        [--device cuda]

FAST on the uploaded frame (one launch), every detected pixel up to 65,536
in raster order, then the chunked agglomerative clustering on the device
(``ops/cluster.grid_cluster_keypoints``, chunk capacity twice the mean
keypoints a chunk, at least 256) or, with ``--exact``, the reference's
sequential clustering on the host.
"""
from __future__ import annotations

import argparse

RAW_CAPACITY = 65536


def detect_all(gray, threshold: float, plain: bool = False):
    """(H, W) float32 tensor → every detected pixel (up to RAW_CAPACITY),
    raster order; ``plain=True`` runs the FAST kernel's plain version."""
    from photogrammetry_tpu_torch.cli.detect_features import detect

    return detect(gray, threshold, RAW_CAPACITY, plain)


def chunk_capacity(raw: int, chunks) -> int:
    """Slots a chunk: twice the mean keypoints a chunk, at least 256."""
    return max(raw // (chunks[0] * chunks[1]) * 2, 256)


def cluster(pts, h: int, w: int, max_merge_dist: float, chunks,
            exact: bool = False):
    """Detected PaddedPoints → (M, 2) int32 numpy cluster centres (row,
    col)."""
    from photogrammetry_tpu_torch.ops.cluster import (
        grid_cluster_keypoints, hierarchical_cluster_exact,
    )

    if exact:
        return hierarchical_cluster_exact(pts.coords[pts.mask].cpu().numpy(),
                                          max_merge_dist)
    out = grid_cluster_keypoints(
        pts, h, w, max_merge_dist=max_merge_dist, chunks=tuple(chunks),
        chunk_capacity=chunk_capacity(int(pts.count), chunks))
    return out.coords[out.mask].cpu().numpy()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("image")
    ap.add_argument("-o", "--output", default=None)
    ap.add_argument("--threshold", type=float, default=50.0)
    ap.add_argument("--max-merge-dist", type=float, default=25.0)
    ap.add_argument("--chunks", type=int, nargs=2, default=(4, 4))
    ap.add_argument("--exact", action="store_true",
                    help="use the exact host-side reference-parity path")
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
    h, w = gray.shape
    with timer.stage("detect"):
        pts = timer.block(detect_all(torch.from_numpy(gray).to(device),
                                     args.threshold))
    raw = int(pts.count)

    with timer.stage("cluster"):
        clustered = cluster(pts, h, w, args.max_merge_dist, args.chunks,
                            args.exact)

    print(f"{raw} keypoints -> {len(clustered)} clusters  {timer.summary()}")
    out_path = args.output or args.image.rsplit(".", 1)[0] + "_clustered.png"
    write_image(out_path, draw_squares(read_image(args.image), clustered))
    print(f"wrote {out_path}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
