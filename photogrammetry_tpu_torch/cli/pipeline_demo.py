"""The reference's live production pipeline, end to end (port of
photogrammetry_tpu/cli/pipeline_demo.py).

    python -m photogrammetry_tpu_torch.cli.pipeline_demo IMG [IMG...] \\
        [--coeffs K1 K2 K3 K4 K5] [--out-dir DIR] [--cache-dir DIR] \\
        [--workers 2] [--device cuda]

read -> dewarp -> grayscale -> detect -> NMS -> draw -> write, as a staged
run over the content store, with the distortion map built once per image
size and cached on disk.  Between ``read`` and ``draw`` a record's blobs
are tensors on ``device``: the dewarp is the remap kernel on the
(H, W, 3) uint8 image, the detection the FAST kernel.

Default options mirror the reference's appsettings.json: distortion
coefficients [3e-4, 1e-7, 0, 0, 0], suppression radius 50; the detection
threshold is in 0-255 grayscale units.
"""
from __future__ import annotations

import argparse
import hashlib
import os
import threading


def build_pipeline(coeffs, threshold: float, suppression_radius: float,
                   max_keypoints: int, out_dir: str, cache_dir: str,
                   store=None, *, device="cuda", plain: bool = False):
    """The stage chain as a store-mediated Pipeline on ``device``;
    ``plain=True`` runs the kernels' plain PyTorch versions."""
    import numpy as np
    import torch

    from photogrammetry_tpu_torch import resolve_device
    from photogrammetry_tpu_torch.io.draw import draw_squares
    from photogrammetry_tpu_torch.io.image import read_image, write_image
    from photogrammetry_tpu_torch.kernels import fast_stencil
    from photogrammetry_tpu_torch.ops.dewarp import make_distortion_applier
    from photogrammetry_tpu_torch.ops.fast import extract_keypoints
    from photogrammetry_tpu_torch.ops.grayscale import bgr_to_gray_cv2
    from photogrammetry_tpu_torch.ops.nms import nms_keypoints_static
    from photogrammetry_tpu_torch.store.cache import DistortionMapCache
    from photogrammetry_tpu_torch.store.content_store import Variant
    from photogrammetry_tpu_torch.store.pipeline import Pipeline, Stage

    dev = resolve_device(device)
    cache = DistortionMapCache(cache_dir)
    appliers = {}  # (h, w) -> remap closure; the one-time map build
    appliers_lock = threading.Lock()   # records may run on several threads
    score_fn = (fast_stencil.fast_score_map_plain if plain
                else fast_stencil.fast_score_map)

    def dewarp(img):
        img = torch.as_tensor(img).to(dev)
        if not np.any(np.asarray(coeffs)):
            return img  # identity model
        hw = tuple(img.shape[:2])
        with appliers_lock:
            if hw not in appliers:
                appliers[hw] = make_distortion_applier(
                    cache.get_or_generate(*hw, coeffs, device=dev), hw,
                    device=dev, plain=plain)
        return appliers[hw](img)

    def detect(gray):
        score = score_fn(gray.contiguous(), float(threshold))
        return extract_keypoints(score, max_keypoints, order="score")

    def draw(points, dewarped):
        coords = points.coords[points.mask].cpu().numpy()
        return draw_squares(dewarped.cpu().numpy(), coords, half=3,
                            color=(0, 255, 0))

    def write(overlay, source):
        # named after the input path, not a completion counter: with
        # --workers > 1 records finish in arbitrary order
        os.makedirs(out_dir, exist_ok=True)
        stem = os.path.splitext(os.path.basename(str(source)))[0]
        path = os.path.join(out_dir, f"keypoints_{stem}.png")
        if os.path.exists(path):
            # two inputs sharing a basename stem must not silently
            # overwrite each other
            tag = hashlib.sha1(str(source).encode()).hexdigest()[:8]
            path = os.path.join(out_dir, f"keypoints_{stem}_{tag}.png")
        write_image(path, overlay)
        return path

    return Pipeline([
        Stage("read", Variant.SOURCE, Variant.RGB, read_image),
        Stage("dewarp", Variant.RGB, Variant.DEWARPED_RGB, dewarp),
        # the channels go to the BGR2GRAY weights in the order they are
        # stored, as in the JAX package's pipeline
        Stage("grayscale", Variant.DEWARPED_RGB,
              Variant.DEWARPED_GRAYSCALE,
              lambda img: bgr_to_gray_cv2(img).to(torch.float32)),
        Stage("detect", Variant.DEWARPED_GRAYSCALE, Variant.KEYPOINTS,
              detect),
        Stage("nms", Variant.KEYPOINTS, Variant.DENOISED_KEYPOINTS,
              lambda points: nms_keypoints_static(
                  points, float(suppression_radius))),
        Stage("draw", Variant.DENOISED_KEYPOINTS, Variant.OVERLAY, draw,
              extra_inputs=(Variant.DEWARPED_RGB,)),
        Stage("write", Variant.OVERLAY, Variant.ARTIFACT, write,
              extra_inputs=(Variant.SOURCE,)),
    ], store=store)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("images", nargs="+", help="input image files")
    ap.add_argument("--coeffs", type=float, nargs=5,
                    default=[3e-4, 1e-7, 0.0, 0.0, 0.0],
                    help="radial distortion coefficients k1..k5 "
                         "(appsettings.json defaults); all zero = no dewarp")
    ap.add_argument("--detection-threshold", type=float, default=50.0)
    ap.add_argument("--suppression-radius", type=float, default=50.0)
    ap.add_argument("--max-keypoints", type=int, default=4096)
    ap.add_argument("--out-dir", default="data/pipeline_out")
    ap.add_argument("--cache-dir", default="data/distortion_maps")
    ap.add_argument("--workers", type=int, default=2,
                    help=">1 overlaps records across stages like the "
                         "reference's dataflow blocks")
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; 'cpu' runs the plain "
                         "PyTorch path)")
    args = ap.parse_args(argv)

    from photogrammetry_tpu_torch.store.content_store import Variant

    pipe = build_pipeline(args.coeffs, args.detection_threshold,
                          args.suppression_radius, args.max_keypoints,
                          args.out_dir, args.cache_dir, device=args.device)
    rids = pipe.run(args.images, max_workers=args.workers)
    for path, rid in zip(args.images, rids):
        pts = pipe.store.fetch(rid, Variant.DENOISED_KEYPOINTS)
        out = pipe.store.fetch(rid, Variant.ARTIFACT)
        print(f"{path}: {int(pts.mask.sum())} keypoints -> {out}")
    print("stage timings:", pipe.timer.summary())
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
