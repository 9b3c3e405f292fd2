"""Still-image capture (port of photogrammetry_tpu/cli/capture.py).

    python -m photogrammetry_tpu_torch.cli.capture [OUTPUT] [--synthetic]

Reference analogue: python_src/scripts/take_img.py:5-12 (PiCamera still at
2560x1440).  Uses any OpenCV-visible camera; without one, renders a frame of
the synthetic scene so the tool is exercisable headless.
"""
from __future__ import annotations

import argparse


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("output", nargs="?", default="capture.png")
    ap.add_argument("--width", type=int, default=2560)
    ap.add_argument("--height", type=int, default=1440)
    ap.add_argument("--synthetic", action="store_true")
    args = ap.parse_args(argv)

    import numpy as np

    from photogrammetry_tpu_torch.io.image import write_image

    frame = None
    if not args.synthetic:
        try:
            import cv2

            cap = cv2.VideoCapture(0)
            cap.set(cv2.CAP_PROP_FRAME_WIDTH, args.width)
            cap.set(cv2.CAP_PROP_FRAME_HEIGHT, args.height)
            ok, bgr = cap.read()
            if ok:
                frame = bgr[..., ::-1]
            cap.release()
        except Exception:
            frame = None
    if frame is None:
        from photogrammetry_tpu_torch.synth.star_scene import (
            StarSceneConfig, generate_sequence,
        )

        scene = generate_sequence(StarSceneConfig(
            num_frames=1, image_size=(args.height // 2, args.width // 2)))
        frame = np.asarray(scene["frames"][0])
        print("no camera found: captured a synthetic frame")

    write_image(args.output, frame)
    print(f"wrote {args.output} {frame.shape}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
