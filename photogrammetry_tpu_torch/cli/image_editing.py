"""Make shifted test images (port of photogrammetry_tpu/cli/image_editing.py).

    python -m photogrammetry_tpu_torch.cli.image_editing IMG [-o OUT] \\
        [--shift-x 150] [--shift-y 0] [--device cuda]

The image moves by (shift-x, shift-y) px and the uncovered border is 0
(the reference's 15pt_star_shifted_150.png fixture is the 15-point star
moved 150 px along x).  The copy runs on ``--device``.
"""
from __future__ import annotations

import argparse


def shift_image(img, sx: int, sy: int):
    """An (H, W[, C]) tensor moved by ``sx`` columns and ``sy`` rows, the
    uncovered border 0, on the tensor's device."""
    import torch

    out = torch.zeros_like(img)
    src = img[max(-sy, 0):img.shape[0] - max(sy, 0),
              max(-sx, 0):img.shape[1] - max(sx, 0)]
    out[max(sy, 0):max(sy, 0) + src.shape[0],
        max(sx, 0):max(sx, 0) + src.shape[1]] = src
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("image")
    ap.add_argument("-o", "--output", default=None)
    ap.add_argument("--shift-x", type=int, default=150)
    ap.add_argument("--shift-y", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; 'cpu' runs on the "
                         "CPU)")
    args = ap.parse_args(argv)

    import torch

    from photogrammetry_tpu_torch import resolve_device
    from photogrammetry_tpu_torch.io.image import read_image, write_image

    device = resolve_device(args.device)     # fail before reading the image
    img = torch.from_numpy(read_image(args.image)).to(device)
    sx, sy = args.shift_x, args.shift_y
    out = shift_image(img, sx, sy)
    path = args.output or args.image.rsplit(".", 1)[0] + \
        f"_shifted_{sx}.png"
    write_image(path, out.cpu().numpy())
    print(f"wrote {path}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
