"""ASCII PLY point-cloud export (the port's copy of
photogrammetry_tpu/io/ply.py ``write_ply``; numpy only)."""
from __future__ import annotations

import numpy as np


def write_ply(path: str, points, colors=None) -> None:
    """Write (N, 3) points (optionally with (N, 3) uint8 colors) to PLY."""
    pts = np.asarray(points, np.float32).reshape(-1, 3)
    lines = [
        "ply",
        "format ascii 1.0",
        f"element vertex {len(pts)}",
        "property float x",
        "property float y",
        "property float z",
    ]
    if colors is not None:
        colors = np.asarray(colors, np.uint8).reshape(-1, 3)
        lines += ["property uchar red", "property uchar green",
                  "property uchar blue"]
    lines.append("end_header")
    for i, p in enumerate(pts):
        row = f"{p[0]} {p[1]} {p[2]}"
        if colors is not None:
            row += f" {colors[i][0]} {colors[i][1]} {colors[i][2]}"
        lines.append(row)
    with open(path, "w") as fh:
        fh.write("\n".join(lines) + "\n")
