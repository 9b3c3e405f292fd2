"""ASCII PLY point-cloud export and its minimal reader (the port's copy
of photogrammetry_tpu/io/ply.py; numpy only)."""
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


def read_ply(path: str) -> np.ndarray:
    """Minimal ASCII PLY reader (xyz only), for round-trip tests."""
    with open(path) as fh:
        lines = fh.read().splitlines()
    n = 0
    for i, line in enumerate(lines):
        if line.startswith("element vertex"):
            n = int(line.split()[-1])
        if line == "end_header":
            body = lines[i + 1:i + 1 + n]
            break
    return np.array([[float(x) for x in row.split()[:3]] for row in body],
                    np.float32)
