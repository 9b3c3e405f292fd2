"""Diagnostic overlay drawing (port of photogrammetry_tpu/io/draw.py).

Reference analogues: the square and Bresenham-line drawing of the
reference's C# pipeline and the cv2 overlays in
scripts/match_keypoints.py:26-28.
All functions are pure NumPy on host images (visualization is not a device
workload).
"""
from __future__ import annotations

import numpy as np


def _ensure_rgb(img: np.ndarray) -> np.ndarray:
    if img.ndim == 2:
        return np.stack([img] * 3, axis=-1).astype(np.uint8)
    return img.astype(np.uint8).copy()


def draw_squares(img: np.ndarray, coords, half: int = 3,
                 color=(255, 0, 0)) -> np.ndarray:
    """Draw hollow squares centered at (row, col) coords."""
    out = _ensure_rgb(img)
    h, w, _ = out.shape
    color = np.array(color, np.uint8)
    for r, c in np.asarray(coords).reshape(-1, 2):
        r0, r1 = max(r - half, 0), min(r + half, h - 1)
        c0, c1 = max(c - half, 0), min(c + half, w - 1)
        out[r0, c0:c1 + 1] = color
        out[r1, c0:c1 + 1] = color
        out[r0:r1 + 1, c0] = color
        out[r0:r1 + 1, c1] = color
    return out


def draw_lines(img: np.ndarray, starts, ends, color=(0, 255, 0)) -> np.ndarray:
    """Draw line segments between (row, col) endpoint arrays."""
    out = _ensure_rgb(img)
    h, w, _ = out.shape
    color = np.array(color, np.uint8)
    starts = np.asarray(starts).reshape(-1, 2)
    ends = np.asarray(ends).reshape(-1, 2)
    for (r0, c0), (r1, c1) in zip(starts, ends):
        n = int(max(abs(r1 - r0), abs(c1 - c0), 1)) + 1
        rr = np.linspace(r0, r1, n).round().astype(int)
        cc = np.linspace(c0, c1, n).round().astype(int)
        ok = (rr >= 0) & (rr < h) & (cc >= 0) & (cc < w)
        out[rr[ok], cc[ok]] = color
    return out


def join_right(img1: np.ndarray, img2: np.ndarray) -> np.ndarray:
    """Horizontal concat (Matrix.JoinRight, LinearAlgebra/Matrix.cs) for
    side-by-side match visualizations."""
    a = _ensure_rgb(img1)
    b = _ensure_rgb(img2)
    h = max(a.shape[0], b.shape[0])

    def pad(x):
        if x.shape[0] < h:
            x = np.concatenate(
                [x, np.zeros((h - x.shape[0], x.shape[1], 3), np.uint8)])
        return x

    return np.concatenate([pad(a), pad(b)], axis=1)


def scatter_plot(xs, ys, size=(480, 640), color=(30, 90, 200),
                 dot: int = 1) -> np.ndarray:
    """Rasterize a 2-D scatter into an RGB image (dependency-free).

    The reference dumps ScottPlot scatter PNGs of the triangulated points as
    pose-estimation diagnostics (CameraPoseEstimation.cs:141,177-193); this is
    the framework's equivalent: auto-scaled axes drawn on a white canvas, one
    ``(2*dot+1)``-square per point.  Pure NumPy — visualization is host work.
    """
    h, w = size
    out = np.full((h, w, 3), 255, np.uint8)
    xs = np.asarray(xs, np.float64).reshape(-1)
    ys = np.asarray(ys, np.float64).reshape(-1)
    ok = np.isfinite(xs) & np.isfinite(ys)
    xs, ys = xs[ok], ys[ok]
    margin = 24
    out[margin, margin:w - margin] = (0, 0, 0)          # y-axis baseline
    out[margin:h - margin, margin] = (0, 0, 0)          # x-axis
    out[h - margin - 1, margin:w - margin] = (0, 0, 0)
    out[margin:h - margin, w - margin - 1] = (0, 0, 0)
    if xs.size == 0:
        return out
    x0, x1 = float(xs.min()), float(xs.max())
    y0, y1 = float(ys.min()), float(ys.max())
    sx = (w - 2 * margin - 1) / max(x1 - x0, 1e-12)
    sy = (h - 2 * margin - 1) / max(y1 - y0, 1e-12)
    cc = (margin + (xs - x0) * sx).round().astype(int)
    rr = (h - 1 - margin - (ys - y0) * sy).round().astype(int)
    color = np.array(color, np.uint8)
    for dr in range(-dot, dot + 1):
        for dc in range(-dot, dot + 1):
            r = np.clip(rr + dr, 0, h - 1)
            c = np.clip(cc + dc, 0, w - 1)
            out[r, c] = color
    return out
