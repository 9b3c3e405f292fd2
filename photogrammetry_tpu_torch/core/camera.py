"""Pinhole camera model (port of photogrammetry_tpu/core/camera.py).

Image points are (x, y) = (col, row) pixel coordinates; detector output
(row, col) is converted with ``keypoints_to_xy``.
"""
from __future__ import annotations

import torch


def intrinsic_matrix(fx, fy, cx, cy, device="cpu") -> torch.Tensor:
    return torch.tensor([[fx, 0.0, cx], [0.0, fy, cy], [0.0, 0.0, 1.0]],
                        dtype=torch.float32, device=device)


def keypoints_to_xy(coords: torch.Tensor) -> torch.Tensor:
    """(N, 2) (row, col) detector coords → (N, 2) (x, y) pixel coords."""
    return torch.stack([coords[..., 1], coords[..., 0]],
                       dim=-1).to(torch.float32)


def to_homogeneous(pts: torch.Tensor) -> torch.Tensor:
    """(…, D) → (…, D+1) with a trailing 1."""
    return torch.cat([pts, torch.ones_like(pts[..., :1])], dim=-1)


def normalize_pixels(xy: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """Pixel coords (…, 2) → normalized camera coords (…, 2) via K^-1."""
    fx, fy = k[0, 0], k[1, 1]
    cx, cy = k[0, 2], k[1, 2]
    s = k[0, 1]
    y = (xy[..., 1] - cy) / fy
    x = (xy[..., 0] - cx - s * y) / fx
    return torch.stack([x, y], dim=-1)
