"""Subpixel keypoint refinement (port of photogrammetry_tpu/ops/refine.py:
``refine_subpixel_dense`` and ``_box_filter``).

The cornerSubPix normal equation q = (sum g g^T)^-1 (sum g g^T x), with the
windowed sums taken densely for every pixel as box filters of gradient
products; each iteration then gathers 5 values per keypoint.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F


def _box_filter(x: torch.Tensor, half: int) -> torch.Tensor:
    """(..., H, W) -> same-shape (2*half+1)-box sum over the last two axes,
    zero-padded, separable.

    Direct shifted adds in the JAX order, NOT cumsum (whose ~1e10 partial
    sums of the coordinate-weighted maps lose f32 exactness) and NOT
    conv2d (another summation order, and TF32 under cuDNN)."""
    k = 2 * half + 1
    h, w = x.shape[-2:]
    p = F.pad(x, (0, 0, half, half))
    x = sum(p[..., i:i + h, :] for i in range(k))
    p = F.pad(x, (half, half, 0, 0))
    return sum(p[..., i:i + w] for i in range(k))


def refine_subpixel_dense(image: torch.Tensor, coords: torch.Tensor,
                          window: int = 3,
                          iterations: int = 2) -> torch.Tensor:
    """(H, W) image + (N, 2) int (row, col) → (N, 2) float32 refined
    (row, col), clamped to within 1.5 px of the detection."""
    h, w = image.shape
    img = image.to(torch.float32)
    gy = torch.zeros_like(img)
    gy[1:-1, :] = (img[2:, :] - img[:-2, :]) / 2.0
    gx = torch.zeros_like(img)
    gx[:, 1:-1] = (img[:, 2:] - img[:, :-2]) / 2.0
    rr = torch.arange(h, dtype=torch.float32, device=img.device)[:, None]
    cc = torch.arange(w, dtype=torch.float32, device=img.device)[None, :]
    gyy = gy * gy
    gyx = gy * gx
    gxx = gx * gx
    maps = torch.stack([
        _box_filter(gyy, window),
        _box_filter(gyx, window),
        _box_filter(gxx, window),
        _box_filter(gyy * rr + gyx * cc, window),
        _box_filter(gyx * rr + gxx * cc, window),
    ]).reshape(5, -1)  # (5, H*W)

    def step(q):
        # torch.round rounds half to even, as jnp.round does
        br_ = torch.clamp(torch.round(q[:, 0]).to(torch.int64), 0, h - 1)
        bc_ = torch.clamp(torch.round(q[:, 1]).to(torch.int64), 0, w - 1)
        a, b, c, br, bc = maps[:, br_ * w + bc_]   # 5 x (N,)
        det = a * c - b * b
        ok = det.abs() > 1e-6
        det_safe = torch.where(ok, det, 1.0)
        qr = (c * br - b * bc) / det_safe
        qc = (a * bc - b * br) / det_safe
        refined = torch.stack([qr, qc], dim=-1)
        return torch.where(ok[:, None], refined, q)

    q0 = coords.to(torch.float32)
    q = q0
    for _ in range(iterations):
        q = step(q)
    return q0 + torch.clamp(q - q0, -1.5, 1.5)
