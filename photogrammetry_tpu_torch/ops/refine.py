"""Subpixel keypoint refinement (port of photogrammetry_tpu/ops/refine.py).

The cornerSubPix normal equation q = (sum g g^T)^-1 (sum g g^T x).
``refine_subpixel`` gathers each keypoint's (2w+1)^2 window of gradients;
``refine_subpixel_dense`` (the frontend's) takes the windowed sums densely
for every pixel as box filters of gradient products, and each iteration
then gathers 5 values per keypoint.
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


def _gradients(img: torch.Tensor):
    """Central-difference (gy, gx) of an (H, W) float32 image, zero at the
    border."""
    gy = torch.zeros_like(img)
    gy[1:-1, :] = (img[2:, :] - img[:-2, :]) / 2.0
    gx = torch.zeros_like(img)
    gx[:, 1:-1] = (img[:, 2:] - img[:, :-2]) / 2.0
    return gy, gx


def _solve_step(q, a, b, c, br, bc):
    """One normal-equation update of (N, 2) positions ``q``; an
    ill-conditioned (flat) window keeps its position."""
    det = a * c - b * b
    ok = det.abs() > 1e-6
    det_safe = torch.where(ok, det, 1.0)
    qr = (c * br - b * bc) / det_safe
    qc = (a * bc - b * br) / det_safe
    return torch.where(ok[:, None], torch.stack([qr, qc], dim=-1), q)


def refine_subpixel(image: torch.Tensor, coords: torch.Tensor,
                    window: int = 3, iterations: int = 2) -> torch.Tensor:
    """(H, W) image + (N, 2) int (row, col) → (N, 2) float32 refined
    (row, col), each iteration gathering the (2 window + 1)^2 gradients
    around the current position; clamped to within 1.5 px of the
    detection."""
    h, w = image.shape
    gy, gx = _gradients(image.to(torch.float32))
    offs = torch.arange(-window, window + 1, device=image.device)
    orr, occ = torch.meshgrid(offs, offs, indexing="ij")
    orr, occ = orr.reshape(-1), occ.reshape(-1)

    def step(q):
        # torch.round rounds half to even, as jnp.round does
        rr = torch.clamp(torch.round(q[:, 0]).to(torch.int64)[:, None] + orr,
                         0, h - 1)
        cc = torch.clamp(torch.round(q[:, 1]).to(torch.int64)[:, None] + occ,
                         0, w - 1)
        gyy, gxx = gy[rr, cc], gx[rr, cc]
        xr, xc = rr.to(torch.float32), cc.to(torch.float32)
        return _solve_step(
            q, (gyy * gyy).sum(1), (gyy * gxx).sum(1), (gxx * gxx).sum(1),
            (gyy * gyy * xr + gyy * gxx * xc).sum(1),
            (gxx * gyy * xr + gxx * gxx * xc).sum(1))

    q0 = coords.to(torch.float32)
    q = q0
    for _ in range(iterations):
        q = step(q)
    return q0 + torch.clamp(q - q0, -1.5, 1.5)


def refine_subpixel_dense(image: torch.Tensor, coords: torch.Tensor,
                          window: int = 3,
                          iterations: int = 2) -> torch.Tensor:
    """(H, W) image + (N, 2) int (row, col) → (N, 2) float32 refined
    (row, col), clamped to within 1.5 px of the detection."""
    h, w = image.shape
    img = image.to(torch.float32)
    gy, gx = _gradients(img)
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
        return _solve_step(q, *maps[:, br_ * w + bc_])   # 5 x (N,)

    q0 = coords.to(torch.float32)
    q = q0
    for _ in range(iterations):
        q = step(q)
    return q0 + torch.clamp(q - q0, -1.5, 1.5)
