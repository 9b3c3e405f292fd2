"""Plain reference of the lens dewarp stage: the rational radial model's
inverse map and the bilinear remap, and the synthetic capture that makes a
lens's raw frames from clean ones.

Model (the port's ``ops/dewarp.py`` documents it): rd = r f(r) with
f(r) = (1 + k1 r + k2 r^2) / (1 + k3 r + k4 r^2 + k5 r^3).  The dewarp map
sends output pixel (u, v), at integer-truncated offsets (x, y) from the
centre (H/2, W/2) and radius rd, to the source (x, y) r / rd + centre,
where r solves (k2 - rd k5) r^3 + (k1 - rd k4) r^2 + (1 - rd k3) r - rd = 0
(the middle of three real roots, else the only one), or its quadratic or
linear form where the cubic term is under 1e-4 of the others.  The remap
takes four taps weighted by the fractional parts, each tap zero outside
the source.  ``dtype`` is the arithmetic's precision: float64 for the
reference, bfloat16 for the control.
"""
from __future__ import annotations

import math

import torch


def _cubic_middle_root(b, c, d):
    """The middle real root of r^3 + b r^2 + c r + d = 0 where there are
    three, else the one real root."""
    p = c - b * b / 3.0
    q = 2.0 * b ** 3 / 27.0 - b * c / 3.0 + d
    shift = -b / 3.0
    disc = -4.0 * p ** 3 - 27.0 * q * q
    p_neg = torch.clamp(p, max=-1e-30)
    m = 2.0 * torch.sqrt(-p_neg / 3.0)
    theta = torch.acos(torch.clamp(3.0 * q / (p_neg * m), -1.0, 1.0)) / 3.0
    k = torch.arange(3, device=b.device).to(b.dtype)
    roots3 = m[..., None] * torch.cos(theta[..., None]
                                      - 2.0 * math.pi * k / 3.0)
    mid = roots3.sum(-1) - roots3.min(-1).values - roots3.max(-1).values
    sq = torch.sqrt(torch.clamp(q * q / 4.0 + p ** 3 / 27.0, min=0.0))

    def cbrt(x):
        return torch.sign(x) * torch.abs(x) ** (1.0 / 3.0)

    one = cbrt(-q / 2.0 + sq) + cbrt(-q / 2.0 - sq)
    return torch.where(disc > 0, mid, one) + shift


def _guard(x, eps):
    return torch.where(x.abs() < eps, torch.where(x < 0, -eps, eps), x)


def dewarp_map(h: int, w: int, coeffs, device,
               dtype=torch.float64) -> torch.Tensor:
    """(H, W, 2) source (row, col) of each output pixel."""
    k1, k2, k3, k4, k5 = (torch.tensor(float(c), dtype=dtype, device=device)
                          for c in coeffs)
    x = torch.trunc(torch.arange(h, device=device).to(dtype)
                    - h / 2.0)[:, None].expand(h, w)
    y = torch.trunc(torch.arange(w, device=device).to(dtype)
                    - w / 2.0)[None, :].expand(h, w)
    rd = torch.sqrt(x * x + y * y)
    a_lead = k2 - rd * k5
    b_lead = k1 - rd * k4
    c_lin = 1.0 - rd * k3
    den = _guard(-a_lead, 1e-12)
    r_cubic = _cubic_middle_root(-b_lead / den, -c_lin / den, rd / den)
    disc_q = torch.clamp(c_lin * c_lin + 4.0 * b_lead * rd, min=0.0)
    r_quad = 2.0 * rd / _guard(c_lin + torch.sqrt(disc_q), 1e-9)
    cubic = a_lead.abs() * rd ** 3 > 1e-4 * (b_lead.abs() * rd ** 2
                                            + c_lin.abs() * rd + rd)
    r = torch.where(rd <= 0, torch.zeros_like(rd),
                    torch.where(cubic, r_cubic, r_quad))
    scale = torch.where(rd > 0, r / torch.clamp(rd, min=1e-12),
                        torch.ones_like(rd))
    return torch.stack([x * scale + h / 2.0, y * scale + w / 2.0], -1)


def capture_map(h: int, w: int, coeffs, device,
                dtype=torch.float32) -> torch.Tensor:
    """(H, W, 2): the map that makes what the lens captures from a clean
    frame: a captured pixel at radius r from the centre samples the clean
    frame at radius r f(r)."""
    k1, k2, k3, k4, k5 = (float(c) for c in coeffs)
    x = (torch.arange(h, device=device).to(dtype) - h / 2.0)[:, None]
    y = (torch.arange(w, device=device).to(dtype) - w / 2.0)[None, :]
    x, y = torch.broadcast_tensors(x, y)
    r = torch.sqrt(x * x + y * y)
    f = (1.0 + k1 * r + k2 * r ** 2) / (1.0 + k3 * r + k4 * r ** 2
                                        + k5 * r ** 3)
    return torch.stack([x * f + h / 2.0, y * f + w / 2.0], -1)


def remap(frames: torch.Tensor, dmap: torch.Tensor) -> torch.Tensor:
    """(B, H, W) frames through an (H, W, 2) map of source (row, col),
    bilinear, each tap zero outside the source, in the map's dtype."""
    _, h, w = frames.shape
    img = frames.to(dmap.dtype)
    sr = torch.where(torch.isfinite(dmap[..., 0]), dmap[..., 0], -2.0)
    sc = torch.where(torch.isfinite(dmap[..., 1]), dmap[..., 1], -2.0)
    r0, c0 = torch.floor(sr), torch.floor(sc)
    fr, fc = sr - r0, sc - c0
    r0 = torch.clamp(r0.float(), -2, h).to(torch.int64)
    c0 = torch.clamp(c0.float(), -2, w).to(torch.int64)
    out = torch.zeros(img.shape, dtype=img.dtype, device=img.device)
    for dr, dc, wt in ((0, 0, (1 - fr) * (1 - fc)), (0, 1, (1 - fr) * fc),
                       (1, 0, fr * (1 - fc)), (1, 1, fr * fc)):
        rr, cc = r0 + dr, c0 + dc
        inside = (rr >= 0) & (rr < h) & (cc >= 0) & (cc < w)
        tap = img[:, rr.clamp(0, h - 1), cc.clamp(0, w - 1)]
        out = out + torch.where(inside, tap, 0.0) * wt
    return out


def capture(frames_u8: torch.Tensor, coeffs) -> torch.Tensor:
    """Clean uint8 (B, H, W) frames as the lens with ``coeffs`` captures
    them: uint8, rounded half to even."""
    _, h, w = frames_u8.shape
    out = remap(frames_u8, capture_map(h, w, coeffs, frames_u8.device))
    return torch.round(out).to(torch.uint8)
