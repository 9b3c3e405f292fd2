"""Closed-form real roots of monic cubics, elementwise (port of
photogrammetry_tpu/core/cubic.py).

Every element's cubic is solved at once: the trigonometric method where
three real roots exist, Cardano where one does, both evaluated and selected
with ``torch.where`` (no data-dependent control flow, no host read).  torch
has no ``cbrt``; ``sign(x) * |x|^(1/3)`` stands in for it and is not
bit-equal to ``jnp.cbrt``, so roots agree with the JAX package's to f32
rounding amplified by the cubic's conditioning, not bit for bit.
"""
from __future__ import annotations

import math

import torch

_EPS = 1e-30


def _as_f32(x, like: torch.Tensor | None = None) -> torch.Tensor:
    dev = like.device if like is not None else (
        x.device if isinstance(x, torch.Tensor) else None)
    return torch.as_tensor(x, dtype=torch.float32, device=dev)


def _cbrt(x: torch.Tensor) -> torch.Tensor:
    return torch.sign(x) * torch.abs(x) ** (1.0 / 3.0)


def solve_cubic_real(b, c, d):
    """Real roots of r^3 + b r^2 + c r + d = 0 over broadcast float32 args.

    Returns (roots (..., 3) float32, num_real (...,) int32).  A single real
    root is replicated across the three slots.  Roots are not sorted; see
    ``middle_real_root`` for the selection rule of the dewarp.
    """
    b = _as_f32(b)
    c = _as_f32(c, b)
    d = _as_f32(d, b)
    b, c, d = torch.broadcast_tensors(b, c, d)

    # depressed cubic t^3 + p t + q with r = t - b/3
    p = c - b * b / 3.0
    q = 2.0 * b ** 3 / 27.0 - b * c / 3.0 + d
    shift = -b / 3.0
    disc = -4.0 * p ** 3 - 27.0 * q * q   # > 0: three distinct real roots

    # three real roots (p < 0 whenever disc > 0)
    p_neg = torch.clamp(p, max=-_EPS)
    m = 2.0 * torch.sqrt(-p_neg / 3.0)
    theta = torch.acos(torch.clamp(3.0 * q / (p_neg * m), -1.0, 1.0)) / 3.0
    k = torch.arange(3, dtype=torch.float32, device=b.device)
    t_trig = m[..., None] * torch.cos(theta[..., None]
                                      - 2.0 * math.pi * k / 3.0)

    # one real root (Cardano)
    sq = torch.sqrt(torch.clamp(q * q / 4.0 + p ** 3 / 27.0, min=0.0))
    t_card = _cbrt(-q / 2.0 + sq) + _cbrt(-q / 2.0 - sq)

    three = disc > 0
    roots = torch.where(three[..., None], t_trig,
                        t_card[..., None].expand_as(t_trig)) \
        + shift[..., None]
    return roots, torch.where(three, 3, 1).to(torch.int32)


def middle_real_root(b, c, d) -> torch.Tensor:
    """The middle of three real roots, else the single real root."""
    roots, num_real = solve_cubic_real(b, c, d)
    lo = roots.min(dim=-1).values
    hi = roots.max(dim=-1).values
    mid = roots.sum(dim=-1) - lo - hi
    return torch.where(num_real == 3, mid, roots[..., 0])
