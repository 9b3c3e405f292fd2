"""SO(3)/SE(3) Lie group operations (port of photogrammetry_tpu/core/lie.py).

Batched over any leading dimensions; the small-angle Taylor branches are
``torch.where`` selects, so nothing reads the device.  As in the JAX
package, ``so3_log`` has no separate near-pi branch: its vee-based formula
degrades there, and BA/pose-graph increments stay far from pi.
"""
from __future__ import annotations

import torch

_EPS = 1e-8


def so3_hat(w: torch.Tensor) -> torch.Tensor:
    """(…, 3) → (…, 3, 3) skew-symmetric matrix."""
    wx, wy, wz = w[..., 0], w[..., 1], w[..., 2]
    z = torch.zeros_like(wx)
    return torch.stack([
        torch.stack([z, -wz, wy], -1),
        torch.stack([wz, z, -wx], -1),
        torch.stack([-wy, wx, z], -1),
    ], -2)


def so3_exp(w: torch.Tensor) -> torch.Tensor:
    """Axis-angle (…, 3) → rotation matrix (…, 3, 3) (Rodrigues)."""
    theta2 = (w * w).sum(-1)
    theta = torch.sqrt(torch.clamp(theta2, min=_EPS ** 2))
    small = theta2 < _EPS
    a = torch.where(small, 1.0 - theta2 / 6.0, torch.sin(theta) / theta)
    b = torch.where(small, 0.5 - theta2 / 24.0,
                    (1.0 - torch.cos(theta)) / theta2)
    k = so3_hat(w)
    eye = torch.eye(3, dtype=w.dtype, device=w.device)
    return eye + a[..., None, None] * k + b[..., None, None] * (k @ k)


def so3_log(r: torch.Tensor) -> torch.Tensor:
    """Rotation matrix (…, 3, 3) → axis-angle (…, 3); theta from
    atan2(|sin|, cos), small angles by the Taylor branch."""
    trace = r[..., 0, 0] + r[..., 1, 1] + r[..., 2, 2]
    cos_t = torch.clamp((trace - 1.0) / 2.0, -1.0, 1.0)
    vee = torch.stack([
        r[..., 2, 1] - r[..., 1, 2],
        r[..., 0, 2] - r[..., 2, 0],
        r[..., 1, 0] - r[..., 0, 1],
    ], -1)
    sin_sq = (vee * vee).sum(-1) / 4.0
    sin_t = torch.sqrt(sin_sq + 1e-24)
    theta = torch.atan2(sin_t, cos_t)
    small = sin_sq < _EPS ** 2
    sin_safe = torch.where(small, torch.ones_like(sin_t), sin_t)
    scale = torch.where(small, 0.5 + theta * theta / 12.0,
                        theta / (2.0 * sin_safe))
    return scale[..., None] * vee


def se3_exp(xi: torch.Tensor):
    """Twist (…, 6) [w | v] → (R (…, 3, 3), t (…, 3))."""
    w, v = xi[..., :3], xi[..., 3:]
    r = so3_exp(w)
    theta2 = (w * w).sum(-1)
    theta = torch.sqrt(torch.clamp(theta2, min=_EPS ** 2))
    small = theta2 < _EPS
    a = torch.where(small, 0.5 - theta2 / 24.0,
                    (1.0 - torch.cos(theta)) / theta2)
    b = torch.where(small, 1.0 / 6.0 - theta2 / 120.0,
                    (theta - torch.sin(theta)) / (theta2 * theta))
    k = so3_hat(w)
    eye = torch.eye(3, dtype=xi.dtype, device=xi.device)
    vmat = eye + a[..., None, None] * k + b[..., None, None] * (k @ k)
    return r, (vmat @ v[..., None])[..., 0]


def se3_log(r: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """(R, t) → twist (…, 6) [w | v]."""
    w = so3_log(r)
    theta2 = (w * w).sum(-1) + 1e-24
    theta = torch.sqrt(theta2)
    small = theta2 < _EPS
    half = theta / 2.0
    sin_half = torch.where(small, torch.ones_like(half), torch.sin(half))
    theta2_safe = torch.where(small, torch.ones_like(theta2), theta2)
    cot_term = torch.where(
        small, 1.0 / 12.0 + theta2 / 720.0,
        (1.0 - half * torch.cos(half) / sin_half) / theta2_safe)
    k = so3_hat(w)
    eye = torch.eye(3, dtype=r.dtype, device=r.device)
    vinv = eye - 0.5 * k + cot_term[..., None, None] * (k @ k)
    return torch.cat([w, (vinv @ t[..., None])[..., 0]], dim=-1)
