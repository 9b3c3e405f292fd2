"""Lens-distortion calibration: fit the rational radial model's
coefficients from images of straight edges (port of
photogrammetry_tpu/ops/calibrate.py).

Plumb-line method: straight world lines must stay straight after
undistortion, so the coefficients are those that minimize the summed
squared distance of undistorted edge points to their best-fit lines.

Every stage is fixed-shape tensor code on the inputs' device, with no host
read inside a loop:

  * edge extraction: Sobel magnitude (two 3x3 stencils as shifted adds),
    the N strongest edge points;
  * line finding: a Hough transform whose vote stage is an (N x THETA)
    outer product followed by one scatter-add into the (THETA, RHO)
    accumulator (out-of-range votes go to a spare column that is cut off,
    never clamped into range), peaks picked greedily with a suppression
    window;
  * model fit: Levenberg-Marquardt over the (5,) coefficient vector with
    residuals = point-to-line distances after undistortion, the Jacobian by
    forward-mode autodiff (``torch.func.jacfwd``), a static iteration count
    with accept/reject as ``torch.where``, and per-line best-fit lines
    recomputed in closed form inside every residual evaluation.

Ties (Sobel magnitudes and Hough votes tie on synthetic grids) resolve to
the lower index, as ``lax.top_k`` and ``jnp.argmax`` do: the top-k here is
a stable descending sort.

Forward model: rd = r * f(r),
    f(r) = (1 + k1 r + k2 r^2) / (1 + k3 r + k4 r^2 + k5 r^3).
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch

from photogrammetry_tpu_torch.ops.dewarp import (
    _f32, _guard, solve_undistorted_radius,
)

_EPS = 1e-12


def undistort_points(xy: torch.Tensor, coeffs, center) -> torch.Tensor:
    """Captured (distorted) (..., 2) (row, col) points -> undistorted.

    The reference's camera has barrel distortion, so its dewarp expands
    content: a feature captured at sensor radius r appears at radius
    rd = r * f(r) in the dewarped image.  Undistorting a captured point is
    therefore the direct forward evaluation: no root solve, closed form,
    cheaply differentiable (this is what the plumb-line fit iterates).
    """
    k1, k2, k3, k4, k5 = _f32(coeffs, xy.device).unbind()
    center = _f32(center, xy.device)
    d = xy - center
    r = torch.sqrt((d * d).sum(-1) + _EPS)
    f = (1.0 + k1 * r + k2 * r ** 2) / (1.0 + k3 * r + k4 * r ** 2
                                        + k5 * r ** 3)
    return center + d * f[..., None]


def _inverse_radius_diff(rd: torch.Tensor, coeffs: torch.Tensor,
                         newton_steps: int = 2) -> torch.Tensor:
    """Differentiable inverse radius (undistorted rd -> captured r).

    The closed-form cubic solve gives NaN gradients, so the root is taken
    on detached inputs and refined with Newton steps through the forward
    model: at a converged root that is the implicit-function gradient
    dr/dk, and it also polishes the f32 root.
    """
    k1, k2, k3, k4, k5 = coeffs.unbind()
    r = solve_undistorted_radius(rd.detach(), coeffs.detach())
    for _ in range(newton_steps):
        num = 1.0 + k1 * r + k2 * r ** 2
        den = 1.0 + k3 * r + k4 * r ** 2 + k5 * r ** 3
        dnum = k1 + 2.0 * k2 * r
        dden = k3 + 2.0 * k4 * r + 3.0 * k5 * r ** 2
        g = r * num / den - rd
        gp = (num + r * dnum) / den - r * num * dden / (den * den)
        r = r - g / _guard(gp, 1e-6)
    return r


def distort_points(xy: torch.Tensor, coeffs, center) -> torch.Tensor:
    """Undistorted (world) (..., 2) points -> captured (distorted), via the
    closed-form cubic with a differentiable Newton polish: the camera's own
    contraction, used to synthesize distorted fixtures and to project
    undistorted geometry back into captured frames."""
    center = _f32(center, xy.device)
    d = xy - center
    rd = torch.sqrt((d * d).sum(-1) + _EPS)
    r = _inverse_radius_diff(rd, _f32(coeffs, xy.device))
    return center + d * (r / rd)[..., None]


def _brown_g(r2, k1, k2, k3):
    return 1.0 + k1 * r2 + k2 * r2 ** 2 + k3 * r2 ** 3


def undistort_points_brown(xy: torch.Tensor, coeffs, center) -> torch.Tensor:
    """Brown even-power model: undistorted = distorted * g(r),
    g = 1 + k1 r^2 + k2 r^4 + k3 r^6.  coeffs: (5,) with
    [k1, k2, k3, unused, unused]."""
    k1, k2, k3 = _f32(coeffs, xy.device)[:3].unbind()
    center = _f32(center, xy.device)
    d = xy - center
    r2 = (d * d).sum(-1) + _EPS
    return center + d * _brown_g(r2, k1, k2, k3)[..., None]


def distort_points_brown(xy: torch.Tensor, coeffs, center,
                         newton_steps: int = 12) -> torch.Tensor:
    """Inverse Brown model (undistorted -> distorted): Newton on
    h(r) = r g(r) - r0 from r = r0, differentiable through the iteration."""
    k1, k2, k3 = _f32(coeffs, xy.device)[:3].unbind()
    center = _f32(center, xy.device)
    d = xy - center
    r0 = torch.sqrt((d * d).sum(-1) + _EPS)
    r = r0
    for _ in range(newton_steps):
        g = _brown_g(r * r, k1, k2, k3)
        gp = 2.0 * k1 * r + 4.0 * k2 * r ** 3 + 6.0 * k3 * r ** 5
        h = r * g - r0
        r = r - h / _guard(g + r * gp, 1e-6)
    return center + d * (r / r0)[..., None]


def line_residuals(points: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Signed distances of (L, P, 2) points to each group's best-fit
    (total-least-squares) line; masked points contribute zero.

    The line's normal comes from the principal-axis half angle
    phi = 0.5 atan2(2 sxy, sxx - syy), n = (-sin phi, cos phi), which is
    free of the cancellation an eigenvector difference suffers on
    axis-aligned lines.
    """
    w = mask.to(torch.float32)
    cnt = torch.clamp(w.sum(1, keepdim=True), min=1.0)           # (L, 1)
    mean = (points * w[..., None]).sum(1, keepdim=True) / cnt[..., None]
    d = (points - mean) * w[..., None]                           # (L, P, 2)
    sxx = (d[..., 0] ** 2).sum(1)
    syy = (d[..., 1] ** 2).sum(1)
    sxy = (d[..., 0] * d[..., 1]).sum(1)
    phi = 0.5 * torch.atan2(2.0 * sxy, sxx - syy)
    n = torch.stack([-torch.sin(phi), torch.cos(phi)], -1)       # (L, 2)
    return (d * n[:, None, :]).sum(-1)                           # (L, P)


class CalibrationResult(NamedTuple):
    coeffs: torch.Tensor        # (5,) fitted coefficients (model-dependent)
    cost: torch.Tensor          # final sum of squared line residuals
    initial_cost: torch.Tensor


class ImageCalibration(NamedTuple):
    """``calibrate_from_image``'s result: the CalibrationResult fields and
    the distortion model the coefficients belong to."""
    coeffs: torch.Tensor
    cost: torch.Tensor
    initial_cost: torch.Tensor
    model: str


def calibrate_distortion(points: torch.Tensor, mask: torch.Tensor, center,
                         init_coeffs=None, param_mask=None,
                         num_iterations: int = 30,
                         init_lambda: float = 1e-3,
                         radius_scale: float = 1000.0,
                         model: str = "rational") -> CalibrationResult:
    """Plumb-line LM fit of the distortion coefficients, on ``points``'
    device.

    model="rational" fits the 5-parameter rational radial model;
    model="brown" the even-power Brown model (coefficients in slots [0:3]).

    Args:
      points: (L, P, 2) distorted (row, col) edge points grouped by line.
      mask: (L, P) validity.
      center: (2,) distortion center (row, col).
      init_coeffs: (5,) start, default zeros (identity mapping).
      param_mask: (5,) floats; 0 freezes a coefficient.  Defaults to the
        numerator pair [k1, k2] (rational; the well-conditioned subset for
        plumb-line data) or [k1, k2, k3] (brown).
      radius_scale: coefficient i scales a radius power, so raw gradients
        differ by ~r^4 across parameters; the fit runs on
        k_i' = k_i * radius_scale^power_i.
    """
    if model == "rational":
        powers = [1.0, 2.0, 3.0, 4.0, 5.0]
        undist = undistort_points
        default_mask = [1.0, 1.0, 0.0, 0.0, 0.0]
    elif model == "brown":
        powers = [2.0, 4.0, 6.0, 1.0, 1.0]     # multiply r^2, r^4, r^6
        undist = undistort_points_brown
        default_mask = [1.0, 1.0, 1.0, 0.0, 0.0]
    else:
        raise ValueError(f"unknown model {model!r}")
    points = points.to(torch.float32)
    init_coeffs = _f32([0.0] * 5 if init_coeffs is None else init_coeffs,
                       points.device)
    param_mask = _f32(default_mask if param_mask is None else param_mask,
                      points.device)
    center = _f32(center, points.device)
    w = mask.to(torch.float32)
    scale = _f32(radius_scale, points.device) \
        ** _f32(powers, points.device)                            # (5,)

    rd = torch.sqrt(((points - center) ** 2).sum(-1) + _EPS)
    wsum = torch.clamp(w.sum(), min=1.0)

    def resid(scaled):
        und = undist(points, scaled / scale, center)
        # scale-invariance guard: the plumb-line cost alone can shrink by
        # pulling every undistorted point toward the center without
        # straightening anything; dividing by the mean radial contraction
        # removes that gauge
        ru = torch.sqrt(((und - center) ** 2).sum(-1) + _EPS)
        contraction = (ru / rd * w).sum() / wsum
        return (line_residuals(und, mask) * w).reshape(-1) / contraction

    def cost_of(scaled):
        r = resid(scaled)
        return 0.5 * (r * r).sum()

    jac = torch.func.jacfwd(resid)
    eye = torch.eye(5, device=points.device)
    theta = init_coeffs * scale
    cost0 = cost = cost_of(theta)
    lam = _f32(init_lambda, points.device)
    for _ in range(num_iterations):
        r = resid(theta)
        j = jac(theta) * param_mask[None, :]                     # (L*P, 5)
        jtj = j.T @ j
        g = j.T @ r
        a = jtj + lam * torch.diag(torch.diag(jtj)) + 1e-8 * eye
        # solve_ex: no host read of the LU's status inside the loop
        step = -torch.linalg.solve_ex(a, g).result * param_mask
        cand = theta + step
        new_cost = cost_of(cand)
        accept = new_cost < cost
        theta = torch.where(accept, cand, theta)
        cost = torch.where(accept, new_cost, cost)
        lam = torch.where(accept, torch.clamp(lam * 0.3, min=1e-10),
                          torch.clamp(lam * 5.0, max=1e8))
    return CalibrationResult(coeffs=theta / scale, cost=cost,
                             initial_cost=cost0)


# ---------------------------------------------------------------------------
# Edge + line extraction (for the CLI's automatic mode)
# ---------------------------------------------------------------------------

def _top_k(values: torch.Tensor, k: int):
    """The ``k`` largest along the last axis, ties to the lower index (a
    stable descending sort; ``torch.topk`` leaves the tie order open)."""
    val, idx = torch.sort(values, dim=-1, descending=True, stable=True)
    return val[..., :k], idx[..., :k]


def sobel_magnitude(image: torch.Tensor) -> torch.Tensor:
    """Sobel gradient magnitude of an (H, W) grayscale image (zero border)."""
    img = image.to(torch.float32)

    def sh(dr, dc):
        return torch.roll(img, (dr, dc), dims=(0, 1))

    gx = (sh(-1, -1) + 2 * sh(0, -1) + sh(1, -1)
          - sh(-1, 1) - 2 * sh(0, 1) - sh(1, 1))
    gy = (sh(-1, -1) + 2 * sh(-1, 0) + sh(-1, 1)
          - sh(1, -1) - 2 * sh(1, 0) - sh(1, 1))
    mag = torch.sqrt(gx * gx + gy * gy)
    mag[0, :] = 0.0
    mag[-1, :] = 0.0
    mag[:, 0] = 0.0
    mag[:, -1] = 0.0
    return mag


class HoughLines(NamedTuple):
    theta: torch.Tensor   # (L,) line normal angle
    rho: torch.Tensor     # (L,) signed distance from image center
    votes: torch.Tensor   # (L,) accumulator peak height


def extract_edge_points(image: torch.Tensor, num_points: int = 4096):
    """(N, 2) absolute (row, col) coordinates of the strongest Sobel edges
    and their (N,) magnitudes (zero-magnitude entries are padding)."""
    mag = sobel_magnitude(image)
    w = mag.shape[1]
    val, idx = _top_k(mag.reshape(-1), num_points)
    pts = torch.stack([(idx // w).to(torch.float32),
                       (idx % w).to(torch.float32)], dim=-1)
    return pts, val


def hough_from_points(points: torch.Tensor, weights: torch.Tensor, center,
                      extent: float, num_thetas: int = 180,
                      num_rhos: int = 512, num_lines: int = 8,
                      suppress: float = 0.05) -> HoughLines:
    """Top-``num_lines`` Hough peaks from binary point votes.

    Each point with ``weights > 0`` casts one unweighted vote per theta
    (magnitudes only gate participation: one point, one vote favors long
    lines, which is what the plumb-line fit wants).  rho is measured from
    ``center``; ``extent`` bounds |rho|.  Peaks are picked greedily with a
    suppression window (fraction ``suppress`` of each axis, wrapping theta
    since (theta + pi, -rho) is the same line).
    """
    dev = points.device
    center = _f32(center, points.device)
    cr = points[..., 0] - center[0]
    cc = points[..., 1] - center[1]
    pw = (weights > 0).to(torch.float32)

    thetas = torch.arange(num_thetas, dtype=torch.float32, device=dev) \
        * (math.pi / num_thetas)
    rho = cr[:, None] * torch.cos(thetas)[None, :] \
        + cc[:, None] * torch.sin(thetas)[None, :]
    rbin = torch.round((rho / extent * 0.5 + 0.5)
                       * (num_rhos - 1)).to(torch.int64)
    tbin = torch.arange(num_thetas, device=dev)[None, :].expand_as(rbin)
    # out-of-range votes land in the spare column num_rhos, cut off below
    rbin = torch.where((rbin < 0) | (rbin >= num_rhos), num_rhos, rbin)
    acc = torch.zeros((num_thetas * (num_rhos + 1),), dtype=torch.float32,
                      device=dev)
    acc.index_add_(0, (tbin * (num_rhos + 1) + rbin).reshape(-1),
                   pw[:, None].expand_as(rbin).reshape(-1))
    acc = acc.view(num_thetas, num_rhos + 1)[:, :num_rhos].contiguous()

    st = max(1, int(num_thetas * suppress))
    sr = max(1, int(num_rhos * suppress))
    tt = torch.arange(num_thetas, device=dev)
    rr = torch.arange(num_rhos, device=dev)
    tis, ris, vs = [], [], []
    for _ in range(num_lines):
        p = torch.argmax(acc)           # the first of tied maxima
        ti, ri = p // num_rhos, p % num_rhos
        vs.append(acc.reshape(-1)[p])
        tis.append(ti)
        ris.append(ri)
        dt = torch.minimum((tt - ti).abs(), num_thetas - (tt - ti).abs())
        near = (dt[:, None] <= st) & ((rr[None, :] - ri).abs() <= sr)
        acc = torch.where(near, 0.0, acc)
    theta = torch.stack(tis).to(torch.float32) * (math.pi / num_thetas)
    rho = (torch.stack(ris).to(torch.float32) / (num_rhos - 1) - 0.5) \
        * 2.0 * extent
    return HoughLines(theta=theta, rho=rho, votes=torch.stack(vs))


def assign_points_to_lines(points: torch.Tensor, weights: torch.Tensor,
                           lines: HoughLines, center, tol: float = 4.0,
                           points_per_line: int = 512):
    """Group points to their nearest Hough line (within ``tol``).

    Returns (L, P) int64 indices into ``points`` and an (L, P) mask, fixed
    capacity ``points_per_line`` per line (strongest first).  Each point
    joins at most one line (its nearest).
    """
    center = _f32(center, points.device)
    cr = points[..., 0] - center[0]
    cc = points[..., 1] - center[1]
    d = (cr[None, :] * torch.cos(lines.theta)[:, None]
         + cc[None, :] * torch.sin(lines.theta)[:, None]
         - lines.rho[:, None]).abs()                       # (L, N)
    nearest = torch.argmin(d, dim=0)                       # (N,)
    lidx = torch.arange(d.shape[0], device=d.device)
    ok = (d <= tol) & (nearest[None, :] == lidx[:, None]) \
        & (weights > 0)[None, :]
    score = torch.where(ok, weights[None, :], -1.0)
    top, ti = _top_k(score, points_per_line)               # (L, P)
    return ti, top > 0


def calibrate_from_image(image, num_lines: int = 8, tol: float = 4.0,
                         num_points: int = 4096, points_per_line: int = 512,
                         rounds: int = 3, num_iterations: int = 30,
                         param_mask=None,
                         model: str = "rational") -> ImageCalibration:
    """Grayscale image tensor of straight edges -> fitted coefficients.

    Alternates line extraction and model fitting: each round undistorts the
    edge points with the current coefficients, finds lines by Hough +
    nearest assignment in the undistorted frame (where world lines are
    straight, so strongly curved edges still collect into one bin), then
    refits the coefficients against the original distorted coordinates.

    model: "rational", "brown", or "auto": fit both and keep whichever
    leaves the lines straighter (lower final cost).
    """
    if model == "auto":
        fits = [calibrate_from_image(image, num_lines=num_lines, tol=tol,
                                     num_points=num_points,
                                     points_per_line=points_per_line,
                                     rounds=rounds,
                                     num_iterations=num_iterations,
                                     param_mask=param_mask, model=m)
                for m in ("rational", "brown")]
        return min(fits, key=lambda r: float(r.cost))

    undist = undistort_points if model == "rational" \
        else undistort_points_brown
    h, w = image.shape
    center = _f32([h / 2.0, w / 2.0], image.device)
    extent = math.hypot(h / 2.0, w / 2.0)
    pts, val = extract_edge_points(image, num_points=num_points)

    coeffs = torch.zeros(5, device=image.device)
    result = None
    for _ in range(max(1, rounds)):
        und = undist(pts, coeffs, center)
        lines = hough_from_points(und, val, center, extent,
                                  num_lines=num_lines)
        ti, mask = assign_points_to_lines(und, val, lines, center, tol=tol,
                                          points_per_line=points_per_line)
        result = calibrate_distortion(pts[ti], mask, center,
                                      init_coeffs=coeffs,
                                      num_iterations=num_iterations,
                                      param_mask=param_mask, model=model)
        coeffs = result.coeffs
    return ImageCalibration(result.coeffs, result.cost,
                            result.initial_cost, model)
