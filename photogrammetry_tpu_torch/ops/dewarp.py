"""Lens dewarp through the rational radial distortion model (port of
photogrammetry_tpu/ops/dewarp.py).

Model: rd = r * f(r), f(r) = (1 + k1 r + k2 r^2) / (1 + k3 r + k4 r^2
+ k5 r^3).  Inverting for the undistorted radius r at each output pixel
gives the monic cubic r^3 + B r^2 + C r + D = 0 with
    B = (rd k4 - k1) / (rd k5 - k2)
    C = (rd k3 - 1)  / (rd k5 - k2)
    D =  rd          / (rd k5 - k2)
whose middle real root (else the single one) is taken.  Every pixel's cubic
is solved in closed form at once (core/cubic.py), and the polar round trip
reduces to scaling (x, y) by r / rd.

``remap_plain`` / ``apply_distortion_map`` are the plain PyTorch remap
(advanced indexing): the version the CUDA kernel in ``kernels/remap.py`` is
held against, what runs for CPU tensors, and what ``plain=True`` selects on
the card.  ``make_distortion_applier`` closes over the kernel.
"""
from __future__ import annotations

import torch

from photogrammetry_tpu_torch import resolve_device
from photogrammetry_tpu_torch.core.cubic import middle_real_root

_EPS = 1e-12


def _f32(x, device) -> torch.Tensor:
    """A list, numpy array or tensor (coefficients, a center) as a float32
    tensor on ``device``."""
    return torch.as_tensor(x, dtype=torch.float32, device=device)


def _guard(x: torch.Tensor, eps: float) -> torch.Tensor:
    """``x`` pushed away from zero to ±eps, keeping its sign (+ at 0)."""
    return torch.where(x.abs() < eps, torch.where(x < 0, -eps, eps), x)


def solve_undistorted_radius(rd: torch.Tensor, coeffs) -> torch.Tensor:
    """Undistorted radius r for distorted radius rd (elementwise).

    coeffs: (5,) [k1..k5].  Degenerate denominators (rd*k5 == k2) are
    guarded with an epsilon; rd == 0 maps to r == 0.
    """
    rd = torch.as_tensor(rd, dtype=torch.float32)
    k1, k2, k3, k4, k5 = _f32(coeffs, rd.device).unbind()
    # clearing denominators: (k2 - rd k5) r^3 + (k1 - rd k4) r^2
    #                        + (1 - rd k3) r - rd = 0
    a_lead = k2 - rd * k5
    b_lead = k1 - rd * k4
    c_lin = 1.0 - rd * k3

    den = _guard(-a_lead, _EPS)
    r_cubic = middle_real_root(-b_lead / den, -c_lin / den, rd / den)

    # degenerate leading coefficient (k2 = k5 = 0, a pure-k1 model): the
    # equation is quadratic or linear in r; the citardauq form is
    # continuous through both degeneracies (b_lead -> 0 gives rd / c_lin)
    disc_q = torch.clamp(c_lin * c_lin + 4.0 * b_lead * rd, min=0.0)
    r_quad = 2.0 * rd / _guard(c_lin + torch.sqrt(disc_q), 1e-9)

    # the cubic only where its term matters: elsewhere its 1/a_lead
    # coefficients are noise (and NaN at exactly 0)
    cubic_sig = a_lead.abs() * rd ** 3
    rest_sig = b_lead.abs() * rd ** 2 + c_lin.abs() * rd + rd
    r = torch.where(cubic_sig > 1e-4 * rest_sig, r_cubic, r_quad)
    return torch.where(rd <= 0.0, 0.0, r)


def solve_distorted_radius_brown(r0: torch.Tensor, coeffs) -> torch.Tensor:
    """Source (distorted) radius r for output (undistorted) radius r0 under
    the Brown even-power model r0 = r g(r), g = 1 + k1 r^2 + k2 r^4
    + k3 r^6: 12 Newton steps from r = r0."""
    r0 = torch.as_tensor(r0, dtype=torch.float32)
    k1, k2, k3 = _f32(coeffs, r0.device)[:3].unbind()
    r = r0
    for _ in range(12):
        r2 = r * r
        g = 1.0 + k1 * r2 + k2 * r2 ** 2 + k3 * r2 ** 3
        gp = 2.0 * k1 * r + 4.0 * k2 * r ** 3 + 6.0 * k3 * r ** 5
        h = r * g - r0
        r = r - h / _guard(g + r * gp, 1e-6)
    return torch.where(r0 <= 0.0, 0.0, r)


def _centered_grid(height: int, width: int, device, trunc: bool):
    """Offsets (x over rows, y over cols, both (H, W)) from the centre
    (H/2, W/2): x spans rows, as in the reference."""
    x0 = height / 2.0
    y0 = width / 2.0
    u = torch.arange(height, dtype=torch.float32, device=device)[:, None]
    v = torch.arange(width, dtype=torch.float32, device=device)[None, :]
    x, y = u - x0, v - y0
    if trunc:       # the reference int-truncates the centred offsets
        x, y = torch.trunc(x), torch.trunc(y)
    x, y = torch.broadcast_tensors(x, y)
    return x, y, x0, y0


def generate_distortion_map_brown(height: int, width: int, coeffs, *,
                                  device="cuda") -> torch.Tensor:
    """(H, W, 2) map for the Brown model: output (undistorted) pixel ->
    source (row, col) in the distorted input, on ``device``."""
    dev = resolve_device(device)
    x, y, x0, y0 = _centered_grid(height, width, dev, trunc=False)
    r_out = torch.sqrt(x * x + y * y)
    r_src = solve_distorted_radius_brown(r_out, coeffs)
    scale = torch.where(r_out > 0.0, r_src / torch.clamp(r_out, min=_EPS),
                        1.0)
    return torch.stack([x * scale + x0, y * scale + y0], dim=-1)


def generate_distortion_map(height: int, width: int, coeffs,
                            quantize: bool = False, *,
                            device="cuda") -> torch.Tensor:
    """(H, W, 2) float32 map on ``device``: output pixel (u, v) -> source
    (row, col).  ``quantize=True`` truncates the source coordinates to
    integers (the reference's int cast); the default keeps sub-pixel
    precision for the bilinear remap."""
    dev = resolve_device(device)
    x, y, x0, y0 = _centered_grid(height, width, dev, trunc=True)
    rd = torch.sqrt(x * x + y * y)
    r = solve_undistorted_radius(rd, _f32(coeffs, dev))
    scale = torch.where(rd > 0.0, r / torch.clamp(rd, min=_EPS), 1.0)
    src_row = x * scale + x0
    src_col = y * scale + y0
    if quantize:
        src_row = torch.trunc(src_row)
        src_col = torch.trunc(src_col)
    return torch.stack([src_row, src_col], dim=-1)


def generate_synthetic_distortion_map(height: int, width: int, coeffs, *,
                                      device="cuda") -> torch.Tensor:
    """(H, W, 2) map that synthesizes a distorted image from a clean one,
    the inverse of the dewarp: each captured-frame pixel at radius r samples
    the clean image at radius r * f(r), so ``apply_distortion_map(clean,
    this)`` is what the camera would have captured and dewarping that with
    ``generate_distortion_map(coeffs)`` recovers ``clean``."""
    dev = resolve_device(device)
    k1, k2, k3, k4, k5 = _f32(coeffs, dev).unbind()
    x, y, x0, y0 = _centered_grid(height, width, dev, trunc=False)
    r = torch.sqrt(x * x + y * y)
    f = (1.0 + k1 * r + k2 * r ** 2) / (1.0 + k3 * r + k4 * r ** 2
                                        + k5 * r ** 3)
    return torch.stack([x * f + x0, y * f + y0], dim=-1)


def _index(coord: torch.Tensor, size: int) -> torch.Tensor:
    """Integer-valued float coordinates as int64, clamped IN FLOAT to
    [-2, size] first so that a coordinate far outside casts safely and
    every tap taken from it (index, index + 1) stays outside."""
    return torch.clamp(coord, -2.0, float(size)).to(torch.int64)


def remap_plain(images: torch.Tensor, dist_map: torch.Tensor,
                mode: str = "bilinear") -> torch.Tensor:
    """(B, H_s, W_s, C) images of any real dtype through an (H, W, 2) map
    of source (row, col) -> (B, H, W, C) of that dtype.

    mode='bilinear': four taps with weights from the fractional parts, each
    tap zero when it falls outside the source (tested per tap, not per
    pixel), floating images cast back, integer images rounded half to even.
    mode='nearest': the truncated coordinate, zero outside.  A non-finite
    map entry samples nothing (0): it is replaced by a coordinate outside
    the source before anything is computed from it.
    """
    if images.dim() != 4 or dist_map.dim() != 3 or dist_map.shape[-1] != 2:
        raise ValueError(f"remap: images {tuple(images.shape)} (want B, H, "
                         f"W, C) and map {tuple(dist_map.shape)} (want H, W,"
                         f" 2)")
    _, h, w, _ = images.shape
    imgf = images.to(torch.float32)
    dist_map = dist_map.to(torch.float32)
    sr = torch.where(torch.isfinite(dist_map[..., 0]), dist_map[..., 0], -2.0)
    sc = torch.where(torch.isfinite(dist_map[..., 1]), dist_map[..., 1], -2.0)

    if mode == "nearest":
        ri = torch.clamp(_index(torch.trunc(sr), h), 0, h - 1)
        ci = torch.clamp(_index(torch.trunc(sc), w), 0, w - 1)
        valid = (sr >= 0) & (sr <= h - 1) & (sc >= 0) & (sc <= w - 1)
        out = torch.where(valid[..., None], imgf[:, ri, ci], 0.0)
    elif mode == "bilinear":
        r0 = torch.floor(sr)
        c0 = torch.floor(sc)
        fr = (sr - r0)[..., None]
        fc = (sc - c0)[..., None]
        r0i = _index(r0, h)
        c0i = _index(c0, w)

        def tap(dr, dc):
            rr = r0i + dr
            cc = c0i + dc
            inside = (rr >= 0) & (rr < h) & (cc >= 0) & (cc < w)
            val = imgf[:, torch.clamp(rr, 0, h - 1),
                       torch.clamp(cc, 0, w - 1)]
            return torch.where(inside[..., None], val, 0.0)

        # this order of evaluation is the one csrc/remap.cu repeats
        out = (tap(0, 0) * (1 - fr) * (1 - fc) + tap(0, 1) * (1 - fr) * fc
               + tap(1, 0) * fr * (1 - fc) + tap(1, 1) * fr * fc)
    else:
        raise ValueError(f"unknown mode {mode!r}")

    if images.dtype.is_floating_point:
        return out.to(images.dtype)
    return torch.round(out).to(images.dtype)


def _as_batch(image: torch.Tensor, src_shape=None):
    """``image`` viewed as (B, H, W, C), and the function that undoes the
    view.  (H, W) and (H, W, C) always; with ``src_shape`` also stacked
    (B, H, W) and (B, H, W, C)."""
    shape = tuple(image.shape)
    src = None if src_shape is None else tuple(src_shape)
    if image.dim() == 2 and src in (None, shape):
        return image[None, ..., None], lambda out: out[0, ..., 0]
    if image.dim() == 3 and src in (None, shape[:2]):
        return image[None], lambda out: out[0]
    if src is not None and shape[1:3] == src:
        if image.dim() == 3:
            return image[..., None], lambda out: out[..., 0]
        if image.dim() == 4:
            return image, lambda out: out
    raise ValueError(f"image of shape {tuple(image.shape)} is not (H, W), "
                     f"(H, W, C) or a stack of them"
                     + (f" for a {tuple(src_shape)} source" if src_shape
                        else ""))


def apply_distortion_map(image: torch.Tensor, dist_map: torch.Tensor,
                         mode: str = "bilinear") -> torch.Tensor:
    """Remap an (H, W) or (H, W, C) image through ``dist_map`` ((H, W, 2)
    source coords) in plain PyTorch, on the tensors' device; see
    ``remap_plain``."""
    batch, undo = _as_batch(image)
    return undo(remap_plain(batch, dist_map, mode))


def make_distortion_applier(dist_map, src_shape: tuple, *, device="cuda",
                            plain: bool = False):
    """Remap closure for a fixed distortion map.

    The map (numpy or tensor) is moved to ``device`` once.  The closure
    takes an (H, W) or (H, W, C) image of ``src_shape`` or a stack
    (B, H, W[, C]) (numpy or tensor; moved to ``device``; a 3-d input whose
    leading two sizes equal ``src_shape`` is read as (H, W, C)) and returns
    the remapped tensor on ``device``: through the CUDA kernel on a card,
    through ``remap_plain`` on the CPU or with ``plain=True``.  Images of a
    real dtype other than float32 and uint8 go through the f32 kernel as
    float32 and back (integers rounded half to even), which is what
    ``remap_plain`` computes: the result is bit-identical to it.
    """
    from photogrammetry_tpu_torch.kernels.remap import (
        KERNEL_DTYPES, remap_bilinear,
    )

    dev = resolve_device(device)
    dmap = torch.as_tensor(dist_map, dtype=torch.float32).to(dev).contiguous()
    if dmap.dim() != 3 or dmap.shape[-1] != 2:
        raise ValueError(f"distortion map of shape {tuple(dmap.shape)}")

    def remap(images):
        if plain or images.dtype in KERNEL_DTYPES:
            return (remap_plain if plain else remap_bilinear)(images, dmap)
        out = remap_bilinear(images.to(torch.float32), dmap)
        if not images.dtype.is_floating_point:
            out = torch.round(out)
        return out.to(images.dtype)

    def apply(image):
        batch, undo = _as_batch(torch.as_tensor(image).to(dev), src_shape)
        return undo(remap(batch.contiguous()))

    return apply
