"""The benchmark's star-scene renderer, on the device.

A copy of the port's ``synth/star_scene.py`` pan scene (a bent 15-point
star in front of a value-noise backdrop and a field of dots, seen by a
camera that slides along x while yawing to keep the star centred),
rewritten so that the per-pixel work runs as tensor operations on the
card: a 12 Mpx frame rendered by the NumPy original costs seconds on the
host.  The geometry (scene points, trajectory, intrinsics, projections)
stays in float64 NumPy on the host, as in the original; the pixels are
float64 tensor code in the original's order of operations, so that the
frames equal the NumPy renderer's (``tests/test_bench_scene.py`` holds them
to a frozen copy of it).

Two things differ from the original, both drawn per scene:
``dot_seed`` (the dot field) and ``texture_seed`` (the backdrop's value
noise, 0 in the original).  ``scene_seeds(seed, index)`` derives both
from the run's ``--seed`` and the scene's index in the pool.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class SceneSpec:
    num_spikes: int = 15
    outer_radius: float = 1.0
    inner_radius: float = 0.45
    depth: float = 6.0
    depth_modulation: float = 0.8
    image_size: tuple = (480, 640)
    focal: float = 520.0
    num_frames: int = 12
    pan_radius: float = 1.2
    num_dots: int = 160
    dot_radius: int = 2
    dot_seed: int = 7
    backdrop_offset: float = 3.0
    backdrop_amplitude: float = 60.0
    backdrop_scale: float = 2.5
    supersample: int = 2
    texture_seed: float = 0.0


def scene_seeds(seed: int, index: int) -> tuple[int, float]:
    """(dot_seed, texture_seed) of scene ``index`` of a run with ``seed``:
    any whole numbers, of any size."""
    words = np.random.SeedSequence([int(seed) % 2 ** 64,
                                    int(index)]).generate_state(2)
    return int(words[0]), float(words[1] % 100_000) / 7.0


def star_points_3d(spec: SceneSpec) -> np.ndarray:
    n = spec.num_spikes
    angles = np.arange(2 * n) * np.pi / n - np.pi / 2
    radii = np.where(np.arange(2 * n) % 2 == 0, spec.outer_radius,
                     spec.inner_radius)
    z = spec.depth + spec.depth_modulation * np.sin(3.0 * angles)
    return np.stack([radii * np.cos(angles), radii * np.sin(angles), z], -1)


def dot_points_3d(spec: SceneSpec):
    rng = np.random.default_rng(spec.dot_seed)
    pts = rng.uniform([-2.2, -1.6, spec.depth - 1.8],
                      [2.2, 1.6, spec.depth + 2.5], (spec.num_dots, 3))
    rad = np.hypot(pts[:, 0], pts[:, 1])
    pts = pts[rad > spec.outer_radius * 1.15]
    intens = rng.integers(130, 255, len(pts))
    return pts, intens


def pan_trajectory(spec: SceneSpec):
    """World-to-camera (rs (F, 3, 3), ts (F, 3)) and the camera centres."""
    rs, ts, centers = [], [], []
    for i in range(spec.num_frames):
        a = (i / max(spec.num_frames - 1, 1) - 0.5)
        cx = a * 2 * spec.pan_radius
        yaw = float(np.arctan2(cx, spec.depth))
        c, s = np.cos(yaw), np.sin(yaw)
        r = np.array([[c, 0.0, s], [0.0, 1.0, 0.0], [-s, 0.0, c]])
        center = np.array([cx, 0.0, 0.0])
        rs.append(r)
        ts.append(-r @ center)
        centers.append(center)
    return np.stack(rs), np.stack(ts), np.stack(centers)


def intrinsics(spec: SceneSpec) -> np.ndarray:
    h, w = spec.image_size
    return np.array([[spec.focal, 0.0, w / 2.0], [0.0, spec.focal, h / 2.0],
                     [0.0, 0.0, 1.0]], np.float32)


def project(points_w, r, t, k) -> np.ndarray:
    uvw = (points_w @ r.T + t) @ k.T
    return uvw[:, :2] / uvw[:, 2:3]


def _value_noise(x, y, seed: float):
    def hash2(i, j):
        v = torch.sin(i * 127.1 + j * 311.7 + seed * 74.7) * 43758.5453
        return v - torch.floor(v)

    xi, yi = torch.floor(x), torch.floor(y)
    fx, fy = x - xi, y - yi
    fx = fx * fx * (3 - 2 * fx)
    fy = fy * fy * (3 - 2 * fy)
    return (hash2(xi, yi) * (1 - fx) * (1 - fy)
            + hash2(xi + 1, yi) * fx * (1 - fy)
            + hash2(xi, yi + 1) * (1 - fx) * fy
            + hash2(xi + 1, yi + 1) * fx * fy)


def _backdrop(spec: SceneSpec, r, t, k, device) -> torch.Tensor:
    h, w = spec.image_size
    zb = spec.depth + spec.backdrop_offset
    center = -r.T @ t
    kinv = np.linalg.inv(k)
    f64 = dict(dtype=torch.float64, device=device)
    uu = (torch.arange(w, **f64) + 0.5)[None, :].expand(h, w)
    vv = (torch.arange(h, **f64) + 0.5)[:, None].expand(h, w)
    cam = [uu * kinv[c, 0] + vv * kinv[c, 1] + kinv[c, 2] for c in range(3)]
    ray = [cam[0] * r[0, c] + cam[1] * r[1, c] + cam[2] * r[2, c]
           for c in range(3)]
    s = (zb - center[2]) / ray[2]
    wx = center[0] + s * ray[0]
    wy = center[1] + s * ray[1]
    f = spec.backdrop_scale
    ts = spec.texture_seed
    n = (_value_noise(wx * f, wy * f, ts) * 0.6
         + _value_noise(wx * f * 2.7, wy * f * 2.7, ts + 1.0) * 0.4)
    return (n * spec.backdrop_amplitude).to(torch.uint8)


def scanline_mask(poly: np.ndarray, h: int, w: int, device) -> torch.Tensor:
    """Even-odd scanline fill of a closed polygon as the original's loop
    does it: on row y the crossings x of the edges that straddle y, sorted
    into pairs (a, b), fill the integer columns in [a, b]."""
    mask = torch.zeros((h, w), dtype=torch.bool, device=device)
    ys, xs = poly[:, 1], poly[:, 0]
    y0 = max(int(np.floor(ys.min())), 0)
    y1 = min(int(np.ceil(ys.max())), h - 1)
    if y1 < y0:
        return mask
    yv = np.arange(y0, y1 + 1, dtype=np.float64)[:, None]      # (Y, 1)
    j = np.roll(np.arange(len(poly)), 1)                       # previous
    straddle = (ys[None, :] < yv) != (ys[j][None, :] < yv)     # (Y, E)
    with np.errstate(divide="ignore", invalid="ignore"):
        nodes = xs + (yv - ys) / (ys[j] - ys) * (xs[j] - xs)
    nodes = np.sort(np.where(straddle, nodes, np.inf), axis=1)
    a = torch.as_tensor(nodes[:, 0::2], device=device)         # (Y, E/2)
    b = torch.as_tensor(nodes[:, 1::2], device=device)
    cols = torch.arange(w, dtype=torch.float64, device=device)
    lo = torch.clamp(torch.ceil(a), min=0)
    hi = torch.clamp(torch.floor(b), max=w - 1)
    inside = ((cols[None, None, :] >= lo[..., None])
              & (cols[None, None, :] <= hi[..., None])
              & torch.isfinite(b)[..., None]).any(1)
    mask[y0:y1 + 1] = inside
    return mask


def _render_raw(spec: SceneSpec, r, t, k, device) -> torch.Tensor:
    h, w = spec.image_size
    img = _backdrop(spec, r, t, k, device)
    star = scanline_mask(project(star_points_3d(spec), r, t, k), h, w,
                         device)
    img[star] = 255
    dots, intens = dot_points_3d(spec)
    if len(dots):
        rad = spec.dot_radius
        xy = np.round(project(dots, r, t, k)).astype(np.int64)
        ok = ((xy[:, 0] >= rad) & (xy[:, 0] < w - rad)
              & (xy[:, 1] >= rad) & (xy[:, 1] < h - rad))
        yy, xx = np.mgrid[-rad:rad + 1, -rad:rad + 1]
        disc = (yy ** 2 + xx ** 2) <= rad ** 2
        dy, dx = yy[disc], xx[disc]
        order = np.nonzero(ok)[0]
        if len(order):
            # the original paints dot after dot: the last dot over a pixel
            # wins, so each pixel takes the highest index painted on it
            flat = ((xy[order, 1, None] + dy) * w
                    + xy[order, 0, None] + dx).reshape(-1)
            who = torch.full((h * w,), -1, dtype=torch.int64, device=device)
            src = torch.as_tensor(np.repeat(order, len(dy)), device=device)
            who.scatter_reduce_(0, torch.as_tensor(flat, device=device),
                                src, reduce="amax")
            val = torch.as_tensor(intens, device=device).to(torch.uint8)
            paint = (who >= 0) & ~star.reshape(-1)
            flat_img = img.reshape(-1)
            flat_img[paint] = val[who[paint]]
    return img


def render_frame(spec: SceneSpec, r, t, k, device) -> torch.Tensor:
    """(H, W) uint8 frame on ``device``: supersampled, box-downsampled and
    rounded half to even, as the original."""
    s = spec.supersample
    if s <= 1:
        return _render_raw(spec, r, t, k, device)
    h, w = spec.image_size
    k_hi = k.astype(np.float64)
    k_hi[0] = k[0] * s
    k_hi[1] = k[1] * s
    k_hi[0, 2] += (s - 1) / 2.0
    k_hi[1, 2] += (s - 1) / 2.0
    hi_spec = dataclasses.replace(spec, image_size=(h * s, w * s),
                                  dot_radius=spec.dot_radius * s)
    hi = _render_raw(hi_spec, r, t, k_hi, device).to(torch.float32)
    low = hi.reshape(h, s, w, s).mean(dim=(1, 3))
    return torch.round(low).to(torch.uint8)


def render_frames(spec: SceneSpec, frame_ids, device) -> torch.Tensor:
    """(len(frame_ids), H, W) uint8 frames of the pan on ``device``."""
    rs, ts, _ = pan_trajectory(spec)
    k = intrinsics(spec)
    return torch.stack([render_frame(spec, rs[i], ts[i], k, device)
                        for i in frame_ids])
