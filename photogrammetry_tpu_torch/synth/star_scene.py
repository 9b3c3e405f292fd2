"""Synthetic 15-point-star camera-pan scene with exact ground truth (the
port's own copy of photogrammetry_tpu/synth/star_scene.py's pan scene, so
that the port renders test frames without importing the JAX package).

The reference ships a Blender project (blender/15pt_star_camera_pan/
project.blend) but no rendered frames or exported poses (SURVEY.md §4); this
module generates an equivalent scene procedurally — a planar 15-point star
observed by a panning camera — so every stage of the SfM pipeline can be
validated against exact 3-D geometry and an exact trajectory (the ATE oracle
of BASELINE.json).

Rendering is host-side test infrastructure (NumPy rasterization of the filled
star polygon); the star's 30 polygon vertices are strong FAST corners just
like the committed 15pt_star.png fixture.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np


@dataclass
class StarSceneConfig:
    num_spikes: int = 15
    outer_radius: float = 1.0
    inner_radius: float = 0.45
    depth: float = 6.0              # star plane z in world frame
    # Per-vertex depth modulation: a perfectly planar scene is the degenerate
    # configuration for fundamental-matrix estimation, so the star is bent
    # out of plane (deterministically) to keep two-view geometry well-posed.
    depth_modulation: float = 0.8
    image_size: tuple = (480, 640)  # (H, W)
    focal: float = 520.0
    num_frames: int = 12
    pan_radius: float = 1.2         # camera lateral travel
    pan_angle: float = 0.35         # total yaw sweep (radians)
    # Textured backdrop: distinctive random dots at varying depth around the
    # star so BRIEF descriptors are discriminative (a bare star is highly
    # self-similar) and two-view geometry is well-conditioned.
    num_dots: int = 160
    # radius 2 < FAST ring radius 3, so every dot center is a strong corner
    dot_radius: int = 2
    dot_seed: int = 7
    # Geometrically consistent value-noise texture on a backdrop plane at
    # z = depth + backdrop_offset: gives BRIEF descriptors discriminative,
    # view-consistent context (a bare dot field is locally self-similar).
    backdrop_offset: float = 3.0
    backdrop_amplitude: float = 60.0
    backdrop_scale: float = 2.5     # noise cells per world unit
    # Anti-aliasing: render at supersample x resolution and box-downsample.
    # Hard binary edges bias subpixel corner localization by +-0.5 px, which
    # dominates small-baseline geometry error.
    supersample: int = 2


def star_points_3d(cfg: StarSceneConfig) -> np.ndarray:
    """(2*num_spikes, 3) star polygon vertices in the z=depth plane."""
    n = cfg.num_spikes
    angles = np.arange(2 * n) * np.pi / n - np.pi / 2
    radii = np.where(np.arange(2 * n) % 2 == 0, cfg.outer_radius,
                     cfg.inner_radius)
    x = radii * np.cos(angles)
    y = radii * np.sin(angles)
    z = cfg.depth + cfg.depth_modulation * np.sin(3.0 * angles)
    return np.stack([x, y, z], axis=-1)


def dot_points_3d(cfg: StarSceneConfig):
    """(num_dots, 3) scatter points + (num_dots,) intensities (60..220)."""
    rng = np.random.default_rng(cfg.dot_seed)
    pts = rng.uniform([-2.2, -1.6, cfg.depth - 1.8],
                      [2.2, 1.6, cfg.depth + 2.5], (cfg.num_dots, 3))
    # keep dots off the star silhouette so its corners stay clean
    rad = np.hypot(pts[:, 0], pts[:, 1])
    pts = pts[rad > cfg.outer_radius * 1.15]
    # bright enough that |dot - backdrop| always clears the FAST
    # threshold (backdrop <= amplitude 60, threshold 50)
    intens = rng.integers(130, 255, len(pts))
    return pts, intens


def pan_trajectory(cfg: StarSceneConfig):
    """Ground-truth camera poses: world→camera (R_i, t_i) per frame.

    The camera slides along x while yawing to keep the star centered —
    the "camera pan" of the Blender scene.
    """
    rs, ts, centers = [], [], []
    for i in range(cfg.num_frames):
        a = (i / max(cfg.num_frames - 1, 1) - 0.5)
        cx = a * 2 * cfg.pan_radius
        # Yaw keeps the star centered in frame throughout the pan.
        yaw = float(np.arctan2(cx, cfg.depth))
        # pure-numpy yaw rotation: scene generation stays on the host
        cy_, sy_ = np.cos(yaw), np.sin(yaw)
        r = np.array([[cy_, 0.0, sy_],
                      [0.0, 1.0, 0.0],
                      [-sy_, 0.0, cy_]], np.float64)
        center = np.array([cx, 0.0, 0.0])
        t = -r @ center
        rs.append(r)
        ts.append(t)
        centers.append(center)
    return np.stack(rs), np.stack(ts), np.stack(centers)


def intrinsics(cfg: StarSceneConfig) -> np.ndarray:
    h, w = cfg.image_size
    return np.array([[cfg.focal, 0.0, w / 2.0],
                     [0.0, cfg.focal, h / 2.0],
                     [0.0, 0.0, 1.0]], np.float32)


def project_scene(points_w: np.ndarray, r: np.ndarray, t: np.ndarray,
                  k: np.ndarray) -> np.ndarray:
    """(N, 3) world points → (N, 2) pixel (x, y) for one camera."""
    pc = points_w @ r.T + t
    uvw = pc @ k.T
    return uvw[:, :2] / uvw[:, 2:3]


def _value_noise(x: np.ndarray, y: np.ndarray, seed: float = 0.0) -> np.ndarray:
    """Smooth deterministic value noise in [0, 1] over world coordinates."""
    def hash2(i, j):
        v = np.sin(i * 127.1 + j * 311.7 + seed * 74.7) * 43758.5453
        return v - np.floor(v)

    xi, yi = np.floor(x), np.floor(y)
    fx, fy = x - xi, y - yi
    fx = fx * fx * (3 - 2 * fx)
    fy = fy * fy * (3 - 2 * fy)
    v00 = hash2(xi, yi)
    v10 = hash2(xi + 1, yi)
    v01 = hash2(xi, yi + 1)
    v11 = hash2(xi + 1, yi + 1)
    return (v00 * (1 - fx) * (1 - fy) + v10 * fx * (1 - fy)
            + v01 * (1 - fx) * fy + v11 * fx * fy)


def _render_backdrop(cfg: StarSceneConfig, r: np.ndarray, t: np.ndarray,
                     k: np.ndarray) -> np.ndarray:
    """Project the textured backdrop plane (z = depth + offset) per pixel."""
    h, w = cfg.image_size
    zb = cfg.depth + cfg.backdrop_offset
    center = -r.T @ t
    uu, vv = np.meshgrid(np.arange(w) + 0.5, np.arange(h) + 0.5)
    kinv = np.linalg.inv(k)
    rays_cam = np.stack([uu, vv, np.ones_like(uu)], -1) @ kinv.T
    rays_w = rays_cam @ r  # R^T applied to each ray
    s = (zb - center[2]) / rays_w[..., 2]
    wx = center[0] + s * rays_w[..., 0]
    wy = center[1] + s * rays_w[..., 1]
    f = cfg.backdrop_scale
    n = (_value_noise(wx * f, wy * f) * 0.6
         + _value_noise(wx * f * 2.7, wy * f * 2.7, seed=1.0) * 0.4)
    return (n * cfg.backdrop_amplitude).astype(np.uint8)


def render_frame(cfg: StarSceneConfig, r: np.ndarray, t: np.ndarray,
                 k: np.ndarray) -> np.ndarray:
    """Anti-aliased render: supersample then box-downsample."""
    s = cfg.supersample
    if s <= 1:
        return _render_frame_raw(cfg, r, t, k)
    h, w = cfg.image_size
    k_hi = k.copy().astype(np.float64)
    k_hi[0] = k[0] * s
    k_hi[1] = k[1] * s
    k_hi[0, 2] += (s - 1) / 2.0
    k_hi[1, 2] += (s - 1) / 2.0
    import dataclasses
    cfg_hi = dataclasses.replace(cfg, image_size=(h * s, w * s),
                                 dot_radius=cfg.dot_radius * s)
    hi = _render_frame_raw(cfg_hi, r, t, k_hi).astype(np.float32)
    low = hi.reshape(h, s, w, s).mean(axis=(1, 3))
    return np.round(low).astype(np.uint8)


def scanline_fill(poly: np.ndarray, h: int, w: int) -> np.ndarray:
    """Even-odd scanline fill of a closed polygon → (h, w) bool mask.

    Shared by this module's rasterizer and synth.blend_oracle."""
    mask = np.zeros((h, w), bool)
    ys = poly[:, 1]
    xs = poly[:, 0]
    n = len(poly)
    y0 = max(int(np.floor(ys.min())), 0)
    y1 = min(int(np.ceil(ys.max())), h - 1)
    for y in range(y0, y1 + 1):
        nodes = []
        j = n - 1
        for i in range(n):
            if (ys[i] < y) != (ys[j] < y):
                nodes.append(xs[i] + (y - ys[i]) / (ys[j] - ys[i])
                             * (xs[j] - xs[i]))
            j = i
        nodes.sort()
        for a, b in zip(nodes[0::2], nodes[1::2]):
            lo = max(int(np.ceil(a)), 0)
            hi = min(int(np.floor(b)), w - 1)
            if hi >= lo:
                mask[y, lo:hi + 1] = True
    return mask


def _render_frame_raw(cfg: StarSceneConfig, r: np.ndarray, t: np.ndarray,
                      k: np.ndarray) -> np.ndarray:
    """Rasterize backdrop + filled star polygon + dots → (H, W) uint8."""
    h, w = cfg.image_size
    poly = project_scene(star_points_3d(cfg), r, t, k)  # (2n, 2) x,y
    img = _render_backdrop(cfg, r, t, k)
    star_mask = scanline_fill(poly, h, w)
    img[star_mask] = 255

    # foreground dots (skipped where they would overlap the star)
    dots, intens = dot_points_3d(cfg)
    if len(dots):
        dxy = project_scene(dots, r, t, k)
        rad = cfg.dot_radius
        yy, xx = np.mgrid[-rad:rad + 1, -rad:rad + 1]
        disc = (yy ** 2 + xx ** 2) <= rad ** 2
        for (x, y), val in zip(dxy, intens):
            xi, yi = int(round(x)), int(round(y))
            if rad <= xi < w - rad and rad <= yi < h - rad:
                sm = star_mask[yi - rad:yi + rad + 1, xi - rad:xi + rad + 1]
                patch = img[yi - rad:yi + rad + 1, xi - rad:xi + rad + 1]
                patch[disc & ~sm] = val
    return img


def generate_sequence(cfg: StarSceneConfig | None = None):
    """Full synthetic dataset.

    Returns dict with: frames (F, H, W) uint8, k (3,3), rs (F,3,3),
    ts (F,3), centers (F,3), points (M,3), projections (F, M, 2).
    """
    cfg = cfg or StarSceneConfig()
    dots, _ = dot_points_3d(cfg)
    pts = np.concatenate([star_points_3d(cfg), dots])
    rs, ts, centers = pan_trajectory(cfg)
    k = intrinsics(cfg)
    frames = np.stack([render_frame(cfg, rs[i], ts[i], k)
                       for i in range(cfg.num_frames)])
    proj = np.stack([project_scene(pts, rs[i], ts[i], k)
                     for i in range(cfg.num_frames)])
    return dict(frames=frames, k=k, rs=rs, ts=ts, centers=centers,
                points=pts, projections=proj, config=cfg)
