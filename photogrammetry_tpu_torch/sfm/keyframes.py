"""Displacement-gated keyframing + PnP localization of non-keyframes (port
of photogrammetry_tpu/sfm/keyframes.py).

Two-view parallax starves when consecutive frames barely move, so the map
is built from frames with real baseline:

  1. select_keyframes — walk the sequence, opening a new keyframe when
     the median feature displacement against the previous keyframe
     reaches ``min_disp_px``;
  2. build the map with run_incremental_sfm on the keyframes only;
  3. localize_nonkeyframes — every skipped frame matches its features
     against the nearest keyframe, inherits that keyframe's 2D-3D
     associations (landmarks claimed by proximity) and gets a motion-only
     BA pose, RANSAC PnP as the rescue.

A tool for dense video, not a default: on well-spaced sequences subsetting
only removes BA redundancy.

Every function takes ``device`` (default CUDA) and ``plain`` (the kernels'
plain versions, the reference run on the card), passed to the frontend,
``match_pair`` and ``bundle_adjust``.  Poses stay on the device and come
back in one transfer; each non-keyframe reads one scalar (the inlier count
that picks its path), two on the rescue path.
"""
from __future__ import annotations

import numpy as np
import torch

from photogrammetry_tpu_torch import resolve_device
from photogrammetry_tpu_torch.sfm.ba import BAProblem, BAState, bundle_adjust
from photogrammetry_tpu_torch.sfm.frontend import (
    frame_features, make_pairs, match_pair, precompute_frontend,
)
from photogrammetry_tpu_torch.sfm.incremental import (
    SfmConfig, SfmResult, run_incremental_sfm, run_incremental_sfm_robust,
)
from photogrammetry_tpu_torch.sfm.pnp import (
    draw_pnp_samples, pnp_reprojection_errors, ransac_pnp,
)
from photogrammetry_tpu_torch.utils.reductions import nanmedian

INT32_MAX = torch.iinfo(torch.int32).max


def _frames_on(frames, dev) -> torch.Tensor:
    """(F, H, W) frames (numpy or a tensor) as float32 on ``dev``."""
    if not isinstance(frames, torch.Tensor):
        frames = np.asarray(frames)
    return torch.as_tensor(frames, dtype=torch.float32,
                           device=dev).contiguous()


def select_keyframes(frames, config: SfmConfig, min_disp_px: float = 30.0,
                     *, device="cuda", plain: bool = False):
    """Indices of displacement-gated keyframes (always 0 and the last
    frame) and the per-frame features (reused by localization).  The
    statistic is the JAX-semantics median displacement of the mutual
    matches against the last keyframe (inf below 16 matches: tracking
    lost forces a keyframe); one host read a frame."""
    fc = config.frontend
    dev = resolve_device(device)
    stacked = precompute_frontend(_frames_on(frames, dev),
                                  make_pairs(fc, device=dev), fc,
                                  chunk=config.frontend_chunk, plain=plain)
    num = len(frames)
    feats = [frame_features(stacked, t) for t in range(num)]
    keyframes = [0]
    for t in range(1, num):
        m = match_pair(feats[t], feats[keyframes[-1]], fc, plain=plain)
        d = m.xy1 - m.xy2
        disp = float(torch.where(
            m.num >= 16,
            nanmedian(torch.where(m.mask, torch.sqrt((d * d).sum(-1)),
                                  torch.nan)), torch.inf))
        if disp >= min_disp_px or t == num - 1:
            keyframes.append(t)
    return keyframes, feats


def _claim_landmarks(feat, table, row: int) -> torch.Tensor:
    """Keyframe keypoint j → the id of the landmark observed in the table
    row ``row`` nearest to it within 2 px, or -1."""
    diff = feat.xy[:, None, :] - table.obs[row][None]
    d = torch.sqrt((diff * diff).sum(-1))
    tvalid = table.obs_mask[row] & table.has_point
    d = torch.where(tvalid[None, :], d, torch.inf)
    nearest = torch.argmin(d, dim=1)
    claimed = torch.gather(d, 1, nearest[:, None])[:, 0] < 2.0
    return torch.where(claimed & feat.points.mask, nearest, -1)


def _inherit(m, kp_lm: torch.Tensor, cap: int):
    """The frame's 2D-3D correspondences through its keyframe's claims:
    (pnp_mask (cap,), xy (cap, 2)).  Where several keypoints inherit one
    landmark the lowest Hamming distance wins (then the lowest keypoint
    index): a scatter-MIN of the key dist * K + index, JAX's
    ``.at[lm].min(mode="drop")`` with the unmatched sent to a spare slot
    ``cap`` that is cut off (never clipped onto a real landmark)."""
    lm = torch.where(m.mask, kp_lm[torch.clamp(m.idx2, min=0).long()], -1)
    kcount = lm.shape[0]
    enc = torch.where(lm >= 0,
                      m.dist.to(torch.int32) * kcount
                      + torch.arange(kcount, dtype=torch.int32,
                                     device=lm.device), INT32_MAX)
    slot = torch.full((cap + 1,), INT32_MAX, dtype=torch.int32,
                      device=lm.device)
    slot = slot.scatter_reduce(0, torch.where(lm >= 0, lm, cap).long(), enc,
                               "amin")[:cap]
    pnp_mask = slot < INT32_MAX
    chosen = torch.clamp(slot % kcount, 0, kcount - 1).long()
    xy = torch.where(pnp_mask[:, None], m.xy1[chosen], 0.0)
    return pnp_mask, xy


def localize_nonkeyframes(frames, keyframes, feats, res: SfmResult, k,
                          config: SfmConfig, seed: int = 99, *,
                          device="cuda", plain: bool = False):
    """Poses for every frame: keyframes keep the SfM poses; each skipped
    frame matches against its nearest keyframe, inherits the keyframe's
    2D-3D track associations and refines a motion-only BA pose (camera
    free, landmarks fixed, 10 iterations) from the previous frame's pose.
    Below ``min_pnp_inliers`` inliers RANSAC PnP is the rescue (its draws
    from a generator seeded ``seed``, taken only on that path, as JAX
    splits its key only there); below that too the frame takes its
    keyframe's pose (``fallback``).

    Returns (rs (F, 3, 3), ts (F, 3) float32 numpy, info list).
    """
    fc = config.frontend
    dev = resolve_device(device)
    kmat = torch.as_tensor(np.asarray(k), dtype=torch.float32, device=dev)
    num_frames = len(frames)
    kf_pos = {kf: i for i, kf in enumerate(keyframes)}
    table = res.table
    cap = table.points.shape[0]
    # per keyframe, once: keyframe keypoint j -> landmark id or -1
    kp_lm_by_kf = {kf: _claim_landmarks(feats[kf], table, row)
                   for kf, row in kf_pos.items()}

    gen = torch.Generator(device=dev).manual_seed(seed)
    rs_dev = [None] * num_frames
    ts_dev = [None] * num_frames
    for kf, i in kf_pos.items():
        rs_dev[kf] = torch.tensor(res.rs[i], dtype=torch.float32,
                                  device=dev)
        ts_dev[kf] = torch.tensor(res.ts[i], dtype=torch.float32,
                                  device=dev)

    info = []
    for t in range(num_frames):
        if t in kf_pos:
            continue
        kf = min(keyframes, key=lambda x: abs(x - t))
        m = match_pair(feats[t], feats[kf], fc, plain=plain)
        pnp_mask, xy = _inherit(m, kp_lm_by_kf[kf], cap)

        prior = t - 1 if t > 0 else kf
        out = bundle_adjust(
            BAState(rs=rs_dev[prior][None], ts=ts_dev[prior][None],
                    points=table.points),
            BAProblem(obs=xy[None], mask=pnp_mask[None], k=kmat),
            num_iterations=10, optimize_points=False,
            fixed_cameras=torch.ones((1,), device=dev), plain=plain)
        r_m, t_m = out.state.rs[0], out.state.ts[0]
        err, z = pnp_reprojection_errors(r_m, t_m, table.points, xy, kmat)
        n_in = int((pnp_mask & (err < config.pnp_threshold) & (z > 0)).sum())
        if n_in >= config.min_pnp_inliers:
            rs_dev[t], ts_dev[t] = r_m, t_m
            info.append({"frame": t, "keyframe": kf, "inliers": n_in,
                         "path": "motion_ba"})
            continue
        pnp = ransac_pnp(draw_pnp_samples(gen, pnp_mask, config.pnp_samples),
                         table.points, xy, pnp_mask, kmat,
                         threshold=config.pnp_threshold)
        n_pnp = int(pnp.num_inliers)
        if n_pnp >= config.min_pnp_inliers:
            rs_dev[t], ts_dev[t] = pnp.r, pnp.t
            info.append({"frame": t, "keyframe": kf, "inliers": n_pnp,
                         "path": "ransac_pnp"})
        else:
            rs_dev[t], ts_dev[t] = rs_dev[kf], ts_dev[kf]
            info.append({"frame": t, "keyframe": kf, "inliers": n_pnp,
                         "fallback": True})

    # one device->host transfer for the whole trajectory
    rs = torch.stack(rs_dev).cpu().numpy().astype(np.float32)
    ts = torch.stack(ts_dev).cpu().numpy().astype(np.float32)
    return rs, ts, info


def run_keyframed_sfm(frames, k, config: SfmConfig | None = None,
                      min_disp_px: float = 30.0, seed: int = 0,
                      restarts: int = 1, *, device="cuda",
                      plain: bool = False):
    """Keyframe selection → SfM on the keyframes (best of ``restarts``) →
    localization of every skipped frame (draws seeded ``seed + 99``).

    Returns (rs (F, 3, 3), ts (F, 3), keyframes, res, info).
    """
    config = config or SfmConfig()
    keyframes, feats = select_keyframes(frames, config, min_disp_px,
                                        device=device, plain=plain)
    if isinstance(frames, torch.Tensor):
        kf_frames = frames[torch.as_tensor(keyframes, device=frames.device)]
    else:
        kf_frames = np.stack([np.asarray(frames[i]) for i in keyframes])
    if restarts > 1:
        res = run_incremental_sfm_robust(kf_frames, k, config, seed=seed,
                                         restarts=restarts, device=device,
                                         plain=plain)
    else:
        res = run_incremental_sfm(kf_frames, k, config, seed=seed,
                                  device=device, plain=plain)
    rs, ts, info = localize_nonkeyframes(frames, keyframes, feats, res, k,
                                         config, seed=seed + 99,
                                         device=device, plain=plain)
    return rs, ts, keyframes, res, info
