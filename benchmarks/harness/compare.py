"""The comparisons that decide ``correct``: a program's (or a control's)
features, matches and track tables against the reference's features,
counted or measured the same way in every cell."""
from __future__ import annotations

import numpy as np
import torch

from reference import frontend as rf


def described_to_numpy(points_coords, score, mask, bits, xy) -> rf.Features:
    """One frame of a port ``DescribedFrame``'s leaves as numpy."""
    def host(x):
        return x.detach().cpu().numpy()

    return rf.Features(host(points_coords).astype(np.int32),
                       host(score).astype(np.float32), host(mask).astype(bool),
                       host(bits).astype(np.uint8),
                       host(xy).astype(np.float32))


def feature_gaps(got: rf.Features, ref: rf.Features) -> dict:
    """``keypoints``: slots whose validity differs, or valid in both with
    another position or score; ``bits``: BRIEF bits that differ over slots
    valid in both; ``xy_px``: the largest refined-coordinate gap over
    them."""
    both = got.mask & ref.mask
    moved = both & ((got.coords != ref.coords).any(-1)
                    | (got.score != ref.score))
    kp = int((got.mask != ref.mask).sum() + moved.sum())
    bits = int((got.bits[both] != ref.bits[both]).sum())
    xy = float(np.abs(got.xy[both].astype(np.float64)
                      - ref.xy[both]).max()) if both.any() else 0.0
    return {"keypoints": kp, "bits": bits, "xy_px": xy}


def match_gaps(idx2, dist, valid, ref) -> int:
    """Rows whose match differs from the reference's (validity, partner or
    distance)."""
    r_idx, r_dist, r_valid = ref
    valid = np.asarray(valid, bool)
    same = (valid == r_valid) & (~valid | ((np.asarray(idx2) == r_idx)
                                           & (np.asarray(dist) == r_dist)))
    return int((~same).sum())


def _nearest(xy: np.ndarray, feats: rf.Features):
    """(index of the nearest valid keypoint by refined position, distance
    in px) for each row of ``xy``; (-1, inf) where the frame has none."""
    valid = np.nonzero(feats.mask)[0]
    if len(valid) == 0 or len(xy) == 0:
        return np.full(len(xy), -1), np.full(len(xy), np.inf)
    d = np.linalg.norm(xy[:, None, :]
                       - feats.xy[valid].astype(np.float64)[None], axis=-1)
    j = d.argmin(1)
    return valid[j], d[np.arange(len(xy)), j]


def observation_gap(obs: np.ndarray, seen: np.ndarray, feats: list) -> float:
    """The largest distance in px from an observation of a track table
    (``obs`` (F, T, 2) where ``seen``) to the nearest reference keypoint of
    its frame."""
    gap = 0.0
    for f, ff in enumerate(feats):
        _, d = _nearest(obs[f, np.nonzero(seen[f])[0]], ff)
        if len(d):
            gap = max(gap, float(d.max()))
    return gap


def snap(obs: np.ndarray, seen: np.ndarray, feats: list) -> np.ndarray:
    """``obs`` with each observation moved to the refined position of the
    nearest keypoint of ``feats`` (a control's frontend put in the
    program's place)."""
    out = obs.copy()
    for f, ff in enumerate(feats):
        ids = np.nonzero(seen[f])[0]
        j, _ = _nearest(obs[f, ids], ff)
        out[f, ids] = np.where(j[:, None] >= 0, ff.xy[j], np.inf)
    return out


def links(seen: np.ndarray) -> dict:
    """A track table's links: for each pair of frames (e, f), f - e <= 2
    (the loop matches each frame with the two before it), the tracks whose
    consecutive observations lie in e and f."""
    last = np.full(seen.shape[1], -1)
    out = {}
    for f in range(seen.shape[0]):
        t = np.nonzero(seen[f] & (last >= 0) & (f - last <= 2))[0]
        for e in np.unique(last[t]):
            out[(int(e), f)] = t[last[t] == e]
        last = np.where(seen[f], f, last)
    return out
