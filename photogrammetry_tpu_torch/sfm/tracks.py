"""Feature-track bookkeeping over an image sequence, static-shape (port of
photogrammetry_tpu/sfm/tracks.py).

A TrackTable is a fixed-capacity (F frames x T tracks) observation grid —
the dense layout bundle adjustment consumes — plus per-track landmark
state.  The JAX package writes with ``.at[...].set(..., mode="drop")`` and
an out-of-bounds sentinel index (``cap``); torch has no drop mode, so
``_drop_set`` scatters into a copy one row longer and slices the sentinel
row off.  Indices are never clamped: a clamp would alias the sentinel onto
a real track.  Functions return new tables and leave their inputs intact.
A frame index is a Python int or a 0-dim integer tensor on the table's
device (the SfM step's, which a CUDA graph replays for every frame).
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from photogrammetry_tpu_torch import resolve_device
from photogrammetry_tpu_torch.utils.indexing import put_row, take_row


class TrackTable(NamedTuple):
    obs: torch.Tensor          # (F, T, 2) float32 observed pixel (x, y)
    obs_mask: torch.Tensor     # (F, T) bool
    points: torch.Tensor       # (T, 3) float32 landmark positions
    has_point: torch.Tensor    # (T,) bool
    kp_track: torch.Tensor     # (K,) int32: track id of latest frame's kp i (-1 none)
    num_tracks: torch.Tensor   # () int32 allocated tracks
    dropped: torch.Tensor      # () int32 keypoints dropped at capacity


def make_track_table(num_frames: int, capacity: int, max_keypoints: int,
                     device="cuda") -> TrackTable:
    """An empty table on ``device`` (default CUDA; raises without a card
    unless ``device='cpu'``)."""
    device = resolve_device(device)

    def i32(v):
        return torch.tensor(v, dtype=torch.int32, device=device)

    return TrackTable(
        obs=torch.zeros((num_frames, capacity, 2), device=device),
        obs_mask=torch.zeros((num_frames, capacity), dtype=torch.bool,
                             device=device),
        points=torch.zeros((capacity, 3), device=device),
        has_point=torch.zeros((capacity,), dtype=torch.bool, device=device),
        kp_track=torch.full((max_keypoints,), -1, dtype=torch.int32,
                            device=device),
        num_tracks=i32(0), dropped=i32(0))


def _drop_set(row: torch.Tensor, idx: torch.Tensor, val) -> torch.Tensor:
    """``row.at[idx].set(val, mode="drop")`` for idx in [0, len(row)]: the
    entries at the sentinel len(row) are written to a spare row and
    dropped."""
    buf = torch.cat([row, row[:1]])
    if isinstance(val, torch.Tensor):
        buf[idx.to(torch.int64)] = val
    else:   # a Python value set by index would be copied over from the host
        buf.index_fill_(0, idx.to(torch.int64), val)
    return buf[:-1]


def _write_frame(table: TrackTable, frame_idx, tid_w: torch.Tensor,
                 xy: torch.Tensor):
    """obs/obs_mask with frame ``frame_idx`` set at the (sentinel-padded)
    track ids ``tid_w``."""
    obs = put_row(table.obs, frame_idx,
                  _drop_set(take_row(table.obs, frame_idx), tid_w, xy))
    obs_mask = put_row(table.obs_mask, frame_idx,
                       _drop_set(take_row(table.obs_mask, frame_idx), tid_w,
                                 True))
    return obs, obs_mask


def start_tracks(table: TrackTable, frame_idx, xy: torch.Tensor,
                 kp_mask: torch.Tensor) -> TrackTable:
    """Open a new track for every valid keypoint of the first frame."""
    cap = table.points.shape[0]
    order = torch.cumsum(kp_mask.to(torch.int32), 0) - 1
    tid = torch.where(kp_mask, order, -1)
    fit = tid < cap
    tid = torch.where(fit, tid, -1)
    obs, obs_mask = _write_frame(table, frame_idx,
                                 torch.where(tid >= 0, tid, cap), xy)
    return table._replace(
        obs=obs, obs_mask=obs_mask, kp_track=tid.to(torch.int32),
        num_tracks=torch.clamp(kp_mask.sum(), max=cap).to(torch.int32),
        dropped=table.dropped + (kp_mask & ~fit).sum().to(torch.int32))


def _chain(table: TrackTable, frame_idx, xy: torch.Tensor,
           kp_mask: torch.Tensor, chained: torch.Tensor,
           tid: torch.Tensor) -> TrackTable:
    """Write chained keypoints onto ``tid`` and open fresh tracks for the
    valid unchained ones until capacity."""
    cap = table.points.shape[0]
    tid = torch.where(chained, tid, -1)
    need_new = kp_mask & ~chained
    slot = table.num_tracks + torch.cumsum(need_new.to(torch.int32), 0) - 1
    fits = slot < cap
    tid = torch.where(need_new & fits, slot, tid)
    obs, obs_mask = _write_frame(table, frame_idx,
                                 torch.where(tid >= 0, tid, cap), xy)
    new_alloc = (need_new & fits).sum().to(torch.int32)
    return table._replace(
        obs=obs, obs_mask=obs_mask, kp_track=tid.to(torch.int32),
        num_tracks=torch.clamp(table.num_tracks + new_alloc, max=cap)
        .to(torch.int32),
        dropped=table.dropped + (need_new & ~fits).sum().to(torch.int32))


def extend_tracks(table: TrackTable, frame_idx, xy: torch.Tensor,
                  kp_mask: torch.Tensor, match_prev: torch.Tensor,
                  match_valid: torch.Tensor) -> TrackTable:
    """Chain frame ``frame_idx`` keypoints onto existing tracks.

    match_prev: (K,) int32 — index of the matching keypoint in the previous
    frame; match_valid (K,).
    """
    prev_tid = table.kp_track[torch.clamp(match_prev, min=0).to(torch.int64)]
    chained = match_valid & kp_mask & (prev_tid >= 0)
    return _chain(table, frame_idx, xy, kp_mask, chained, prev_tid)


def extend_tracks_with_tid(table: TrackTable, frame_idx,
                           xy: torch.Tensor, kp_mask: torch.Tensor,
                           tid: torch.Tensor) -> TrackTable:
    """Chain keypoints onto explicit track ids (-1 = no match); valid but
    unmatched keypoints open new tracks until capacity."""
    return _chain(table, frame_idx, xy, kp_mask, kp_mask & (tid >= 0), tid)


def merge_skip_matches(kp_track_prev: torch.Tensor,
                       kp_track_prev2: torch.Tensor,
                       idx_prev: torch.Tensor, good_prev: torch.Tensor,
                       idx_prev2: torch.Tensor, good_prev2: torch.Tensor,
                       capacity: int) -> torch.Tensor:
    """Resolve per-keypoint track ids from consecutive (t-1) and skip-frame
    (t-2) matches.  t-1 matches win; a t-2 match only claims a track no
    t-1 match claimed, and collisions between t-2 matches keep the lowest
    keypoint index.  Returns (K,) int32 tid (-1 = none)."""
    k = idx_prev.shape[0]
    dev = idx_prev.device
    tid1 = torch.where(
        good_prev, kp_track_prev[torch.clamp(idx_prev, min=0).long()], -1)
    tid2 = torch.where(
        good_prev2, kp_track_prev2[torch.clamp(idx_prev2, min=0).long()], -1)
    claimed = torch.zeros((capacity + 1,), dtype=torch.bool,
                          device=dev).index_fill_(
        0, torch.where(tid1 >= 0, tid1, capacity).long(), True)
    tid2 = torch.where((tid2 >= 0)
                       & ~claimed[torch.clamp(tid2, min=0).long()], tid2, -1)
    ar = torch.arange(k, dtype=torch.int32, device=dev)
    owner = torch.full((capacity + 1,), k, dtype=torch.int32, device=dev)
    owner = owner.scatter_reduce(0, torch.where(tid2 >= 0, tid2,
                                                capacity).long(),
                                 ar, reduce="amin")
    tid2 = torch.where((tid2 >= 0)
                       & (owner[torch.clamp(tid2, min=0).long()] == ar),
                       tid2, -1)
    return torch.where(tid1 >= 0, tid1, tid2).to(torch.int32)


def reassociate_to_landmarks(table: TrackTable, frame_idx,
                             xy: torch.Tensor, kp_mask: torch.Tensor,
                             r_t: torch.Tensor, t_t: torch.Tensor,
                             k: torch.Tensor, radius: float):
    """Map-guided track re-association ("track by projection"): after frame
    ``frame_idx``'s pose is estimated, a keypoint that opened a fresh
    singleton this frame (or was dropped) claims the triangulated landmark
    track projecting within ``radius`` px, by mutual-nearest assignment;
    its observation moves onto the landmark's track.

    Returns (table, num_reassociated).
    """
    cap = table.points.shape[0]
    kcount = xy.shape[0]
    pc = table.points @ r_t.T + t_t
    z = pc[:, 2]
    zs = torch.where(z.abs() < 1e-9, 1e-9, z)
    proj = torch.stack([k[0, 0] * pc[:, 0] / zs + k[0, 2],
                        k[1, 1] * pc[:, 1] / zs + k[1, 2]], dim=-1)

    cand = table.has_point & (z > 1e-3) & ~take_row(table.obs_mask,
                                                    frame_idx)
    nobs = table.obs_mask.sum(0)
    tid_now = table.kp_track
    own = nobs[torch.clamp(tid_now, min=0).long()]
    eligible = kp_mask & ((tid_now < 0) | (own <= 1))

    diff = xy[:, None, :] - proj[None, :, :]
    d = torch.sqrt((diff * diff).sum(-1))
    d = torch.where(cand[None, :] & eligible[:, None], d, torch.inf)
    best_d, best_lm = torch.min(d, dim=1)                   # (K,)
    best_kp = torch.argmin(d, dim=0)                        # (T,)
    mutual = best_kp[best_lm] == torch.arange(kcount, device=xy.device)
    take = eligible & mutual & (best_d <= radius)

    old_tid = torch.where(take & (tid_now >= 0), tid_now, cap)
    row = _drop_set(take_row(table.obs_mask, frame_idx), old_tid, False)
    new_tid = torch.where(take, best_lm, cap)
    obs_mask = put_row(table.obs_mask, frame_idx,
                       _drop_set(row, new_tid, True))
    obs = put_row(table.obs, frame_idx,
                  _drop_set(take_row(table.obs, frame_idx), new_tid, xy))
    kp_track = torch.where(take, best_lm, tid_now).to(torch.int32)
    return (table._replace(obs=obs, obs_mask=obs_mask, kp_track=kp_track),
            take.sum().to(torch.int32))


def first_last_observations(table: TrackTable):
    """Per track: (first_frame, last_frame) observing it (int32, -1 if <1)."""
    f = table.obs.shape[0]
    frames = torch.arange(f, dtype=torch.int32,
                          device=table.obs.device)[:, None]
    m = table.obs_mask
    first = torch.where(m, frames, f).amin(0)
    last = torch.where(m, frames, -1).amax(0)
    first = torch.where(first == f, -1, first)
    return first.to(torch.int32), last.to(torch.int32)
