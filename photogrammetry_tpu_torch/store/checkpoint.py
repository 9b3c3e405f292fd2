"""Checkpoint/resume of incremental SfM state (port of
photogrammetry_tpu/store/checkpoint.py).

Poses, landmarks and the track table snapshot atomically, so that a run
can resume mid-sequence.  The format is the JAX package's, field for field
and dtype for dtype: one .npz (``rs``, ``ts``, the 0-d int32
``frame_index`` and ``table_<field>`` for the seven ``TrackTable`` fields)
written through a temp file and ``os.replace`` (atomic on POSIX), plus a
JSON sidecar of metadata.  A checkpoint either package writes loads in the
other.
"""
from __future__ import annotations

import json
import os

import numpy as np
import torch

from photogrammetry_tpu_torch import resolve_device
from photogrammetry_tpu_torch.sfm.tracks import TrackTable

_FIELDS = TrackTable._fields


def _numpy(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def save_checkpoint(path: str, rs, ts, table: TrackTable,
                    frame_index: int, metadata: dict | None = None) -> None:
    arrays = {"rs": _numpy(rs), "ts": _numpy(ts),
              "frame_index": np.asarray(frame_index, np.int32)}
    for f in _FIELDS:
        arrays[f"table_{f}"] = _numpy(getattr(table, f))
    tmp = path + ".tmp"
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(tmp, "wb") as fh:
        np.savez_compressed(fh, **arrays)
    os.replace(tmp, path)
    if metadata is not None:
        with open(path + ".json", "w") as fh:
            json.dump(metadata, fh)


def load_checkpoint(path: str, device="cuda"):
    """Returns (rs, ts, TrackTable, frame_index, metadata|None), the
    tensors on ``device`` (default CUDA; raises without a card unless
    ``device='cpu'``) with the file's dtypes."""
    dev = resolve_device(device)
    with np.load(path) as data:
        table = TrackTable(**{f: torch.from_numpy(data[f"table_{f}"]).to(dev)
                              for f in _FIELDS})
        rs = torch.from_numpy(data["rs"]).to(dev)
        ts = torch.from_numpy(data["ts"]).to(dev)
        frame_index = int(data["frame_index"])
    meta = None
    if os.path.isfile(path + ".json"):
        with open(path + ".json") as fh:
            meta = json.load(fh)
    return rs, ts, table, frame_index, meta
