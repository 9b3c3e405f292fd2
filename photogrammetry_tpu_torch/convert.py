"""Carry the JAX package's state into the port.

This system's "weights" are the BRIEF pair table (drawn from ``jax.random``
by the JAX ``make_pairs``; the port's ``make_pairs`` draws the same table
from the same seed), the intrinsics K and the configuration; its
state is the track table and the BA state of a reconstruction.
``from_jax`` takes the first as plain numpy arrays and a dict
(``np.asarray(make_pairs(cfg))``, ``dataclasses.asdict(cfg)``);
``state_from_jax`` takes a JAX ``TrackTable`` / ``BAState`` /
``BAProblem`` / ``PoseGraph`` / ``PoseGraphSim3`` and reads its leaves
with ``np.asarray``; ``sfm_result_from_jax`` a whole JAX ``SfmResult``.  The dewarp slice
has no trained state either: what it carries across is the distortion map
(``distortion_map_from_jax``) and the (5,) coefficient vector, a plain list
of floats.  So this module needs no JAX.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from photogrammetry_tpu_torch import resolve_device
from photogrammetry_tpu_torch.sfm.ba import BAProblem, BAState
from photogrammetry_tpu_torch.sfm.frontend import FrontendConfig
from photogrammetry_tpu_torch.sfm.incremental import SfmConfig, SfmResult
from photogrammetry_tpu_torch.sfm.pose_graph import PoseGraph, PoseGraphSim3
from photogrammetry_tpu_torch.sfm.tracks import TrackTable

JAX_ONLY_KEYS = ("use_pallas_matching", "use_pallas_detect")
STATE_TYPES = {cls.__name__: cls for cls in (TrackTable, BAState, BAProblem,
                                              PoseGraph, PoseGraphSim3)}


def _config(cls, d: dict):
    fields = {f.name for f in dataclasses.fields(cls)}
    unknown = set(d) - fields
    if unknown:
        raise ValueError(f"from_jax: unknown {cls.__name__} keys {unknown}")
    return cls(**d)


def _frontend_config(d: dict) -> FrontendConfig:
    cfg = {key: val for key, val in d.items() if key not in JAX_ONLY_KEYS}
    if "cluster_chunks" in cfg:
        cfg["cluster_chunks"] = tuple(cfg["cluster_chunks"])
    return _config(FrontendConfig, cfg)


def _sfm_config(d: dict) -> SfmConfig:
    cfg = dict(d)
    if cfg.get("mesh") is not None:
        raise ValueError("from_jax: SfmConfig.mesh holds a JAX Mesh, which "
                         "cannot be carried across; set the port's "
                         "SfmConfig.mesh to a parallel.make_mesh(...) mesh "
                         "instead")
    cfg["frontend"] = _frontend_config(cfg.get("frontend", {}))
    return _config(SfmConfig, cfg)


def from_jax(pairs: np.ndarray, k: np.ndarray, config: dict, device="cuda"):
    """→ (pairs (P, 2, 2) int32 tensor, K (3, 3) float32 tensor, config) on
    ``device``.  ``config`` is ``dataclasses.asdict`` of a JAX
    FrontendConfig (→ FrontendConfig, the ``use_pallas_*`` keys dropped)
    or of a JAX SfmConfig (→ SfmConfig, every field carried; ValueError
    for a mesh, a JAX object: the port's ``SfmConfig.mesh`` takes a
    ``parallel.make_mesh`` mesh)."""
    dev = resolve_device(device)
    cfg = (_sfm_config(config) if "frontend" in config
           else _frontend_config(config))
    pairs_t = torch.tensor(np.asarray(pairs, np.int32), device=dev)
    if pairs_t.dim() != 3 or pairs_t.shape[1:] != (2, 2):
        raise ValueError(f"from_jax: pairs of shape {tuple(pairs_t.shape)}")
    k_t = torch.tensor(np.asarray(k, np.float32), device=dev)
    return pairs_t.contiguous(), k_t, cfg


def state_from_jax(state, device="cuda"):
    """A JAX ``TrackTable``, ``BAState``, ``BAProblem``, ``PoseGraph`` or
    ``PoseGraphSim3`` → the port's NamedTuple of the same name, every leaf
    a tensor on ``device`` with the same dtype."""
    cls = STATE_TYPES.get(type(state).__name__)
    if cls is None or tuple(state._fields) != cls._fields:
        raise TypeError(f"state_from_jax: not a JAX "
                        f"{', '.join(STATE_TYPES)}: {type(state).__name__}")
    dev = resolve_device(device)
    return cls(*(torch.from_numpy(np.array(x)).to(dev) for x in state))


def sfm_result_from_jax(res, device="cuda") -> SfmResult:
    """A JAX ``SfmResult`` → the port's: rs and ts as float32 arrays, the
    ``TrackTable`` on ``device`` (``state_from_jax``), the costs and frame
    info, and ``quality`` (support, median px) where the robust run set
    it."""
    out = SfmResult(np.asarray(res.rs, np.float32),
                    np.asarray(res.ts, np.float32),
                    state_from_jax(res.table, device=device),
                    [float(c) for c in res.costs], list(res.frame_info))
    if hasattr(res, "quality"):
        out.quality = tuple(res.quality)
    return out


def distortion_map_from_jax(dist_map, device="cuda") -> torch.Tensor:
    """A distortion map of the JAX package (``np.asarray`` of what
    ``generate_distortion_map`` returned, or what ``DistortionMapCache``
    loaded) → the contiguous float32 (H, W, 2) tensor on ``device`` that
    ``apply_distortion_map`` and the remap kernel take.  The layout is the
    same in both packages: [..., 0] source row, [..., 1] source column."""
    arr = np.asarray(dist_map)
    if arr.ndim != 3 or arr.shape[-1] != 2:
        raise ValueError(f"distortion_map_from_jax: shape {arr.shape}, "
                         f"expected (H, W, 2)")
    if arr.dtype != np.float32:
        raise TypeError(f"distortion_map_from_jax: dtype {arr.dtype}, "
                        f"expected float32")
    dev = resolve_device(device)
    return torch.from_numpy(np.array(arr, order="C")).to(dev)
