"""Carry the JAX package's state into the port.

This system's "weights" are the BRIEF pair table (drawn from ``jax.random``
by the JAX ``make_pairs``), the intrinsics K and the frontend
configuration.  ``from_jax`` takes them as plain numpy arrays and a dict
(``np.asarray(make_pairs(cfg))``, ``dataclasses.asdict(cfg)``), so this
module needs no JAX.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from photogrammetry_tpu_torch import resolve_device
from photogrammetry_tpu_torch.sfm.frontend import FrontendConfig

JAX_ONLY_KEYS = ("use_pallas_matching", "use_pallas_detect")


def from_jax(pairs: np.ndarray, k: np.ndarray, frontend_config: dict,
             device="cuda"):
    """→ (pairs (P, 2, 2) int32 tensor, K (3, 3) float32 tensor,
    FrontendConfig) on ``device``; the JAX-only ``use_pallas_*`` keys are
    dropped."""
    dev = resolve_device(device)
    fields = {f.name for f in dataclasses.fields(FrontendConfig)}
    cfg = {key: val for key, val in frontend_config.items()
           if key not in JAX_ONLY_KEYS}
    unknown = set(cfg) - fields
    if unknown:
        raise ValueError(f"from_jax: unknown FrontendConfig keys {unknown}")
    if "cluster_chunks" in cfg:
        cfg["cluster_chunks"] = tuple(cfg["cluster_chunks"])
    pairs_t = torch.tensor(np.asarray(pairs, np.int32), device=dev)
    if pairs_t.dim() != 3 or pairs_t.shape[1:] != (2, 2):
        raise ValueError(f"from_jax: pairs of shape {tuple(pairs_t.shape)}")
    k_t = torch.tensor(np.asarray(k, np.float32), device=dev)
    return pairs_t.contiguous(), k_t, FrontendConfig(**cfg)
