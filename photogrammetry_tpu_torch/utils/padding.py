"""Static-shape helpers (port of photogrammetry_tpu/utils/padding.py).

Every variable-length collection (keypoints, matches) is carried as a
fixed-capacity tensor plus a validity mask and a count, as in the JAX
package, so that no step needs a device-to-host read of a length.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from photogrammetry_tpu_torch import resolve_device


def round_up(x: int, m: int) -> int:
    """Round ``x`` up to the next multiple of ``m``."""
    return ((x + m - 1) // m) * m


class PaddedPoints(NamedTuple):
    """Fixed-capacity point set.

    Attributes:
      coords: (K, 2) int32 — (row, col) image coordinates; undefined past count.
      score:  (K,) float32 — detector score (FAST longest-consecutive-run).
      mask:   (K,) bool — True for valid entries.
      count:  () int32 — number of valid entries (== mask.sum()).
    """

    coords: torch.Tensor
    score: torch.Tensor
    mask: torch.Tensor
    count: torch.Tensor

    @property
    def capacity(self) -> int:
        return self.coords.shape[0]


def front_indices(mask: torch.Tensor, capacity: int) -> torch.Tensor:
    """(capacity,) int64 indices of the True entries of ``mask`` in order,
    padded with 0 — ``jnp.nonzero(mask, size=capacity, fill_value=0)``
    without the device-to-host read that ``torch.nonzero`` needs."""
    n = mask.shape[0]
    order = torch.sort((~mask).to(torch.int32), stable=True).indices
    if capacity <= n:
        order = order[:capacity]
    else:
        order = torch.cat([order, order.new_zeros(capacity - n)])
    ntrue = mask.sum()
    pos = torch.arange(capacity, device=mask.device)
    return torch.where(pos < ntrue, order, torch.zeros_like(order))


def pad_to(coords, score, capacity: int, device="cuda") -> PaddedPoints:
    """A PaddedPoints on ``device`` from host arrays: (N, 2) (row, col)
    coords and (N,) scores padded to ``capacity``."""
    coords = np.asarray(coords, dtype=np.int32).reshape(-1, 2)
    score = np.asarray(score, dtype=np.float32).reshape(-1)
    n = coords.shape[0]
    if n > capacity:
        raise ValueError(f"{n} points exceed capacity {capacity}")
    out_c = np.zeros((capacity, 2), np.int32)
    out_s = np.zeros((capacity,), np.float32)
    out_m = np.zeros((capacity,), bool)
    out_c[:n] = coords
    out_s[:n] = score
    out_m[:n] = True
    dev = resolve_device(device)
    return PaddedPoints(torch.from_numpy(out_c).to(dev),
                        torch.from_numpy(out_s).to(dev),
                        torch.from_numpy(out_m).to(dev),
                        torch.tensor(n, dtype=torch.int32, device=dev))
