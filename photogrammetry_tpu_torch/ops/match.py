"""Descriptor matching (port of photogrammetry_tpu/ops/match.py:
``hamming_distance_matrix``, ``mutual_nearest_matches``).

``hamming_distance_matrix`` here is the plain PyTorch version,
|a| + |b| - 2 a.b as one f32 matrix product (exact: 0/1 products and sums
of at most 2^24 terms, with TF32 off).  The frontend calls the popcount
kernel in ``kernels/hamming.py`` instead, whose wrapper runs this function
only for tensors on the CPU.
"""
from __future__ import annotations

import torch

INT_INF = 2 ** 31 - 1


def hamming_distance_matrix(bits1: torch.Tensor, bits2: torch.Tensor,
                            mask1: torch.Tensor | None = None,
                            mask2: torch.Tensor | None = None
                            ) -> torch.Tensor:
    """(N1, P), (N2, P) {0,1} → (N1, N2) int32 Hamming distances.

    Rows/cols whose mask is False get INT_INF distances.
    """
    a = bits1.to(torch.float32)
    b = bits2.to(torch.float32)
    ab = (a @ b.T).to(torch.int32)
    na = bits1.to(torch.int32).sum(dim=1, dtype=torch.int32)
    nb = bits2.to(torch.int32).sum(dim=1, dtype=torch.int32)
    d = na[:, None] + nb[None, :] - 2 * ab
    if mask1 is not None:
        d = torch.where(mask1[:, None], d, INT_INF)
    if mask2 is not None:
        d = torch.where(mask2[None, :], d, INT_INF)
    return d


def mutual_nearest_matches(dist: torch.Tensor, max_distance: int,
                           max_ratio: float | None = None):
    """Mutual nearest-neighbour matching, optionally with a Lowe ratio test.

    Ties go to the first index (``torch.argmin`` documents it, as
    ``jnp.argmin`` does).

    Returns (idx2 (N1,) int32 — match in set 2 for each row, or -1;
             d (N1,) int32 — its distance;
             valid (N1,) bool).
    """
    best2 = torch.argmin(dist, dim=1)  # (N1,)
    best1 = torch.argmin(dist, dim=0)  # (N2,)
    d = torch.gather(dist, 1, best2[:, None])[:, 0]
    mutual = best1[best2] == torch.arange(dist.shape[0], device=dist.device)
    valid = mutual & (d <= max_distance) & (d < INT_INF)
    if max_ratio is not None:
        masked = dist.scatter(1, best2[:, None], INT_INF)
        second = masked.min(dim=1).values
        ok = d.to(torch.float32) <= max_ratio * torch.clamp(
            second, max=INT_INF - 1).to(torch.float32)
        valid = valid & ok
    return torch.where(valid, best2, -1).to(torch.int32), d, valid
