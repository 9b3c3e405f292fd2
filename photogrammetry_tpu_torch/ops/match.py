"""Descriptor matching (port of photogrammetry_tpu/ops/match.py:
``hamming_distance_matrix``, ``mutual_nearest_matches``).

``hamming_distance_matrix`` here is the plain PyTorch version,
|a| + |b| - 2 a.b as one f32 matrix product (exact: 0/1 products and sums
of at most 2^24 terms, with TF32 off).  The frontend calls the tensor-core
kernel in ``kernels/hamming.py`` instead, whose wrapper runs this function
only for tensors on the CPU.  ``hamming_distance_matrix_pairs`` is the same
over a batch of frame pairs (loop closure's pair grid), and
``mutual_nearest_counts`` the batched match count that reads it.
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


def hamming_distance_matrix_pairs(bits: torch.Tensor, masks: torch.Tensor,
                                 ii: torch.Tensor, jj: torch.Tensor
                                 ) -> torch.Tensor:
    """(F, K, P) {0,1} bits, (F, K) bool masks and (Q,) frame indices →
    (Q, K, K) int32: pair q is ``hamming_distance_matrix(bits[ii[q]],
    bits[jj[q]], masks[ii[q]], masks[jj[q]])``, as one batched f32
    product (exact, TF32 off)."""
    ii = ii.to(torch.int64)
    jj = jj.to(torch.int64)
    a = bits[ii].to(torch.float32)
    b = bits[jj].to(torch.float32)
    ab = torch.bmm(a, b.transpose(1, 2)).to(torch.int32)
    counts = bits.to(torch.int32).sum(dim=2, dtype=torch.int32)
    d = counts[ii][:, :, None] + counts[jj][:, None, :] - 2 * ab
    ok = masks[ii][:, :, None] & masks[jj][:, None, :]
    return torch.where(ok, d, INT_INF)


def mutual_nearest_counts(dist: torch.Tensor,
                          max_distance: int) -> torch.Tensor:
    """(Q, N1, N2) distances → (Q,) int32 counts of the mutual-nearest
    matches within ``max_distance``: ``mutual_nearest_matches``' valid
    rows, without a ratio test, for every matrix of the batch (ties go to
    the first index)."""
    best2 = torch.argmin(dist, dim=2)                     # (Q, N1)
    best1 = torch.argmin(dist, dim=1)                     # (Q, N2)
    d = torch.gather(dist, 2, best2[:, :, None])[:, :, 0]
    rows = torch.arange(dist.shape[1], device=dist.device)
    mutual = torch.gather(best1, 1, best2) == rows
    valid = mutual & (d <= max_distance) & (d < INT_INF)
    return valid.sum(dim=1, dtype=torch.int32)


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
