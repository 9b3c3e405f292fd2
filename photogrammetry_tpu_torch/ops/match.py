"""Descriptor matching (port of photogrammetry_tpu/ops/match.py).

``hamming_distance_matrix`` here is the plain PyTorch version,
|a| + |b| - 2 a.b as one f32 matrix product (exact: 0/1 products and sums
of at most 2^24 terms, with TF32 off).  The frontend calls the tensor-core
kernel in ``kernels/hamming.py`` instead, whose wrapper runs this function
only for tensors on the CPU.  ``hamming_distance_matrix_pairs`` is the same
over a batch of frame pairs (loop closure's pair grid, the SfM sequence's
precomputed matches), ``mutual_nearest_matches_batch`` the matching over
such a batch and ``mutual_nearest_counts`` its match counts.

Match policies over a distance matrix: ``mutual_nearest_matches`` (the
frontend's), ``sorted_candidate_matches`` (per-row candidates by
distance), ``greedy_global_matches`` (repeatedly the globally smallest
remaining pair) and the ``motion_consistency_mask`` prefilter.
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


def mutual_nearest_matches_batch(dist: torch.Tensor, max_distance: int,
                                 max_ratio: float | None = None):
    """``mutual_nearest_matches`` for every matrix of a (Q, N1, N2) batch
    (the same ties, threshold and ratio test): (idx2 (Q, N1) int32, d
    (Q, N1) int32, valid (Q, N1) bool)."""
    best2 = torch.argmin(dist, dim=2)                     # (Q, N1)
    best1 = torch.argmin(dist, dim=1)                     # (Q, N2)
    d = torch.gather(dist, 2, best2[:, :, None])[:, :, 0]
    rows = torch.arange(dist.shape[1], device=dist.device)
    mutual = torch.gather(best1, 1, best2) == rows
    valid = mutual & (d <= max_distance) & (d < INT_INF)
    if max_ratio is not None:
        masked = dist.scatter(2, best2[:, :, None], INT_INF)
        second = masked.min(dim=2).values
        ok = d.to(torch.float32) <= max_ratio * torch.clamp(
            second, max=INT_INF - 1).to(torch.float32)
        valid = valid & ok
    return torch.where(valid, best2, -1).to(torch.int32), d, valid


def mutual_nearest_counts(dist: torch.Tensor,
                          max_distance: int) -> torch.Tensor:
    """(Q, N1, N2) distances → (Q,) int32 counts of the mutual-nearest
    matches within ``max_distance``, without a ratio test."""
    valid = mutual_nearest_matches_batch(dist, max_distance)[2]
    return valid.sum(dim=1, dtype=torch.int32)


def mutual_nearest_matches(dist: torch.Tensor, max_distance: int,
                           max_ratio: float | None = None):
    """Mutual nearest-neighbour matching, optionally with a Lowe ratio test.

    Ties go to the first index (``torch.argmin`` documents it, as
    ``jnp.argmin`` does).

    Returns (idx2 (N1,) int32 — match in set 2 for each row, or -1;
             d (N1,) int32 — its distance;
             valid (N1,) bool)."""
    idx2, d, valid = mutual_nearest_matches_batch(dist[None], max_distance,
                                                  max_ratio)
    return idx2[0], d[0], valid[0]


def sorted_candidate_matches(dist: torch.Tensor):
    """Per-row candidates sorted ascending by distance, equal distances in
    column order (a stable sort, as ``jnp.argsort``).

    Returns (indices (N1, N2) int32, distances (N1, N2) int32)."""
    d, order = torch.sort(dist, dim=1, stable=True)
    return order.to(torch.int32), d


def greedy_global_matches(dist: torch.Tensor, num_matches: int):
    """Greedy global assignment: ``num_matches`` times, take the globally
    smallest remaining (i, j) (the first in row-major order among equals)
    and remove row i and column j.  Once every entry is INT_INF a step
    gives (0, 0, INT_INF), invalid, as JAX's ``scan`` does.  The steps
    read nothing back to the host.

    Returns (i (M,) int32, j (M,) int32, d (M,) int32, valid (M,) bool)."""
    n1, n2 = dist.shape
    d = dist.clone()
    ii, jj, dd = [], [], []
    for _ in range(num_matches):
        flat = torch.argmin(d.reshape(-1)).reshape(1)
        i, j = flat // n2, flat % n2
        dd.append(d.reshape(-1).gather(0, flat))
        d.index_fill_(0, i, INT_INF)
        d.index_fill_(1, j, INT_INF)
        ii.append(i)
        jj.append(j)
    if not num_matches:
        empty = torch.zeros((0,), dtype=torch.int32, device=dist.device)
        return empty, empty, empty, empty.to(torch.bool)
    dd = torch.cat(dd)
    return (torch.cat(ii).to(torch.int32), torch.cat(jj).to(torch.int32),
            dd, dd < INT_INF)


def motion_consistency_mask(xy1: torch.Tensor, xy2: torch.Tensor,
                            mask: torch.Tensor,
                            neighbor_radius: float = 600.0,
                            agreement_radius: float = 80.0,
                            min_support: int = 2) -> torch.Tensor:
    """Motion-smoothness filter over candidate matches (GMS-style): a match
    survives iff at least ``min_support`` other valid matches whose
    image-1 points lie within ``neighbor_radius`` px have displacements
    within ``agreement_radius`` px of its own (strict ``<`` on the f32
    squared distances).  Two dense (N, N) distance matrices.

    Returns the refined (N,) bool mask."""
    d = xy2 - xy1
    nr2 = torch.tensor(neighbor_radius, dtype=torch.float32,
                       device=xy1.device) ** 2
    ar2 = torch.tensor(agreement_radius, dtype=torch.float32,
                       device=xy1.device) ** 2
    near = ((xy1[:, None] - xy1[None]) ** 2).sum(-1) < nr2
    agree = ((d[:, None] - d[None]) ** 2).sum(-1) < ar2
    both = mask[:, None] & mask[None, :]
    support = (near & agree & both).sum(dim=1, dtype=torch.int32) \
        - mask.to(torch.int32)
    return mask & (support >= min_support)
