"""Keypoint clustering (port of photogrammetry_tpu/ops/cluster.py).

Agglomerative clustering with city-block distance between weighted
centroids: repeatedly merge the closest pair of clusters with distance
<= max_merge_dist.  ``grid_cluster_keypoints`` splits the image into a
grid of chunks (4x4 by default) and clusters each chunk on padded
fixed-capacity tensors, all chunks as one batch; ``hierarchical_cluster_exact``
is the host-side numpy replica of the reference's sequential semantics
(the port's own copy of the JAX package's).
"""
from __future__ import annotations

import heapq

import numpy as np
import torch

from photogrammetry_tpu_torch.utils.padding import PaddedPoints, front_indices

_INF = 1e30
# steps between the host reads that end the merge loop early
CHECK_EVERY = 32


def _pair_dist(centers: torch.Tensor, rows: torch.Tensor) -> torch.Tensor:
    """(Q, C, 2) centres and (Q,) row indices → (Q, C) city-block
    distances from each chunk's centre ``rows[q]`` to all its centres."""
    q = torch.arange(centers.shape[0], device=centers.device)
    return (centers[q, rows][:, None, :] - centers).abs().sum(-1)


def cluster_chunks(centers: torch.Tensor, weights: torch.Tensor,
                   max_merge_dist: float,
                   check_every: int = CHECK_EVERY):
    """The agglomerative merge loop over a batch of padded chunks (JAX's
    ``_cluster_chunk``, vmapped there).

    centers (Q, C, 2) float32, weights (Q, C) float32 (0: empty slot) →
    (centers, weights) after ``C - 1`` merge steps; an absorbed slot gets
    weight 0.  Each step merges, in every chunk, the pair (i < j) of
    active clusters at the least distance (the first in row-major order
    among equal distances, as ``jnp.argmin``), if it is within
    ``max_merge_dist``; cluster i takes the weighted centroid
    ``(c_i w_i + c_j w_j) / max(w_i + w_j, 1e-9)``.

    The (Q, C, C) masked distance matrix is built once and updated where a
    merge changed it (cluster i's row and column, cluster j's cleared), so
    a step costs one argmin over it.  Once a step merges nothing in any
    chunk the state can no longer change, so the loop ends there; whether
    it has is read back every ``check_every`` steps.  The result equals
    the full ``C - 1`` steps.
    """
    centers = centers.clone()
    weights = weights.clone()
    nq, cap = weights.shape
    dev = centers.device
    if cap < 2:
        return centers, weights
    upper = torch.triu(torch.ones((cap, cap), dtype=torch.bool, device=dev),
                       diagonal=1)
    active = weights > 0
    d = (centers[:, :, None, :] - centers[:, None, :, :]).abs().sum(-1)
    d = torch.where(upper & active[:, :, None] & active[:, None, :], d,
                    _INF)
    q = torch.arange(nq, device=dev)
    slots = torch.arange(cap, device=dev)
    for step in range(cap - 1):
        flat = torch.argmin(d.reshape(nq, -1), dim=1)
        i, j = flat // cap, flat % cap
        merge = d.reshape(nq, -1)[q, flat] <= max_merge_dist       # (Q,)
        wi, wj = weights[q, i], weights[q, j]
        new_center = (centers[q, i] * wi[:, None]
                      + centers[q, j] * wj[:, None]) \
            / torch.clamp(wi + wj, min=1e-9)[:, None]
        centers[q, i] = torch.where(merge[:, None], new_center,
                                    centers[q, i])
        weights[q, i] = torch.where(merge, wi + wj, wi)
        weights[q, j] = torch.where(merge, 0.0, wj)
        # cluster i's distances to the active clusters, in both triangles;
        # cluster j's row and column leave the matrix
        active = weights > 0
        di = torch.where(active, _pair_dist(centers, i), _INF)    # (Q, C)
        row = torch.where(slots[None, :] > i[:, None], di, _INF)
        col = torch.where(slots[None, :] < i[:, None], di, _INF)
        m = merge[:, None]
        d[q, i, :] = torch.where(m, row, d[q, i, :])
        d[q, :, i] = torch.where(m, col, d[q, :, i])
        d[q, j, :] = torch.where(m, _INF, d[q, j, :])
        d[q, :, j] = torch.where(m, _INF, d[q, :, j])
        if step % check_every == check_every - 1 and not bool(merge.any()):
            break
    return centers, weights


def grid_cluster_keypoints(points: PaddedPoints, height: int, width: int,
                           max_merge_dist: float = 25.0,
                           chunks: tuple = (4, 4),
                           chunk_capacity: int = 256) -> PaddedPoints:
    """Chunked hierarchical clustering → clustered centroids.

    A point's chunk is its coordinate floor-divided by the chunk pitch,
    clamped to the last cell; each chunk keeps its first
    ``chunk_capacity`` points in index order.  Output: rounded centroids
    (half to even), score = cluster size, capacity chunks x
    chunk_capacity, in chunk-major slot order.
    """
    ch, cw = chunks
    pitch_h = height // ch
    pitch_w = width // cw
    dev = points.coords.device
    hc = torch.clamp(points.coords[:, 0] // pitch_h, max=ch - 1)
    wc = torch.clamp(points.coords[:, 1] // pitch_w, max=cw - 1)
    chunk_id = hc * cw + wc
    n_chunks = ch * cw
    sel = points.mask[None, :] & (
        chunk_id[None, :] == torch.arange(n_chunks, device=dev)[:, None])
    idx = torch.stack([front_indices(s, chunk_capacity) for s in sel])
    got = (torch.arange(chunk_capacity, device=dev)[None, :]
           < sel.sum(dim=1, keepdim=True))
    centers = torch.where(got[:, :, None],
                          points.coords[idx].to(torch.float32), 0.0)
    weights = got.to(torch.float32)

    centers, weights = cluster_chunks(centers, weights, max_merge_dist)

    flat_centers = centers.reshape(-1, 2)
    flat_weights = weights.reshape(-1)
    out_cap = n_chunks * chunk_capacity
    live = flat_weights > 0
    idx = front_indices(live, out_cap)
    n = live.sum().to(torch.int32)
    valid = torch.arange(out_cap, device=dev) < n
    coords = torch.round(flat_centers[idx]).to(torch.int32)
    return PaddedPoints(
        coords=torch.where(valid[:, None], coords, 0),
        score=torch.where(valid, flat_weights[idx], 0.0),
        mask=valid,
        count=n,
    )


def hierarchical_cluster_exact(coords: np.ndarray,
                               max_merge_dist: float = 25.0,
                               return_linkage: bool = False):
    """Host-side exact replica of the reference's sequential clustering.

    coords: (N, 2) int array.  Returns (M, 2) int32 rounded centroids in
    the reference's output order (iteration over surviving cluster ids).

    With ``return_linkage`` also returns the scipy-style linkage matrix:
    one row ``[id1, id2, distance, new_count]`` per merge, new clusters
    numbered ``n0, n0+1, ...`` in merge order.
    """
    n0 = len(coords)
    # centres by cluster id (merged clusters are numbered from n0 on)
    centers = np.zeros((max(2 * n0 - 1, 1), 2), np.float64)
    centers[:n0] = coords
    counts = np.zeros(len(centers), np.int64)
    counts[:n0] = 1
    active = set(range(n0))
    next_id = n0

    # Min-heap keyed by (distance, insertion sequence): pops in the order
    # of the reference's stable sort-by-distance pair list (ties break by
    # insertion order).  Pairs whose clusters died are skipped lazily.
    heap = []
    seq = 0
    if n0 > 1:
        arr = coords.astype(np.float64)
        for j in range(n0):
            d = np.abs(arr[:j] - arr[j]).sum(axis=1)
            for i in np.nonzero(d <= max_merge_dist)[0]:
                heapq.heappush(heap, (d[i], seq, int(i), j))
                seq += 1

    linkage = []
    while heap:
        dist, _, c1, c2 = heapq.heappop(heap)
        if c1 not in active or c2 not in active:
            continue
        active.discard(c1)
        active.discard(c2)
        n = counts[c1] + counts[c2]
        linkage.append((c1, c2, dist, n))
        center = (centers[c1] * counts[c1] + centers[c2] * counts[c2]) / n
        cid = next_id
        next_id += 1
        centers[cid] = center
        counts[cid] = n
        # the new cluster's pairs, pushed in the set's iteration order
        # (the reference's loop over the surviving clusters), distances
        # |dx| + |dy| in float64 for all of them at once
        others = np.fromiter(active, np.int64, len(active))
        dd = np.abs(centers[others] - center).sum(axis=1)
        for other, d in zip(others[dd <= max_merge_dist].tolist(),
                            dd[dd <= max_merge_dist].tolist()):
            heapq.heappush(heap, (d, seq, other, cid))
            seq += 1
        active.add(cid)

    out = [np.round(centers[i]).astype(np.int32) for i in sorted(active)]
    cents = np.stack(out) if out else np.zeros((0, 2), np.int32)
    if return_linkage:
        z = (np.asarray(linkage, np.float64).reshape(-1, 4)
             if linkage else np.zeros((0, 4), np.float64))
        return cents, z
    return cents
