"""Everything a run draws from its ``--seed``: the order in which requests
take the pool's inputs, each request's own seed, and which requests'
outputs are kept and checked.  Every seed gets the same pool sizes and
the same work; only the scenes and the order differ."""
from __future__ import annotations

import numpy as np


def _rng(seed: int, *stream: int) -> np.random.Generator:
    return np.random.default_rng(np.random.SeedSequence(
        [int(x) % 2 ** 64 for x in (seed, *stream)]))


def pool_order(seed: int, pool: int, n: int = 4096) -> np.ndarray:
    """The pool index of request i, for i < n: passes over the pool, each
    pass in its own order."""
    rng = _rng(seed, 1)
    return np.concatenate([rng.permutation(pool)
                           for _ in range(-(-n // pool))])[:n]


def request_seed(seed: int, i: int) -> int:
    """Request i's own RANSAC seed, a 63-bit whole number."""
    return int(_rng(seed, 2, i).integers(0, 2 ** 63 - 1))


def kept(seed: int, i: int, every: int) -> bool:
    """Whether request i's outputs are kept for the check: one request in
    ``every`` on average, drawn from the seed."""
    return bool(_rng(seed, 3, i).integers(0, every) == 0)


def pick(seed: int, candidates: list, count: int) -> list:
    """``count`` of ``candidates`` (all where there are fewer), drawn from
    the seed, in their own order."""
    if len(candidates) <= count:
        return list(candidates)
    idx = np.sort(_rng(seed, 4).choice(len(candidates), count,
                                       replace=False))
    return [candidates[i] for i in idx]
