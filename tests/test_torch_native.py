"""Port parity: ``native.py``, the ctypes binding of native/host_ops.cpp,
against the JAX package's binding and the port's own fallbacks
(``ops/cluster.hierarchical_cluster_exact``,
``ops/match.greedy_global_matches``); exact, as the JAX package's
tests/test_native.py holds its binding to its fallbacks."""
import hashlib

import numpy as np
import pytest

from _torch_threads import _one_thread  # noqa: F401
from photogrammetry_tpu import native as jax_native
from photogrammetry_tpu_torch import native
from photogrammetry_tpu_torch.kernels._build import BUILD_DIR

COMMITTED = native.SOURCE.parent / "libphoto_host.so"


def _sha(path):
    return hashlib.sha256(path.read_bytes()).hexdigest()


@pytest.fixture(scope="module")
def committed_hash():
    """The JAX package's library as it was before the port's build."""
    return _sha(COMMITTED) if COMMITTED.exists() else None


@pytest.fixture
def fallback(monkeypatch):
    """The binding with no library: every entry point runs its fallback."""
    monkeypatch.setattr(native, "_load", lambda: None)


def test_library_builds_under_build_dir(committed_hash):
    assert native.available(), "g++ build of host_ops.cpp failed"
    path = native.library_path()
    assert path.exists() and path.parent == BUILD_DIR
    assert path.name.startswith("libphoto_host-")
    assert (_sha(COMMITTED) if COMMITTED.exists() else None) == committed_hash


def test_available_reports_the_fallback(fallback):
    assert not native.available()


CLUSTER_CASES = [(40, 150, 200, 15.0), (41, 400, 300, 25.0),
                 (42, 60, 50, 8.0)]


@pytest.mark.parametrize("seed,n,size,dist", CLUSTER_CASES)
def test_cluster_exact_matches_jax_native(seed, n, size, dist):
    coords = np.random.default_rng(seed).integers(
        0, size, (n, 2)).astype(np.int32)
    got = native.cluster_exact(coords, dist)
    ref = jax_native.cluster_exact(coords, dist)
    assert got.dtype == np.int32
    np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("seed,n,size,dist", CLUSTER_CASES)
def test_cluster_exact_fallback_same_centroids(seed, n, size, dist):
    coords = np.random.default_rng(seed).integers(
        0, size, (n, 2)).astype(np.int32)
    got = native.cluster_exact(coords, dist)
    from photogrammetry_tpu_torch.ops.cluster import (
        hierarchical_cluster_exact,
    )
    ref = hierarchical_cluster_exact(coords, dist)
    assert sorted(map(tuple, got.tolist())) == \
        sorted(map(tuple, ref.tolist()))


def test_cluster_exact_empty_and_single():
    assert len(native.cluster_exact(np.zeros((0, 2), np.int32), 10.0)) == 0
    assert native.cluster_exact(np.array([[5, 7]], np.int32),
                                10.0).tolist() == [[5, 7]]


GREEDY_CASES = [(41, 40, 30, None), (43, 30, 40, 12), (44, 1, 5, None)]


@pytest.mark.parametrize("seed,n1,n2,m", GREEDY_CASES)
def test_greedy_match_matches_jax_native_and_fallback(monkeypatch, seed, n1,
                                                      n2, m):
    d = np.random.default_rng(seed).integers(0, 256, (n1, n2)).astype(
        np.int32)
    got = native.greedy_match(d, m)
    for ref in (jax_native.greedy_match(d, m), None):
        if ref is None:
            monkeypatch.setattr(native, "_load", lambda: None)
            ref = native.greedy_match(d, m)
        for a, b in zip(got, ref):
            assert a.dtype == np.int32
            np.testing.assert_array_equal(a, b)
    assert len(got[0]) == (min(n1, n2) if m is None else m)
