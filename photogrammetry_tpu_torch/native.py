"""ctypes bindings for the native host library ``native/host_ops.cpp``
(port of photogrammetry_tpu/native.py).

``g++`` builds the library at first use into ``build/photogrammetry_tpu_torch/``
at the repository root, under a name that carries a hash of the source and
the flags (as ``kernels/_build.py`` names the CUDA kernels), so an edited
source is rebuilt; the committed ``native/libphoto_host.so`` is the JAX
package's and is never written.  Every entry point has a fallback, the
port's ``ops/cluster.hierarchical_cluster_exact`` and
``ops/match.greedy_global_matches``, so the package works without a
toolchain; ``available()`` says whether the library loaded.  The native
tier holds only inherently sequential host algorithms.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path

import numpy as np

from photogrammetry_tpu_torch.kernels._build import BUILD_DIR

SOURCE = Path(__file__).resolve().parents[1] / "native" / "host_ops.cpp"
# no -march=native (the JAX package's flag): the build directory travels
# with the checkout to machines with other CPUs
GXX_FLAGS = ("-O3", "-std=c++17", "-shared", "-fPIC")

_lock = threading.Lock()
_lib = None
_tried = False


def library_path() -> Path:
    digest = hashlib.sha256(SOURCE.read_bytes()
                            + " ".join(GXX_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"libphoto_host-{digest[:16]}.so"


def _build() -> Path:
    out = library_path()
    if not out.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        subprocess.run(["g++", *GXX_FLAGS, str(SOURCE), "-o", str(tmp)],
                       check=True, capture_output=True, timeout=120)
        os.replace(tmp, out)
    return out


def _load():
    global _lib, _tried
    with _lock:
        if _tried:
            return _lib
        _tried = True
        try:
            lib = ctypes.CDLL(str(_build()))
        except (OSError, subprocess.SubprocessError):
            return None         # no toolchain: the fallbacks run
        lib.pg_cluster_exact.restype = ctypes.c_int
        lib.pg_cluster_exact.argtypes = [
            ctypes.POINTER(ctypes.c_int32), ctypes.c_int,
            ctypes.c_double, ctypes.POINTER(ctypes.c_double)]
        lib.pg_greedy_match.restype = ctypes.c_int
        lib.pg_greedy_match.argtypes = [
            ctypes.POINTER(ctypes.c_int32), ctypes.c_int, ctypes.c_int,
            ctypes.c_int, ctypes.POINTER(ctypes.c_int32),
            ctypes.POINTER(ctypes.c_int32),
            ctypes.POINTER(ctypes.c_int32)]
        _lib = lib
        return _lib


def available() -> bool:
    """Whether the native library is built and loaded (else the entry
    points run their fallbacks)."""
    return _load() is not None


def _ptr(a: np.ndarray, ctype):
    return a.ctypes.data_as(ctypes.POINTER(ctype))


def cluster_exact(coords: np.ndarray, max_merge_dist: float) -> np.ndarray:
    """Exact hierarchical clustering (reference semantics); returns rounded
    int32 centroids.  Native when possible, the Python fallback
    otherwise."""
    coords = np.ascontiguousarray(coords, np.int32).reshape(-1, 2)
    lib = _load()
    if lib is None:
        from photogrammetry_tpu_torch.ops.cluster import (
            hierarchical_cluster_exact,
        )
        return hierarchical_cluster_exact(coords, max_merge_dist)
    out = np.empty((len(coords), 2), np.float64)
    m = lib.pg_cluster_exact(_ptr(coords, ctypes.c_int32), len(coords),
                             float(max_merge_dist),
                             _ptr(out, ctypes.c_double))
    return np.round(out[:m]).astype(np.int32)


def greedy_match(dist: np.ndarray, num_matches: int | None = None):
    """Greedy global mutual assignment (KeypointMatching.cs semantics) on
    an (N1, N2) int32 distance matrix.

    Returns (i, j, d) int32 arrays of length <= num_matches.
    """
    dist = np.ascontiguousarray(dist, np.int32)
    n1, n2 = dist.shape
    m = min(n1, n2) if num_matches is None else min(num_matches, n1, n2)
    lib = _load()
    if lib is None:
        import torch

        from photogrammetry_tpu_torch.ops.match import greedy_global_matches
        ii, jj, dd, valid = (x.numpy() for x in greedy_global_matches(
            torch.from_numpy(dist), m))
        return ii[valid], jj[valid], dd[valid]
    out_i = np.empty(m, np.int32)
    out_j = np.empty(m, np.int32)
    out_d = np.empty(m, np.int32)
    k = lib.pg_greedy_match(_ptr(dist, ctypes.c_int32), n1, n2, m,
                            _ptr(out_i, ctypes.c_int32),
                            _ptr(out_j, ctypes.c_int32),
                            _ptr(out_d, ctypes.c_int32))
    return out_i[:k], out_j[:k], out_d[:k]
