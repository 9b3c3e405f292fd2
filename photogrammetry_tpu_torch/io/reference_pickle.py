"""Load keypoints pickled by the reference's KeypointCache (the port's
copy of photogrammetry_tpu/io/reference_pickle.py; numpy and the standard
library only).

The reference persists detected keypoints as pickled lists of its
``photogrammetry.image_processing.keypoint_detection.KeyPoint`` objects
(python_src/photogrammetry/storage/keypoint_cache.py:28-71; committed
fixtures at data/feature_matching_test/*_keypoints.dat).  Unpickling those
files normally requires the reference package on the path; this module
substitutes a stand-in class via a restricted Unpickler so the committed
reference artifacts can be consumed as parity-test inputs without importing
any reference code.

Only the two classes the pickles actually need (the KeyPoint shim and numpy
scalar reconstruction) are resolvable; everything else raises.
"""
from __future__ import annotations

import io
import pickle

import numpy as np


class ReferenceKeyPoint:
    """Attribute bag matching the reference KeyPoint's pickled state:
    ``coord`` [x, y], ``moment`` float, ``descriptor`` 256-bit int
    (python_src/photogrammetry/models/keypoint.py:19-57)."""

    coord: list
    moment: float
    descriptor: int

    def __repr__(self) -> str:  # pragma: no cover
        return f"ReferenceKeyPoint(coord={getattr(self, 'coord', None)})"


try:  # numpy 2.x moved the internals; the pickle path name is historical
    _np_scalar = np._core.multiarray.scalar
except AttributeError:  # pragma: no cover - numpy 1.x
    _np_scalar = np.core.multiarray.scalar

_ALLOWED = {
    ("numpy.core.multiarray", "scalar"): _np_scalar,
    ("numpy", "dtype"): np.dtype,
}


class _RefUnpickler(pickle.Unpickler):
    def find_class(self, module, name):  # noqa: D102
        if name == "KeyPoint" and module.startswith("photogrammetry"):
            return ReferenceKeyPoint
        if (module, name) in _ALLOWED:
            return _ALLOWED[(module, name)]
        raise pickle.UnpicklingError(
            f"refusing to unpickle {module}.{name} from reference data")


def load_reference_keypoints(path: str):
    """Returns (coords (N, 2) int32 [x, y], descriptors (N, 256) uint8 bits,
    moments (N,) float32) from a reference ``*_keypoints.dat`` file.

    Descriptor bit i of the reference's arbitrary-precision int
    (Keypoint descriptor convention, keypoint.py:32-50) maps to column i.
    """
    with open(path, "rb") as fh:
        kps = _RefUnpickler(io.BufferedReader(fh)).load()
    coords = np.array([kp.coord for kp in kps], np.int32).reshape(-1, 2)
    moments = np.array([float(getattr(kp, "moment", 0.0)) for kp in kps],
                       np.float32)
    bits = np.zeros((len(kps), 256), np.uint8)
    for row, kp in enumerate(kps):
        d = int(getattr(kp, "descriptor", 0))
        raw = np.frombuffer(d.to_bytes(32, "little"), np.uint8)
        bits[row] = np.unpackbits(raw, bitorder="little")
    return coords, bits, moments
