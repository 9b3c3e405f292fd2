"""On-disk caches for expensive intermediates (port of
photogrammetry_tpu/store/cache.py).

Distortion maps are keyed by dimensions + coefficients and stored as .npz
under the JAX package's file name and array key, so either package reads a
cache the other wrote.  Detected keypoints are keyed by the image file's
content hash plus the detection configuration (the BRIEF pair seed is part
of it, which is what makes cached descriptors comparable across runs).
"""
from __future__ import annotations

import hashlib
import json
import os

import numpy as np


class DistortionMapCache:
    """dims+coefficients → (H, W, 2) float32 map, stored as .npz."""

    def __init__(self, cache_dir: str = "./data/distortion_maps"):
        self.cache_dir = cache_dir

    def _path(self, height: int, width: int, coeffs) -> str:
        coeff_str = "_".join(repr(float(c)) for c in coeffs)
        name = f"dim_{width}x{height}_coeff_{coeff_str}.npz"
        return os.path.join(self.cache_dir, name)

    def get_or_generate(self, height: int, width: int, coeffs,
                        refresh: bool = False, *,
                        device="cuda") -> np.ndarray:
        """The cached map as numpy, generated on ``device`` when absent."""
        path = self._path(height, width, coeffs)
        if not refresh and os.path.isfile(path):
            return np.load(path)["map"]
        from photogrammetry_tpu_torch.ops.dewarp import (
            generate_distortion_map,
        )

        dist_map = generate_distortion_map(
            height, width, np.asarray(coeffs, np.float32),
            device=device).cpu().numpy()
        os.makedirs(self.cache_dir, exist_ok=True)
        np.savez_compressed(path, map=dist_map)
        return dist_map


class KeypointCache:
    """(image path, threshold, reduction, pair seed) → keypoints+descriptors.

    JSON index + one .npz per entry, keyed by the content hash of the image
    file plus the detection configuration.
    """

    def __init__(self, cache_dir: str = "./data/keypoint_cache"):
        self.cache_dir = cache_dir
        self.index_path = os.path.join(cache_dir, "index.json")

    def _load_index(self) -> dict:
        if os.path.isfile(self.index_path):
            with open(self.index_path) as fh:
                return json.load(fh)
        return {}

    def _key(self, image_path: str, **config) -> str:
        h = hashlib.sha256()
        with open(image_path, "rb") as fh:
            h.update(fh.read())
        h.update(json.dumps(config, sort_keys=True).encode())
        return h.hexdigest()[:32]

    def get(self, image_path: str, **config):
        key = self._key(image_path, **config)
        entry = self._load_index().get(key)
        if entry is None:
            return None
        data = np.load(os.path.join(self.cache_dir, entry["file"]))
        return {k: data[k] for k in data.files}

    def put(self, image_path: str, arrays: dict, **config) -> None:
        key = self._key(image_path, **config)
        os.makedirs(self.cache_dir, exist_ok=True)
        fname = f"{key}.npz"
        np.savez_compressed(os.path.join(self.cache_dir, fname),
                            **{k: np.asarray(v) for k, v in arrays.items()})
        index = self._load_index()
        index[key] = {"file": fname, "image": os.path.basename(image_path),
                      "config": config}
        with open(self.index_path, "w") as fh:
            json.dump(index, fh, indent=1, sort_keys=True)
