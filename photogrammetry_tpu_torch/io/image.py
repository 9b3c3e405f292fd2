"""Image file I/O (port of photogrammetry_tpu/io/image.py).

Pillow is imported inside the functions: only the file-reading entry points
need it, and a machine that runs the rest of the port may not have it.
Returns numpy arrays on the host; device placement is the caller's job.
"""
from __future__ import annotations

import numpy as np


def read_image(path: str, grayscale: bool = False) -> np.ndarray:
    from PIL import Image

    with Image.open(path) as img:
        if grayscale:
            return np.array(img.convert("L"), np.uint8)
        return np.array(img.convert("RGB"), np.uint8)


def write_image(path: str, array) -> None:
    from PIL import Image

    arr = np.asarray(array)
    if arr.dtype != np.uint8:
        arr = np.clip(arr, 0, 255).astype(np.uint8)
    Image.fromarray(arr).save(path)
