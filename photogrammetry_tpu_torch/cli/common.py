"""Shared CLI plumbing (port of photogrammetry_tpu/cli/common.py)."""
from __future__ import annotations

import numpy as np


def load_gray(path: str) -> np.ndarray:
    """An image file as float32 grayscale, with OpenCV's fixed-point
    BGR2GRAY weights when the file is color (on the host: one small integer
    op per frame, before anything is uploaded)."""
    import torch

    from photogrammetry_tpu_torch.io.image import read_image
    from photogrammetry_tpu_torch.ops.grayscale import bgr_to_gray_cv2

    rgb = read_image(path)
    if rgb.ndim == 2:
        return rgb.astype(np.float32)
    bgr = torch.from_numpy(np.ascontiguousarray(rgb[..., ::-1]))
    return bgr_to_gray_cv2(bgr).numpy().astype(np.float32)
