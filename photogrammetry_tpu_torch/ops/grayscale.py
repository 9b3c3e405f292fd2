"""Color → grayscale conversion (port of photogrammetry_tpu/ops/grayscale.py).

``bgr_to_gray_cv2`` reproduces OpenCV's fixed-point BGR2GRAY bit for bit, so
the reference's keypoint-count oracles hold; ``rgb_to_gray_mean`` is the
channel mean of the reference's C# tree.
"""
from __future__ import annotations

import torch

# OpenCV CV_DESCALE fixed-point BGR2GRAY coefficients (14-bit)
_R, _G, _B = 4899, 9617, 1868
_SHIFT = 14


def bgr_to_gray_cv2(bgr: torch.Tensor) -> torch.Tensor:
    """uint8 BGR (..., 3) → int32 grayscale (...), bit-exact with OpenCV:
    gray = (R*4899 + G*9617 + B*1868 + 2^13) >> 14."""
    px = bgr.to(torch.int32)
    b, g, r = px[..., 0], px[..., 1], px[..., 2]
    return (r * _R + g * _G + b * _B + (1 << (_SHIFT - 1))) >> _SHIFT


def rgb_to_gray_mean(rgb: torch.Tensor) -> torch.Tensor:
    """(..., 3) → (...) float32 channel mean."""
    return rgb.to(torch.float32).mean(dim=-1)
