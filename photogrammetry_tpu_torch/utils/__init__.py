"""Padding helpers, profiling and run-stats logging."""
from photogrammetry_tpu_torch.utils.padding import (
    PaddedPoints, pad_to, round_up,
)

__all__ = ["PaddedPoints", "pad_to", "round_up"]
