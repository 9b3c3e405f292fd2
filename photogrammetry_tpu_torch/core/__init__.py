"""SO(3)/SE(3), the camera model and the closed-form cubic solver."""
from photogrammetry_tpu_torch.core.cubic import solve_cubic_real
from photogrammetry_tpu_torch.core.lie import (
    so3_exp, so3_log, so3_hat, se3_exp, se3_log,
)
from photogrammetry_tpu_torch.core.camera import (
    intrinsic_matrix, project_points, normalize_pixels, REFERENCE_K,
)

__all__ = ["solve_cubic_real", "so3_exp", "so3_log", "so3_hat", "se3_exp",
           "se3_log", "intrinsic_matrix", "project_points",
           "normalize_pixels", "REFERENCE_K"]
