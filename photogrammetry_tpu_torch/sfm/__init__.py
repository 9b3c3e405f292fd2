"""Epipolar geometry, RANSAC, triangulation, two-view pose and metrics;
the SfM runs live in the submodules (``sfm.incremental`` ...)."""
from photogrammetry_tpu_torch.sfm.epipolar import (
    normalization_transform, eight_point_fundamental, ransac_fundamental,
    essential_from_fundamental, decompose_essential, epipolar_residuals,
)
from photogrammetry_tpu_torch.sfm.triangulate import (
    triangulate_dlt, cheirality_counts, select_pose,
)
from photogrammetry_tpu_torch.sfm.two_view import (
    two_view_pipeline, TwoViewResult,
)
from photogrammetry_tpu_torch.sfm.metrics import (
    align_umeyama, absolute_trajectory_error,
)
from photogrammetry_tpu_torch.sfm.incremental import (
    run_incremental_sfm_fused,
)

__all__ = ["normalization_transform", "eight_point_fundamental",
           "ransac_fundamental", "essential_from_fundamental",
           "decompose_essential", "epipolar_residuals", "triangulate_dlt",
           "cheirality_counts", "select_pose", "two_view_pipeline",
           "TwoViewResult", "align_umeyama", "absolute_trajectory_error",
           "run_incremental_sfm_fused"]
