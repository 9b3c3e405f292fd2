"""Image and descriptor operations: the plain PyTorch versions (the
frontend reaches the CUDA kernels through ``kernels/``)."""
from photogrammetry_tpu_torch.ops.grayscale import (
    bgr_to_gray_cv2, rgb_to_gray_mean,
)
from photogrammetry_tpu_torch.ops.fast import fast_score_map, extract_keypoints
from photogrammetry_tpu_torch.ops.brief import (
    gaussian_pairs, brief_descriptors,
)
from photogrammetry_tpu_torch.ops.match import (
    hamming_distance_matrix,
    mutual_nearest_matches,
    greedy_global_matches,
    sorted_candidate_matches,
    motion_consistency_mask,
)
from photogrammetry_tpu_torch.ops.nms import anms_keypoints, nms_keypoints
from photogrammetry_tpu_torch.ops.dewarp import (
    generate_distortion_map,
    apply_distortion_map,
    make_distortion_applier,
    solve_undistorted_radius,
)
from photogrammetry_tpu_torch.ops.cluster import grid_cluster_keypoints
from photogrammetry_tpu_torch.ops.calibrate import (
    calibrate_distortion,
    calibrate_from_image,
    distort_points,
    distort_points_brown,
    undistort_points,
    undistort_points_brown,
)
from photogrammetry_tpu_torch.ops.refine import (
    refine_subpixel,
    refine_subpixel_dense,
)

__all__ = ["bgr_to_gray_cv2", "rgb_to_gray_mean", "fast_score_map",
           "extract_keypoints", "gaussian_pairs", "brief_descriptors",
           "hamming_distance_matrix", "mutual_nearest_matches",
           "greedy_global_matches", "sorted_candidate_matches",
           "motion_consistency_mask", "anms_keypoints", "nms_keypoints",
           "generate_distortion_map", "apply_distortion_map",
           "make_distortion_applier", "solve_undistorted_radius",
           "grid_cluster_keypoints", "calibrate_distortion",
           "calibrate_from_image", "distort_points", "distort_points_brown",
           "undistort_points", "undistort_points_brown", "refine_subpixel",
           "refine_subpixel_dense"]
