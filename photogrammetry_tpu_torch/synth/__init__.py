"""Synthetic ground-truth scenes (the star camera pan)."""
from photogrammetry_tpu_torch.synth.star_scene import (
    star_points_3d, pan_trajectory, project_scene, render_frame,
    StarSceneConfig, generate_sequence,
)

__all__ = ["star_points_3d", "pan_trajectory", "project_scene",
           "render_frame", "StarSceneConfig", "generate_sequence"]
