"""Image I/O, PLY export and overlay drawing."""
from photogrammetry_tpu_torch.io.ply import write_ply
from photogrammetry_tpu_torch.io.image import read_image, write_image
from photogrammetry_tpu_torch.io.draw import (
    draw_squares, draw_lines, join_right,
)

__all__ = ["write_ply", "read_image", "write_image", "draw_squares",
           "draw_lines", "join_right"]
