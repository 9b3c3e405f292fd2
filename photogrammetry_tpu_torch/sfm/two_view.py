"""Two-view relative pose + structure (port of
photogrammetry_tpu/sfm/two_view.py): RANSAC fundamental estimation,
essential decomposition, optional homography race, DLT triangulation and
cheirality voting over fixed-capacity correspondence tensors.

``two_view_pipeline`` draws the RANSAC samples from a ``torch.Generator``;
``two_view_from_samples`` is the rest, a function of those samples.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from photogrammetry_tpu_torch.sfm.epipolar import (
    decompose_essential, draw_samples, essential_from_fundamental,
    ransac_fundamental,
)
from photogrammetry_tpu_torch.sfm.homography import (
    decompose_homography, ransac_homography,
)
from photogrammetry_tpu_torch.sfm.triangulate import select_pose

H_SAMPLE_SIZE = 4


class TwoViewResult(NamedTuple):
    f: torch.Tensor            # (3, 3) fundamental matrix
    e: torch.Tensor            # (3, 3) essential matrix
    r: torch.Tensor            # (3, 3) rotation of camera 2
    t: torch.Tensor            # (3,) unit translation of camera 2
    points: torch.Tensor       # (N, 3) triangulated points (cam-1 frame)
    inliers: torch.Tensor      # (N,) bool inliers of the chosen model
    num_inliers: torch.Tensor  # () int32
    cheirality: torch.Tensor   # (4,) int32 positive-depth votes per candidate
    used_homography: torch.Tensor  # () bool: pose came from the H model


def two_view_from_samples(f_samples: torch.Tensor,
                          h_samples: torch.Tensor | None,
                          xy1: torch.Tensor, xy2: torch.Tensor,
                          mask: torch.Tensor, k: torch.Tensor,
                          threshold: float = 1.0,
                          residual: str = "sampson") -> TwoViewResult:
    """The two-view pipeline for given RANSAC samples: ``f_samples`` (H, 8)
    for F and, for the 'auto' model, ``h_samples`` (H', 4) for the
    homography race (None runs the F-only 'fundamental' model).  When H
    explains more than 45% of the combined consensus, the pose comes from
    the H decomposition."""
    res = ransac_fundamental(f_samples, xy1, xy2, mask, threshold,
                             residual=residual)
    e = essential_from_fundamental(res.f, k, k)
    rs, ts = decompose_essential(e)
    use_h = torch.zeros((), dtype=torch.bool, device=xy1.device)
    inliers = res.inliers
    if h_samples is not None:
        hres = ransac_homography(h_samples, xy1, xy2, mask, threshold)
        rs_h, ts_h, _ = decompose_homography(hres.h, k, k)
        sh = hres.num_inliers.to(torch.float32)
        sf = res.num_inliers.to(torch.float32)
        use_h = sh > 0.45 * (sh + sf)
        rs = torch.where(use_h, rs_h, rs)
        ts = torch.where(use_h, ts_h, ts)
        inliers = torch.where(use_h, hres.inliers, inliers)
    r, t, pts, counts, _ = select_pose(xy1, xy2, rs, ts, k, k, inliers)
    return TwoViewResult(f=res.f, e=e, r=r, t=t, points=pts,
                         inliers=inliers,
                         num_inliers=inliers.sum().to(torch.int32),
                         cheirality=counts.to(torch.int32),
                         used_homography=use_h)


def two_view_pipeline(generator: torch.Generator, xy1: torch.Tensor,
                      xy2: torch.Tensor, mask: torch.Tensor, k: torch.Tensor,
                      threshold: float = 1.0, num_samples: int = 2000,
                      sample_size: int = 8, residual: str = "sampson",
                      model: str = "auto",
                      h_samples: int = 500) -> TwoViewResult:
    """Matched pixel coords (x, y) → relative pose + 3-D structure.

    model='auto' races a homography against F (the ORB-SLAM arbitration);
    model='fundamental' is the F-only path.  The F samples are drawn first,
    then the H samples, from ``generator`` (on the tensors' device).
    """
    if model not in ("auto", "fundamental"):
        raise ValueError(f"unknown model {model!r}")
    f_idx = draw_samples(generator, mask, num_samples, sample_size)
    h_idx = (draw_samples(generator, mask, h_samples, H_SAMPLE_SIZE)
             if model == "auto" else None)
    return two_view_from_samples(f_idx, h_idx, xy1, xy2, mask, k,
                                 threshold=threshold, residual=residual)
