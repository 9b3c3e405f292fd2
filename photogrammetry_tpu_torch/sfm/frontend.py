"""Feature-tracking frontend: images → matched pixel correspondences (port
of photogrammetry_tpu/sfm/frontend.py).

  detect_and_describe: grayscale image → (keypoints, descriptor bits, xy)
  match_pair:          two described frames → (xy1, xy2, mask)

The three hot steps go through the hand-written kernels of ``kernels/``
(FAST score, BRIEF bits, Hamming distances); on CPU tensors those wrappers
run their plain PyTorch versions.  ``plain=True`` calls the plain versions
directly on any device: it is the reference run that the kernels are held
against on the card.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple

import torch

from photogrammetry_tpu_torch import resolve_device
from photogrammetry_tpu_torch.core.camera import keypoints_to_xy
from photogrammetry_tpu_torch.kernels import brief_pack, fast_stencil, hamming
from photogrammetry_tpu_torch.ops.brief import gaussian_pairs
from photogrammetry_tpu_torch.ops.fast import extract_keypoints
from photogrammetry_tpu_torch.ops.match import mutual_nearest_matches
from photogrammetry_tpu_torch.ops.nms import compact_points, nms_keypoints_static
from photogrammetry_tpu_torch.ops.refine import refine_subpixel_dense
from photogrammetry_tpu_torch.utils.padding import PaddedPoints


@dataclass(frozen=True)
class FrontendConfig:
    """Detection/description/matching configuration.

    The JAX FrontendConfig's fields without its two ``use_pallas_*`` flags:
    here the tensors' device decides between kernel and plain version.
    The port runs ``reduction`` 'nms' (with ``nms_impl`` 'static') and
    'none', and unoriented BRIEF; the other options are JAX-only for now.
    """
    detection_threshold: float = 50.0
    max_keypoints: int = 1024
    reduction: str = "nms"            # 'nms' | 'none' in the port
    nms_impl: str = "static"
    suppression_radius: float = 50.0
    max_merge_dist: float = 25.0
    cluster_chunks: tuple = (4, 4)
    brief_sigma: float = 50.0
    num_pairs: int = 256
    hamming_threshold: int = 75
    ratio_test: float = 0.0           # Lowe ratio (0 disables)
    pair_seed: int = 0
    subpixel: bool = True             # refine corners before geometry
    oriented_brief: bool = False

    def __post_init__(self):
        if self.reduction not in ("nms", "none"):
            raise NotImplementedError(
                f"reduction={self.reduction!r} is not ported yet")
        if self.reduction == "nms" and self.nms_impl != "static":
            raise NotImplementedError(
                f"nms_impl={self.nms_impl!r} is not ported yet")
        if self.oriented_brief:
            raise NotImplementedError("oriented_brief is not ported yet")


class DescribedFrame(NamedTuple):
    points: PaddedPoints
    bits: torch.Tensor  # (K, P) uint8
    xy: torch.Tensor    # (K, 2) float32 subpixel (x, y) pixel coords


class MatchedPair(NamedTuple):
    xy1: torch.Tensor    # (K, 2) float32 (x, y) pixel coords in frame 1
    xy2: torch.Tensor    # (K, 2)
    idx2: torch.Tensor   # (K,) int32 matched keypoint index in frame 2 (-1 none)
    dist: torch.Tensor   # (K,) int32 Hamming distances
    mask: torch.Tensor   # (K,) bool valid matches
    num: torch.Tensor    # () int32


def make_pairs(config: FrontendConfig, device="cuda") -> torch.Tensor:
    """BRIEF pair table drawn from a torch generator seeded with
    ``config.pair_seed`` (not the JAX package's pairs: see convert.from_jax).
    """
    gen = torch.Generator(device=resolve_device(device))
    gen.manual_seed(config.pair_seed)
    return gaussian_pairs(gen, sigma=config.brief_sigma,
                          num_pairs=config.num_pairs)


def detect_keypoints(gray: torch.Tensor, config: FrontendConfig,
                     plain: bool = False) -> PaddedPoints:
    """score map → fixed-capacity keypoints → redundancy reduction."""
    score_fn = (fast_stencil.fast_score_map_plain if plain
                else fast_stencil.fast_score_map)
    score = score_fn(gray, config.detection_threshold)
    pts = extract_keypoints(score, config.max_keypoints)
    if config.reduction == "nms":
        pts = compact_points(
            nms_keypoints_static(pts, config.suppression_radius),
            config.max_keypoints)
    return pts


def describe_bits(gray: torch.Tensor, pts: PaddedPoints, pairs: torch.Tensor,
                  plain: bool = False) -> torch.Tensor:
    """Masked BRIEF bits for detected keypoints."""
    bits_fn = brief_pack.brief_bits_plain if plain else brief_pack.brief_bits
    bits = bits_fn(gray, pts.coords, pairs)
    return bits * pts.mask[:, None].to(bits.dtype)


def refine_xy(gray: torch.Tensor, pts: PaddedPoints,
              config: FrontendConfig) -> torch.Tensor:
    """(K, 2) float32 (x, y) keypoint coordinates, subpixel-refined."""
    if config.subpixel:
        rc = refine_subpixel_dense(gray, pts.coords)
        return torch.stack([rc[:, 1], rc[:, 0]], dim=-1)
    return keypoints_to_xy(pts.coords)


def detect_and_describe(gray: torch.Tensor, pairs: torch.Tensor,
                        config: FrontendConfig,
                        plain: bool = False) -> DescribedFrame:
    """Grayscale (H, W) float32 image → keypoints + BRIEF bits + xy."""
    pts = detect_keypoints(gray, config, plain)
    return DescribedFrame(points=pts,
                          bits=describe_bits(gray, pts, pairs, plain),
                          xy=refine_xy(gray, pts, config))


def match_pair(f1: DescribedFrame, f2: DescribedFrame,
               config: FrontendConfig, plain: bool = False) -> MatchedPair:
    """Mutual-nearest Hamming matching between two described frames;
    masked keypoints get INT_INF distances on both axes."""
    dist_fn = (hamming.hamming_distance_matrix_plain if plain
               else hamming.hamming_distance_matrix)
    d = dist_fn(f1.bits, f2.bits, f1.points.mask, f2.points.mask)
    ratio = config.ratio_test if config.ratio_test > 0 else None
    idx2, dist, valid = mutual_nearest_matches(d, config.hamming_threshold,
                                               max_ratio=ratio)
    xy1 = f1.xy
    xy2 = f2.xy[torch.clamp(idx2, min=0).to(torch.int64)]
    return MatchedPair(xy1=xy1, xy2=xy2, idx2=idx2, dist=dist, mask=valid,
                       num=valid.sum().to(torch.int32))
