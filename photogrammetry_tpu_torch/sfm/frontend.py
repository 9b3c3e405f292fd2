"""Feature-tracking frontend: images → matched pixel correspondences (port
of photogrammetry_tpu/sfm/frontend.py).

  detect_and_describe: grayscale image → (keypoints, descriptor bits, xy)
  detect_and_describe_pyramid: the same on power-of-two octaves, merged
  precompute_frontend: (F, H, W) sequence → the same with a leading F axis
                       (``octaves`` > 1: the batched pyramid)
  match_pair:          two described frames → (xy1, xy2, mask)
  precompute_matching: every (t, t-1) and (t, t-2) pair of a sequence,
                       matched a chunk of pairs a launch and gated

The three hot steps go through the hand-written kernels of ``kernels/``
(FAST score, BRIEF bits, Hamming distances); on CPU tensors those wrappers
run their plain PyTorch versions.  A batch of frames is described by one
BRIEF launch, steered (``oriented_brief``) or not, the mask folded in.
``plain=True`` calls the plain versions directly on any device: it is the
reference run that the kernels are held against on the card.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple

import numpy as np
import torch

from photogrammetry_tpu_torch.core.camera import keypoints_to_xy
from photogrammetry_tpu_torch.kernels import brief_pack, fast_stencil, hamming
from photogrammetry_tpu_torch.ops.brief import (
    angles_cos_sin, gaussian_pairs, keypoint_orientations,
)
from photogrammetry_tpu_torch.ops.cluster import grid_cluster_keypoints
from photogrammetry_tpu_torch.ops.fast import extract_keypoints
from photogrammetry_tpu_torch.ops.match import (
    mutual_nearest_matches, mutual_nearest_matches_batch,
)
from photogrammetry_tpu_torch.ops.nms import (
    anms_keypoints, compact_points, nms_keypoints, nms_keypoints_parallel,
    nms_keypoints_static,
)
from photogrammetry_tpu_torch.ops.refine import refine_subpixel_dense
from photogrammetry_tpu_torch.sfm.epipolar import (
    draw_samples, ransac_fundamental,
)
from photogrammetry_tpu_torch.utils.indexing import take_row
from photogrammetry_tpu_torch.utils.padding import PaddedPoints
from photogrammetry_tpu_torch.utils.profiling import span

NMS_IMPLS = {"static": nms_keypoints_static,
             "parallel": nms_keypoints_parallel,
             "sequential": nms_keypoints}
REDUCTIONS = ("nms", "anms", "cluster", "none")


@dataclass(frozen=True)
class FrontendConfig:
    """Detection/description/matching configuration.

    The JAX FrontendConfig's fields without its two ``use_pallas_*`` flags:
    here the tensors' device decides between kernel and plain version.
    ``reduction``: 'nms' (greedy radius NMS, ``nms_impl`` 'static',
    'parallel' or 'sequential', one result), 'anms' (adaptive NMS keeping
    max(max_keypoints // 4, 64)), 'cluster' (the chunked agglomerative
    clustering) or 'none'.
    """
    detection_threshold: float = 50.0
    max_keypoints: int = 1024
    reduction: str = "nms"            # 'nms' | 'anms' | 'cluster' | 'none'
    nms_impl: str = "static"          # 'static' | 'parallel' | 'sequential'
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
        if self.reduction not in REDUCTIONS:
            raise ValueError(f"unknown reduction {self.reduction!r}")
        if self.nms_impl not in NMS_IMPLS:
            raise ValueError(f"unknown nms_impl {self.nms_impl!r}")


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
    """The BRIEF pair table on ``device``: the JAX package's
    ``make_pairs(config)`` (``jax.random.PRNGKey(config.pair_seed)``),
    entry for entry."""
    return gaussian_pairs(config.pair_seed, sigma=config.brief_sigma,
                          num_pairs=config.num_pairs, device=device)


def _detect_from_score(score: torch.Tensor, h: int, w: int,
                       config: FrontendConfig) -> PaddedPoints:
    """fixed-capacity keypoint extraction → redundancy reduction."""
    pts = extract_keypoints(score, config.max_keypoints, order="score")
    if config.reduction == "nms":
        pts = compact_points(
            NMS_IMPLS[config.nms_impl](pts, config.suppression_radius),
            config.max_keypoints)
    elif config.reduction == "anms":
        keep = max(config.max_keypoints // 4, 64)
        pts = compact_points(anms_keypoints(pts, keep), config.max_keypoints)
    elif config.reduction == "cluster":
        pts = grid_cluster_keypoints(
            pts, h, w, max_merge_dist=config.max_merge_dist,
            chunks=tuple(config.cluster_chunks),
            chunk_capacity=max(config.max_keypoints // 4, 64))
        pts = compact_points(pts, config.max_keypoints)
    return pts


def detect_keypoints(gray: torch.Tensor, config: FrontendConfig,
                     plain: bool = False) -> PaddedPoints:
    """score map → fixed-capacity keypoints → redundancy reduction."""
    score_fn = (fast_stencil.fast_score_map_plain if plain
                else fast_stencil.fast_score_map)
    h, w = gray.shape
    return _detect_from_score(score_fn(gray, config.detection_threshold),
                              h, w, config)


def describe_bits(gray: torch.Tensor, pts: PaddedPoints, pairs: torch.Tensor,
                  config: FrontendConfig | None = None,
                  plain: bool = False) -> torch.Tensor:
    """Masked BRIEF bits for detected keypoints: (H, W) and (K, ...) points
    → (K, P), or a batch (B, H, W) and (B, K, ...) → (B, K, P), one kernel
    launch either way.  With ``config.oriented_brief`` the pairs are steered
    by each keypoint's intensity-centroid angle (JAX's ``_bits``)."""
    with span("frontend.describe"):
        bits_fn = (brief_pack.brief_bits_plain if plain
                   else brief_pack.brief_bits)
        cos_sin = None
        if config is not None and config.oriented_brief:
            cos_sin = angles_cos_sin(keypoint_orientations(gray, pts.coords))
        return bits_fn(gray, pts.coords, pairs, pts.mask, cos_sin)


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
    """Grayscale (H, W) float32 image → keypoints + BRIEF bits + xy.  The
    refine is detection's last step, timed under ``frontend.detect`` after
    BRIEF has run."""
    with span("frontend.detect"):
        pts = detect_keypoints(gray, config, plain)
    bits = describe_bits(gray, pts, pairs, config, plain)
    with span("frontend.detect"):
        xy = refine_xy(gray, pts, config)
    return DescribedFrame(points=pts, bits=bits, xy=xy)


# JAX's names: its split form is a dispatch workaround with the fused
# form's results, and the port's describe stage is eager either way
detect_and_describe_split = detect_and_describe


def detect_and_describe_batch_split(grays: torch.Tensor, pairs: torch.Tensor,
                                    config: FrontendConfig,
                                    plain: bool = False) -> DescribedFrame:
    """(B, H, W) float32 frames → DescribedFrame with a leading B axis on
    every leaf.  The B score maps come from one launch of the batched FAST
    kernel, NMS runs frame by frame, the B frames' bits come from one
    launch of the BRIEF kernel, and refine runs frame by frame (under
    ``frontend.detect``, as FAST and NMS)."""
    score_fn = (fast_stencil.fast_score_map_plain if plain
                else fast_stencil.fast_score_map_batch)
    with span("frontend.detect"):
        scores = score_fn(grays, config.detection_threshold)
        h, w = grays.shape[-2:]
        pts = PaddedPoints(*map(torch.stack, zip(*(
            _detect_from_score(score, h, w, config) for score in scores))))
    bits = describe_bits(grays, pts, pairs, config, plain)
    with span("frontend.detect"):
        xy = torch.stack([refine_xy(gray, PaddedPoints(*(x[i] for x in pts)),
                                    config) for i, gray in enumerate(grays)])
    return DescribedFrame(points=pts, bits=bits, xy=xy)


detect_and_describe_batch = detect_and_describe_batch_split


def _cat(batches) -> DescribedFrame:
    """Batched DescribedFrames concatenated leaf by leaf."""
    def leaves(f):
        return [*f.points, f.bits, f.xy]

    cols = [torch.cat(list(xs)) for xs in zip(*map(leaves, batches))]
    return DescribedFrame(points=PaddedPoints(*cols[:4]), bits=cols[4],
                          xy=cols[5])


def _downsample2(gray: torch.Tensor) -> torch.Tensor:
    """2x2 average-pool downsample of (..., H, W) (an odd last row or
    column is cropped), summed in the JAX package's order."""
    h2, w2 = gray.shape[-2] // 2, gray.shape[-1] // 2
    g = gray[..., :h2 * 2, :w2 * 2]
    return (g[..., 0::2, 0::2] + g[..., 0::2, 1::2] + g[..., 1::2, 0::2]
            + g[..., 1::2, 1::2]) * 0.25


def _to_octave0(f: DescribedFrame, o: int) -> DescribedFrame:
    """Octave ``o``'s keypoints in octave-0 pixels: the 2x2 average pool
    centres octave-o pixel p at 2^o p + (2^(o-1) - 0.5); integer coords
    rounded half to even (``jnp.rint``)."""
    off = (2.0 ** (o - 1) - 0.5) if o > 0 else 0.0
    scale = float(2 ** o)
    coords = torch.round(f.points.coords.to(torch.float32) * scale
                         + off).to(torch.int32)
    return DescribedFrame(points=f.points._replace(coords=coords),
                          bits=f.bits, xy=f.xy * scale + off)


def _merge_octaves(frames, dim: int) -> DescribedFrame:
    """Octaves' DescribedFrames concatenated along the keypoint axis
    ``dim``; the count recomputed from the merged mask."""
    def cat(get):
        return torch.cat([get(f) for f in frames], dim=dim)

    mask = cat(lambda f: f.points.mask)
    pts = PaddedPoints(coords=cat(lambda f: f.points.coords),
                       score=cat(lambda f: f.points.score), mask=mask,
                       count=mask.sum(dim).to(torch.int32))
    return DescribedFrame(points=pts, bits=cat(lambda f: f.bits),
                          xy=cat(lambda f: f.xy))


def detect_and_describe_pyramid(gray: torch.Tensor, pairs: torch.Tensor,
                                config: FrontendConfig, octaves: int = 3,
                                plain: bool = False) -> DescribedFrame:
    """Multi-scale frontend: detect + describe on ``octaves`` power-of-two
    scales of one (H, W) frame, merged into one DescribedFrame of
    octaves x max_keypoints slots with coordinates in octave-0 pixels.
    Features match across views whose apparent scale differs by up to
    ~2^(octaves-1)."""
    frames = []
    img = gray
    for o in range(octaves):
        frames.append(_to_octave0(detect_and_describe(img, pairs, config,
                                                      plain), o))
        if o + 1 < octaves:
            img = _downsample2(img)
    return _merge_octaves(frames, dim=0)


def detect_and_describe_batch_pyramid(grays: torch.Tensor,
                                      pairs: torch.Tensor,
                                      config: FrontendConfig, octaves: int,
                                      plain: bool = False) -> DescribedFrame:
    """The batch form of ``detect_and_describe_pyramid``: (B, H, W) frames,
    one batched pass (``detect_and_describe_batch_split``: one FAST and
    one BRIEF launch) per octave, merged along the keypoint axis."""
    frames = []
    img = grays
    for o in range(octaves):
        frames.append(_to_octave0(detect_and_describe_batch_split(
            img, pairs, config, plain), o))
        if o + 1 < octaves:
            img = _downsample2(img)
    return _merge_octaves(frames, dim=1)


def precompute_frontend(frames: torch.Tensor, pairs: torch.Tensor,
                        config: FrontendConfig, chunk: int = 16,
                        octaves: int = 1,
                        plain: bool = False) -> DescribedFrame:
    """Whole-sequence frontend: (F, H, W) frames → DescribedFrame with a
    leading F axis on every leaf, ``chunk`` frames per batched pass
    (``detect_and_describe_batch_split``; ``octaves`` > 1: the pyramid,
    octaves x max_keypoints slots a frame).  Unlike the JAX package, the
    tail chunk is not padded to the full size: nothing is compiled per
    shape here.  Index frame t with ``frame_features(feats, t)``."""
    f = frames.shape[0]
    chunk = max(1, min(chunk, f))

    def describe(blk):
        if octaves > 1:
            return detect_and_describe_batch_pyramid(blk, pairs, config,
                                                     octaves, plain)
        return detect_and_describe_batch_split(blk, pairs, config, plain)

    return _cat([describe(frames[s:s + chunk]) for s in range(0, f, chunk)])


def frame_features(feats: DescribedFrame, t) -> DescribedFrame:
    """Select frame ``t`` (an int, or a 0-dim index tensor on the
    features' device) from a precomputed (F-leading) DescribedFrame."""
    return DescribedFrame(
        points=PaddedPoints(*(take_row(x, t) for x in feats.points)),
        bits=take_row(feats.bits, t), xy=take_row(feats.xy, t))


def match_pair(f1: DescribedFrame, f2: DescribedFrame,
               config: FrontendConfig, plain: bool = False) -> MatchedPair:
    """Mutual-nearest Hamming matching between two described frames;
    masked keypoints get INT_INF distances on both axes."""
    with span("frontend.match"):
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


class PrecompMatches(NamedTuple):
    """Sequence-level matching + epipolar gates, leading frame axis t.

    Row t holds the (t, t-1) consecutive match (valid for t >= 1) and the
    (t, t-2) skip match (valid for t >= 2); rows outside those ranges are
    masked all-False with count 0 (their idx row is the first pair's, as
    in the JAX package).  idx arrays index the OLDER frame's keypoints.
    """
    idx1: torch.Tensor    # (F, K) int32 match into frame t-1 (-1 none)
    good1: torch.Tensor   # (F, K) bool  mask & epipolar inliers
    num1: torch.Tensor    # (F,) int32 raw mutual matches
    idx2: torch.Tensor    # (F, K) int32 match into frame t-2
    good2: torch.Tensor   # (F, K) bool
    num2: torch.Tensor    # (F,) int32


def sequence_pairs(num_frames: int):
    """The (t, dt) pairs ``precompute_matching`` matches, in its order:
    (t, 1) for t in 1..F-1, then (t, 2) for t in 2..F-1."""
    return ([(t, 1) for t in range(1, num_frames)]
            + [(t, 2) for t in range(2, num_frames)])


def _pair_generator(base_seed: int, salt: int, device) -> torch.Generator:
    """The generator of one pair's gate draws, seeded by (base seed, salt
    2t + dt - 1) through numpy's SeedSequence: each pair's draws depend on
    neither the order nor the chunking of the pairs."""
    g = torch.Generator(device=device)
    g.manual_seed(int(np.random.SeedSequence([base_seed, salt])
                      .generate_state(1, np.uint64)[0] >> np.uint64(1)))
    return g


def precompute_matching(feats: DescribedFrame, config: FrontendConfig,
                        generator: torch.Generator | None, num_frames: int,
                        ransac_threshold: float, ransac_samples: int,
                        chunk: int = 16, plain: bool = False,
                        sample_idx: torch.Tensor | None = None
                        ) -> PrecompMatches:
    """Whole-sequence consecutive + skip matching: the (Q, K, K) distances
    of ``chunk`` pairs at a time from one launch of the batched Hamming
    kernel (``plain=True``: its plain version), mutual-nearest matching
    over the block (``match_pair``'s threshold, ties and ratio test), then
    each pair's RANSAC-F gate over ``ransac_samples`` hypotheses.

    Draws: one base seed from ``generator`` (one host read), then each
    pair's (H, 8) samples from ``_pair_generator(base, 2t + dt - 1)``, so
    chunking cannot change results.  ``sample_idx`` (n_pairs, H, 8), in
    ``sequence_pairs`` order, replaces the draws (``generator`` unused).
    """
    if num_frames < 2:
        raise ValueError("precompute_matching: needs at least 2 frames")
    pairs = sequence_pairs(num_frames)
    n = len(pairs)
    bits, masks, xy = feats.bits, feats.points.mask, feats.xy
    dev = bits.device
    if sample_idx is None:
        base = int(torch.randint(0, 2 ** 62, (1,), generator=generator,
                                 device=dev))
    dist_fn = (hamming.hamming_distance_matrix_pairs_plain if plain
               else hamming.hamming_distance_matrix_pairs)
    ratio = config.ratio_test if config.ratio_test > 0 else None
    ii_all = torch.tensor([t for t, _ in pairs], dtype=torch.int32,
                          device=dev)
    jj_all = torch.tensor([t - dt for t, dt in pairs], dtype=torch.int32,
                          device=dev)
    idx_out, good_out, num_out = [], [], []
    chunk = max(1, chunk)
    for s in range(0, n, chunk):
        ii, jj = ii_all[s:s + chunk], jj_all[s:s + chunk]
        d = dist_fn(bits, masks, ii, jj)                      # (Q, K, K)
        idx2, _, valid = mutual_nearest_matches_batch(
            d, config.hamming_threshold, max_ratio=ratio)
        xy1 = xy[ii.long()]
        xy2 = torch.gather(xy[jj.long()], 1, torch.clamp(
            idx2, min=0).long()[:, :, None].expand(-1, -1, 2))
        for q in range(ii.shape[0]):
            t, dt = pairs[s + q]
            if sample_idx is None:
                idx = draw_samples(_pair_generator(base, 2 * t + dt - 1, dev),
                                   valid[q], ransac_samples, 8)
            else:
                idx = sample_idx[s + q].to(dev)
            gate = ransac_fundamental(idx, xy1[q], xy2[q], valid[q],
                                      ransac_threshold)
            good_out.append(valid[q] & gate.inliers)
        idx_out.append(idx2)
        num_out.append(valid.sum(dim=1, dtype=torch.int32))
    all_idx = torch.cat(idx_out)
    all_good = torch.stack(good_out)
    all_num = torch.cat(num_out)
    index = {p: i for i, p in enumerate(pairs)}

    def rows(dt):
        sel = torch.tensor([index.get((t, dt), 0)
                            for t in range(num_frames)], device=dev)
        has = torch.tensor([(t, dt) in index for t in range(num_frames)],
                           device=dev)
        return (all_idx[sel], all_good[sel] & has[:, None],
                torch.where(has, all_num[sel], 0).to(torch.int32))

    i1, g1, n1 = rows(1)
    i2, g2, n2 = rows(2)
    return PrecompMatches(idx1=i1, good1=g1, num1=n1,
                          idx2=i2, good2=g2, num2=n2)
