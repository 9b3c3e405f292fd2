"""Port parity: the frontend variants — raster-order extraction, the three
NMS forms and ANMS, grid and exact clustering, the sorted, greedy and
motion-consistency matchers, and ``FrontendConfig``'s every reduction on
the star scene.

The same numpy inputs go through the JAX package and through
photogrammetry_tpu_torch on the CPU.  Tolerances: integers and masks
exactly; cluster centres exactly after rounding; the refined subpixel xy
of the whole frontend within 1e-4 px plus 1e-5 of the coordinate (two
f32 reduction orders in the refine's fit; measured 2.3e-4 px at 198 px,
1.7e-6 relative).  The hard cases of tests/test_dewarp_cluster_nms.py
and tests/test_brief_match.py come along, and an ANMS case whose keys tie
exactly (radii of ~1.7e7 px², where the rank term vanishes in f32).
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_threads import _one_thread  # noqa: F401
from photogrammetry_tpu.ops import cluster as jcluster
from photogrammetry_tpu.ops import match as jmatch
from photogrammetry_tpu.ops import nms as jnms
from photogrammetry_tpu.ops.fast import extract_keypoints as jax_extract
from photogrammetry_tpu.ops.fast import fast_score_map as jax_fast
from photogrammetry_tpu.sfm import frontend as jfront
from photogrammetry_tpu.synth.star_scene import (
    StarSceneConfig, generate_sequence,
)
from photogrammetry_tpu.utils.padding import pad_to
from photogrammetry_tpu_torch.convert import from_jax
from photogrammetry_tpu_torch.ops import cluster, match, nms
from photogrammetry_tpu_torch.ops.fast import extract_keypoints
from photogrammetry_tpu_torch.sfm import frontend
from photogrammetry_tpu_torch.utils.padding import PaddedPoints


def to_port(pts) -> PaddedPoints:
    return PaddedPoints(*(torch.from_numpy(np.array(x)) for x in pts))


def assert_points_equal(got, ref):
    for name in PaddedPoints._fields:
        np.testing.assert_array_equal(getattr(got, name).numpy(),
                                      np.asarray(getattr(ref, name)), name)


def _noise_scores(seed, shape, thr=30.0):
    rng = np.random.default_rng(seed)
    img = rng.integers(0, 255, shape).astype(np.float32)
    img[::7, :] = 255.0
    return np.asarray(jax_fast(img, thr))


def _random_points(seed, n, capacity, span=300, scores=(12, 17)):
    rng = np.random.default_rng(seed)
    coords = rng.integers(0, span, (n, 2)).astype(np.int32)
    score = rng.integers(*scores, n).astype(np.float32)
    return pad_to(coords, score, capacity)


# ------------------------------------------------------------ extraction
@pytest.mark.parametrize("capacity", [16, 256, 4096])
def test_extract_keypoints_raster_exact(capacity):
    """Raster order (the JAX default): fewer slots than detections, about
    as many, and more (fill entries index 0)."""
    score = _noise_scores(5, (96, 128))
    ref = jax_extract(score, capacity=capacity)
    got = extract_keypoints(torch.tensor(score), capacity)
    assert_points_equal(got, ref)
    assert int((score > 0).sum()) > 16


def test_extract_keypoints_raster_empty_and_unknown_order():
    score = np.zeros((20, 30), np.int32)
    assert_points_equal(extract_keypoints(torch.tensor(score), 8),
                        jax_extract(score, capacity=8))
    with pytest.raises(ValueError, match="order"):
        extract_keypoints(torch.tensor(score), 8, order="column")


# ------------------------------------------------------------------ NMS
def _nms_cases():
    """(name, JAX PaddedPoints, radius): tests/test_dewarp_cluster_nms.py's
    hand cases and random fields with many equal scores."""
    cases = [
        ("within_radius", pad_to([[10, 10], [10, 14], [40, 40]],
                                 [16.0, 12.0, 14.0], 8), 5.0),
        ("at_radius", pad_to([[0, 0], [0, 5]], [10.0, 9.0], 4), 5.0),
        ("past_radius", pad_to([[0, 0], [0, 5]], [10.0, 9.0], 4), 4.999),
        ("recursive_chain", pad_to([[0, 0], [0, 4], [0, 8]],
                                   [10.0, 9.0, 8.0], 4), 5.0),
        ("monotone_chain", pad_to([[0, i * 4] for i in range(10)],
                                  np.arange(10, 0, -1), 16), 5.0),
        ("equal_scores", pad_to([[0, i * 3] for i in range(12)],
                                np.full(12, 14.0), 16), 4.0),
    ]
    for trial in range(3):
        cases.append((f"random{trial}",
                      _random_points(70 + trial, 200, 256), 12.0))
    return cases


NMS_CASES = _nms_cases()


@pytest.mark.parametrize("impl", ["sequential", "parallel", "static"])
@pytest.mark.parametrize("case", NMS_CASES, ids=[c[0] for c in NMS_CASES])
def test_nms_variants_exact(impl, case):
    """Each of the port's three forms equals JAX's sequential NMS (and so
    JAX's parallel and static forms, which its own tests hold to it)."""
    _, pts, radius = case
    ref = jnms.nms_keypoints(pts, radius)
    got = frontend.NMS_IMPLS[impl](to_port(pts), radius)
    assert_points_equal(got, ref)
    assert_points_equal(got, {"sequential": jnms.nms_keypoints,
                              "parallel": jnms.nms_keypoints_parallel,
                              "static": jnms.nms_keypoints_static}[impl](
                                  pts, radius))


def test_nms_masked_slots_are_never_kept():
    pts = _random_points(3, 60, 64)
    mask = np.asarray(pts.mask).copy()
    mask[::3] = False
    pts = pts._replace(mask=jnp.asarray(mask),
                       count=jnp.int32(mask.sum()))
    ref = jnms.nms_keypoints(pts, 20.0)
    for impl in frontend.NMS_IMPLS.values():
        assert_points_equal(impl(to_port(pts), 20.0), ref)


# ----------------------------------------------------------------- ANMS
def _anms_cases():
    rng = np.random.default_rng(0)
    k = 64
    dense = np.vstack([rng.integers(0, 10, (k - 1, 2)), [[100, 100]]])
    dense_score = np.concatenate([rng.integers(12, 17, k - 1), [12]])
    masked = pad_to([[0, 0], [5, 5], [50, 50], [90, 90]],
                    [16.0, 15.0, 14.0, 13.0], 8)
    masked = masked._replace(mask=jnp.asarray([True, True, False, True]
                                              + [False] * 4),
                             count=jnp.int32(3))
    # equal scores on a line of 4100-px steps: every radius2 is 4100^2
    # (~1.68e7), where rank / (K + 1) < 1 vanishes in f32, so the keys tie
    ties = pad_to([[0, 4100 * i] for i in range(40)], np.full(40, 13.0), 48)
    return [
        ("even_distribution", pad_to(dense, dense_score, k), 4),
        ("respects_mask", masked, 8),
        ("random", _random_points(11, 300, 320, span=600), 64),
        ("tied_keys", ties, 10),
        ("keep_all", _random_points(12, 30, 32), 40),
    ]


ANMS_CASES = _anms_cases()


@pytest.mark.parametrize("case", ANMS_CASES, ids=[c[0] for c in ANMS_CASES])
def test_anms_exact(case):
    name, pts, keep = case
    ref = jnms.anms_keypoints(pts, keep)
    got = nms.anms_keypoints(to_port(pts), keep)
    assert_points_equal(got, ref)
    if name == "tied_keys":
        r2 = np.float32(4100.0 ** 2)
        assert r2 - np.float32(39 / 49) == r2   # the ties are real


# ----------------------------------------------------------- clustering
def _cluster_cases():
    rng = np.random.default_rng(10)
    one_chunk = rng.integers(0, 16, (12, 2))
    return [
        # tests/test_dewarp_cluster_nms.py's grid cases
        ("one_chunk", pad_to(one_chunk, np.ones(12), 32), (64, 64), 4.0,
         (4, 4), 16),
        ("distant", pad_to([[2, 2], [30, 30], [60, 60]], np.ones(3), 8),
         (64, 64), 5.0, (4, 4), 8),
        # merged centres on .5 (rounded half to even) and a weighted one
        ("half_centres", pad_to([[0, 0], [0, 3], [1, 0], [0, 8], [20, 21],
                                 [20, 22]], np.ones(6), 8), (64, 64), 6.0,
         (2, 2), 8),
        # more points in a chunk than its capacity: the rest are dropped
        ("over_capacity", pad_to(rng.integers(0, 30, (40, 2)),
                                 np.ones(40), 48), (64, 64), 6.0, (2, 2),
         16),
        ("random_240x320", pad_to(np.stack([rng.integers(0, 240, 900),
                                            rng.integers(0, 320, 900)], -1),
                                  np.ones(900), 1024), (240, 320), 25.0,
         (4, 4), 128),
        ("chunks_3x5", pad_to(np.stack([rng.integers(0, 100, 300),
                                        rng.integers(0, 170, 300)], -1),
                              np.ones(300), 320), (100, 170), 12.0, (3, 5),
         48),
    ]


CLUSTER_CASES = _cluster_cases()


@pytest.mark.parametrize("case", CLUSTER_CASES,
                         ids=[c[0] for c in CLUSTER_CASES])
def test_grid_cluster_keypoints_exact(case):
    _, pts, (h, w), dist, chunks, cap = case
    ref = jcluster.grid_cluster_keypoints(pts, h, w, max_merge_dist=dist,
                                          chunks=chunks, chunk_capacity=cap)
    got = cluster.grid_cluster_keypoints(to_port(pts), h, w,
                                         max_merge_dist=dist, chunks=chunks,
                                         chunk_capacity=cap)
    assert_points_equal(got, ref)


@pytest.mark.parametrize("check_every", [1, 5, 1000])
def test_cluster_chunks_early_stop_changes_nothing(check_every):
    """Ending the merge loop once a step merges nothing gives the state of
    the full C - 1 steps, whatever the interval of the check."""
    rng = np.random.default_rng(4)
    centers = torch.from_numpy(rng.integers(0, 40, (3, 24, 2))
                               .astype(np.float32))
    weights = torch.from_numpy((rng.random((3, 24)) < 0.8)
                               .astype(np.float32))
    full = cluster.cluster_chunks(centers, weights, 6.0, check_every=10 ** 6)
    got = cluster.cluster_chunks(centers, weights, 6.0,
                                 check_every=check_every)
    for a, b in zip(got, full):
        assert torch.equal(a, b)
    import jax
    jc, jw = jax.vmap(jcluster._cluster_chunk, in_axes=(0, 0, None))(
        centers.numpy(), weights.numpy(), np.float32(6.0))
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(jc))
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(jw))


@pytest.mark.parametrize("n,span,dist", [(0, 10, 25.0), (1, 10, 25.0),
                                         (3, 10, 6.0), (120, 60, 8.0),
                                         (600, 300, 25.0)])
def test_hierarchical_cluster_exact_equals_jax(n, span, dist):
    coords = np.random.default_rng(n).integers(0, span, (n, 2))
    got, z = cluster.hierarchical_cluster_exact(coords, dist,
                                                return_linkage=True)
    ref, jz = jcluster.hierarchical_cluster_exact(coords, dist,
                                                  return_linkage=True)
    np.testing.assert_array_equal(got, ref)
    np.testing.assert_array_equal(z, jz)


def test_hierarchical_cluster_exact_hand_cases():
    """tests/test_dewarp_cluster_nms.py's weighted-centroid case."""
    got = cluster.hierarchical_cluster_exact(
        np.array([[0, 0], [0, 4], [0, 8]], np.int32), max_merge_dist=6)
    assert got.tolist() == [[0, 4]]


# -------------------------------------------------------------- matchers
def _dist_matrix(seed, n1, n2, masked=True):
    rng = np.random.default_rng(seed)
    d = rng.integers(0, 12, (n1, n2)).astype(np.int32)   # many ties
    if masked:
        d[n1 - 2:] = jmatch.INT_INF
        d[:, n2 - 1] = jmatch.INT_INF
    return d


@pytest.mark.parametrize("shape", [(1, 1), (9, 13), (40, 33)])
def test_sorted_candidate_matches_exact(shape):
    d = _dist_matrix(1, *shape, masked=min(shape) > 2)
    got = match.sorted_candidate_matches(torch.from_numpy(d))
    ref = jmatch.sorted_candidate_matches(d)
    for a, b in zip(got, ref):
        assert a.dtype == torch.int32
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def test_sorted_candidates_hand_case():
    order, dist = match.sorted_candidate_matches(
        torch.tensor([[3, 1, 2]], dtype=torch.int32))
    assert order[0].tolist() == [1, 2, 0] and dist[0].tolist() == [1, 2, 3]


@pytest.mark.parametrize("shape,num", [((3, 3), 3), ((9, 13), 9),
                                       ((40, 33), 40), ((5, 4), 0)])
def test_greedy_global_matches_exact(shape, num):
    """Ties take the first flat index; steps past the last finite entry
    give (0, 0, INT_INF, False) rows, as JAX's scan does."""
    d = (np.array([[5, 1, 9], [2, 0, 7], [8, 6, 3]], np.int32)
         if shape == (3, 3) else _dist_matrix(2, *shape))
    got = match.greedy_global_matches(torch.from_numpy(d), num)
    ref = jmatch.greedy_global_matches(d, num)
    for a, b in zip(got, ref):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    if shape == (3, 3):
        assert [tuple(x) for x in zip(*(t.tolist() for t in got[:3]))] == \
            [(1, 1, 0), (2, 2, 3), (0, 0, 5)]
    if shape == (40, 33):
        assert not bool(got[3][-1]) and int(got[2][-1]) == match.INT_INF


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_motion_consistency_mask_exact(seed):
    """Random displacement fields: a smooth one for most matches, random
    outliers, masked entries, and radii on the integer grid (squared
    distances exactly at the strict bound)."""
    rng = np.random.default_rng(seed)
    n = 200
    xy1 = rng.integers(0, 1200, (n, 2)).astype(np.float32)
    flow = np.array([40.0, -12.0], np.float32)
    xy2 = xy1 + flow + rng.integers(-3, 4, (n, 2)).astype(np.float32)
    out = rng.random(n) < 0.3
    xy2[out] = rng.integers(0, 1200, (out.sum(), 2))
    mask = rng.random(n) < 0.9
    for kw in ({}, dict(neighbor_radius=300.0, agreement_radius=5.0,
                        min_support=3)):
        ref = np.asarray(jmatch.motion_consistency_mask(xy1, xy2, mask,
                                                        **kw))
        got = match.motion_consistency_mask(torch.from_numpy(xy1),
                                            torch.from_numpy(xy2),
                                            torch.from_numpy(mask), **kw)
        np.testing.assert_array_equal(got.numpy(), ref)
        assert 0 < ref.sum() < mask.sum()


# -------------------------------------------------- frontend on the scene
@pytest.fixture(scope="module")
def scene():
    """Frames 0 and 2 of the 240x320 star pan."""
    seq = generate_sequence(StarSceneConfig(
        num_frames=4, image_size=(240, 320), focal=260.0))
    return [seq["frames"][i].astype(np.float32) for i in (0, 2)]


FRONTENDS = [dict(reduction="nms", nms_impl="sequential"),
             dict(reduction="nms", nms_impl="parallel"),
             dict(reduction="anms"),
             dict(reduction="cluster"),
             dict(reduction="cluster", max_keypoints=512,
                  cluster_chunks=(2, 3)),
             dict(reduction="none")]


@pytest.mark.parametrize("kw", FRONTENDS,
                         ids=["-".join(map(str, kw.values()))
                              for kw in FRONTENDS])
def test_frontend_reductions_on_the_scene(scene, kw):
    """``detect_and_describe`` and ``match_pair`` under each reduction:
    keypoints, bits and matches exact, xy as above; the batched
    frontend gives the same keypoints frame by frame."""
    jcfg = jfront.FrontendConfig(max_keypoints=kw.pop("max_keypoints", 256),
                                 suppression_radius=4.0, **kw)
    pairs = np.asarray(jfront.make_pairs(jcfg))
    tpairs, _, cfg = from_jax(pairs, np.eye(3), dataclasses.asdict(jcfg),
                              device="cpu")
    refs = [jfront.detect_and_describe_split(im, pairs, jcfg)
            for im in scene]
    gots = [frontend.detect_and_describe(torch.from_numpy(im), tpairs, cfg)
            for im in scene]
    for got, ref in zip(gots, refs):
        assert_points_equal(got.points, ref.points)
        np.testing.assert_array_equal(got.bits.numpy(), np.asarray(ref.bits))
        np.testing.assert_allclose(got.xy.numpy(), np.asarray(ref.xy),
                                   rtol=1e-5, atol=1e-4)
    assert int(gots[0].points.count) > 20
    ref_m = jfront.match_pair(*refs, jcfg)
    got_m = frontend.match_pair(*gots, cfg)
    for name in ("idx2", "dist", "mask", "num"):
        np.testing.assert_array_equal(getattr(got_m, name).numpy(),
                                      np.asarray(getattr(ref_m, name)), name)
    batch = frontend.detect_and_describe_batch_split(
        torch.from_numpy(np.stack(scene)), tpairs, cfg)
    for i, got in enumerate(gots):
        for a, b in zip(batch.points, got.points):
            assert torch.equal(a[i], b)


def test_frontend_config_takes_every_jax_option():
    for red in frontend.REDUCTIONS:
        for impl in frontend.NMS_IMPLS:
            jcfg = jfront.FrontendConfig(reduction=red, nms_impl=impl)
            _, _, cfg = from_jax(np.zeros((4, 2, 2), np.int32), np.eye(3),
                                 dataclasses.asdict(jcfg), device="cpu")
            assert (cfg.reduction, cfg.nms_impl) == (red, impl)
    with pytest.raises(ValueError, match="reduction"):
        frontend.FrontendConfig(reduction="voronoi")
    with pytest.raises(ValueError, match="nms_impl"):
        frontend.FrontendConfig(nms_impl="fused")
