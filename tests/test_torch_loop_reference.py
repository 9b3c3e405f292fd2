"""The port's loop-closure stage against its plain float64 reference
(the benchmark's ``benchmarks/reference/loop.py``, loaded by its path):
the pair grid's counts, candidate selection, the trimmed bearing
Procrustes, the SE(3) pose graph's LM, ``close_loops_stage`` end to end on
a small out-and-back walk whose return leg is offset from the way out, and
the stage's spans and counters.

Tolerances, each for its reason:
- counts, candidates, supports and accepted edges are integers or sets of
  them and must be equal;
- rotations within 2e-4 degrees (3.5e-6 rad): the port forms bearings and
  their 3x3 sum in float32 (1.2e-7 relative), which the fit's conditioning
  (largest over smallest singular value of the sum, ~100 here) amplifies;
- the pose graph's final cost within 1e-5 of its initial cost and the poses
  within 1e-5: float32 residuals (se3_log of products of float32 rotations,
  ~1e-7 each, read 1e-7 of the initial cost and 4e-7 in the poses) against
  a float64 minimum; a step short of it would show in the Gauss-Newton
  decrement, held to 1e-8 of the initial cost (it reads ~1e-11; at the
  poses the solve was given it reads ~1);
- re-triangulated landmarks by the median reprojection gap, within 0.01 px
  (it reads ~5e-4; under the poses before the stage ~1 px), over the tracks
  whose 4x4 Gram matrix float32 can solve (condition below 1e5; see
  benchmarks/drivers/sfm_loop.py): a track of little parallax is
  ill-conditioned, and float32 may place its point anywhere along its
  rays.
"""
import copy
import importlib.util
import pathlib

import numpy as np
import pytest
import torch

from _torch_threads import _one_thread  # noqa: F401
from photogrammetry_tpu_torch.cli import run_sfm
from photogrammetry_tpu_torch.sfm import loop_closure as lc
from photogrammetry_tpu_torch.sfm.frontend import (
    FrontendConfig, frame_features, make_pairs, precompute_frontend,
)
from photogrammetry_tpu_torch.sfm.incremental import (
    SfmConfig, run_incremental_sfm,
)
from photogrammetry_tpu_torch.sfm.pose_graph import optimize_pose_graph
from photogrammetry_tpu_torch.synth.star_scene import (
    StarSceneConfig, generate_custom_sequence, pan_trajectory,
)
from photogrammetry_tpu_torch.utils import profiling

ROOT = pathlib.Path(__file__).resolve().parents[1]


def _load_reference():
    """``benchmarks/reference/loop.py``, loaded by its path (``sys.path``
    untouched)."""
    path = ROOT / "benchmarks" / "reference" / "loop.py"
    spec = importlib.util.spec_from_file_location("_loop_reference", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


ref = _load_reference()
ROT_DEG = 2e-4
OFFSET = np.array([0.0, 0.05, 0.0])     # the return leg's centre shift
LOOP = dict(mode="rotation", min_gap=5, min_matches=30, max_edges=8)


def _bits(seed, f=6, k=40, p=256):
    """Random bits with planted duplicates: frame 3 is frame 0, frame 5
    frame 1 with 8 bits flipped a row, and in each frame row 7 repeats row
    2 (tied distances both ways); the last 5 slots of frame 4 masked."""
    rng = np.random.default_rng(seed)
    bits = rng.integers(0, 2, (f, k, p)).astype(np.uint8)
    bits[3] = bits[0]
    bits[5] = bits[1]
    for row in range(k):
        flip = rng.choice(p, 8, replace=False)
        bits[5, row, flip] ^= 1
    bits[:, 7] = bits[:, 2]
    masks = np.ones((f, k), bool)
    masks[4, -5:] = False
    return torch.as_tensor(bits), torch.as_tensor(masks)


@pytest.mark.parametrize("seed,threshold", [(0, 64), (1, 112), (2, 128)])
def test_pair_grid_counts_exact(seed, threshold):
    bits, masks = _bits(seed)
    got = lc.pairwise_match_counts(bits, masks, threshold).numpy()
    want = ref.match_counts(bits, masks, threshold)
    np.testing.assert_array_equal(got, want)
    # the planted duplicate matches all its live keypoints but the tied
    # row, whose twin takes the first index
    assert want[0, 3] == 39


@pytest.mark.parametrize("seed", range(4))
def test_candidate_selection_exact(seed):
    rng = np.random.default_rng(seed)
    counts = rng.integers(0, 6, (14, 14)) * 10     # many equal counts
    for min_gap, min_matches, most in ((3, 20, 8), (5, 30, 4), (1, 0, 50)):
        assert lc.detect_loop_closures(
            counts, min_gap=min_gap, min_matches=min_matches,
            max_candidates=most) == ref.select_candidates(
                counts, min_gap, min_matches, most)


def _two_views(seed, n=120, outliers=0.2):
    """Pixels of n points seen from two cameras a small rotation and a
    baseline of 1% of the depth apart, a share of them moved at random."""
    rng = np.random.default_rng(seed)
    k = np.array([[520.0, 0, 320], [0, 520.0, 240], [0, 0, 1]])
    pts = rng.uniform([-2, -1.5, 5], [2, 1.5, 8], (n, 3))
    r2 = ref.so3_exp(rng.normal(0, 0.05, 3))
    t2 = rng.normal(0, 0.06, 3)

    def pix(r, t):
        uvw = (pts @ r.T + t) @ k.T
        return uvw[:, :2] / uvw[:, 2:]

    xy1 = pix(np.eye(3), np.zeros(3))
    xy2 = pix(r2, t2)
    bad = rng.random(n) < outliers
    xy2[bad] += rng.uniform(-40, 40, (bad.sum(), 2))
    return xy1.astype(np.float32), xy2.astype(np.float32), k


@pytest.mark.parametrize("seed", range(3))
def test_procrustes_rotation(seed):
    xy1, xy2, k = _two_views(seed)
    mask = np.ones(len(xy1), bool)
    mask[:3] = False                       # masked rows weigh nothing
    r, kept = lc.rotation_from_bearings(
        torch.as_tensor(xy1), torch.as_tensor(xy2), torch.as_tensor(mask),
        torch.as_tensor(k, dtype=torch.float32))
    want, want_kept, _ = ref.trimmed_procrustes(xy1[3:], xy2[3:],
                                                np.ones(len(xy1) - 3), k)
    assert int(kept) == want_kept
    assert ref.rotation_deg(r.double().numpy(), want) < ROT_DEG


def _noisy_chain(seed, n=8):
    """An 8-node walk on a circle, its estimate drifting in rotation and
    translation, and two loop edges measured from the truth with noise."""
    rng = np.random.default_rng(seed)
    ang = np.linspace(0, 1.5 * np.pi, n)
    rs_true = ref.so3_exp(np.stack([np.zeros(n), ang, np.zeros(n)], 1))
    centers = np.stack([2 * np.sin(ang), np.zeros(n), 2 * np.cos(ang)], 1)
    ts_true = -np.einsum("fij,fj->fi", rs_true, centers)
    drift = ref.so3_exp(np.cumsum(rng.normal(0, 0.01, (n, 3)), 0))
    rs = drift @ rs_true
    ts = ts_true + np.cumsum(rng.normal(0, 0.02, (n, 3)), 0)
    edges = [(0, n - 1), (1, n - 2)]
    meas = []
    for i, j in edges:
        zr, zt = ref.relative_pose(rs_true[i], ts_true[i], rs_true[j],
                                   ts_true[j])
        meas.append((ref.so3_exp(rng.normal(0, 0.005, 3)) @ zr,
                     zt + rng.normal(0, 0.01, 3)))
    return rs, ts, edges, meas


@pytest.mark.parametrize("seed", range(3))
def test_pose_graph_against_float64_lm(seed):
    rs, ts, edges, meas = _noisy_chain(seed)
    f32 = dict(dtype=torch.float32)
    graph = lc.build_pose_graph(
        torch.as_tensor(rs, **f32), torch.as_tensor(ts, **f32), edges,
        [(torch.as_tensor(zr, **f32), torch.as_tensor(zt, **f32))
         for zr, zt in meas], loop_weight=4.0, device="cpu")
    out = optimize_pose_graph(torch.as_tensor(rs, **f32),
                              torch.as_tensor(ts, **f32), graph)
    g = ref.chain_graph(rs.astype(np.float32), ts.astype(np.float32), edges,
                        [m[0].astype(np.float32) for m in meas],
                        [m[1].astype(np.float32) for m in meas],
                        loop_weight=4.0)
    rs_w, ts_w, c_w, c0_w = ref.lm(rs.astype(np.float32),
                                   ts.astype(np.float32), g)
    assert c_w < 0.5 * c0_w                # the loop edges pulled
    assert float(out.initial_cost) == pytest.approx(c0_w, rel=1e-5)
    rs_p = out.rs.double().numpy()
    ts_p = out.ts.double().numpy()
    assert abs(float(out.cost) - c_w) < 1e-5 * c0_w
    assert abs(float(out.cost) - ref.cost(rs_p, ts_p, g)) < 1e-5 * c0_w
    np.testing.assert_allclose(rs_p, rs_w, atol=1e-5)
    np.testing.assert_allclose(ts_p, ts_w, atol=1e-5)
    assert ref.gn_decrement(rs_p, ts_p, g) < 1e-8 * c0_w


@pytest.fixture(scope="module")
def walk():
    """A 6-frame pan at 240x320 walked out and back, the way back 0.05 off
    (frames 6-10 at the poses of 4..0), and the port's SfM run on it."""
    cfg = StarSceneConfig(num_frames=6, image_size=(240, 320), focal=260.0,
                          supersample=2)
    rs, _, centers = pan_trajectory(cfg)
    back = np.arange(4, -1, -1)
    rs = np.concatenate([rs, rs[back]])
    centers = np.concatenate([centers, centers[back] + OFFSET])
    ts = -np.einsum("fij,fj->fi", rs, centers)
    seq = generate_custom_sequence(
        StarSceneConfig(num_frames=11, image_size=(240, 320), focal=260.0,
                        supersample=2), rs, ts, centers)
    scfg = SfmConfig(frontend=FrontendConfig(
        detection_threshold=20.0, max_keypoints=256, reduction="nms",
        suppression_radius=4.0, hamming_threshold=80),
        collect_diagnostics=False)
    frames = seq["frames"].astype(np.float32)
    res = run_incremental_sfm(frames, seq["k"], scfg, seed=3, device="cpu")
    return frames, seq["k"], scfg, res


def test_out_and_back_legs_differ(walk):
    frames = walk[0]
    # frame 10 is frame 0's pose moved 0.05: the same view, not its pixels
    assert np.abs(frames[10] - frames[0]).max() > 100


def test_close_loops_stage_against_reference(walk):
    frames, k, cfg, res0 = walk
    res = copy.copy(res0)
    report, info = run_sfm.close_loops_stage(frames, res, k, cfg, "cpu",
                                             **LOOP)
    assert report == {"loop_edges": [list(e) for e in info["loop_edges"]],
                      "rejected_edges": len(info["rejected_edges"])}
    # the pair grid on the stage's own features
    feats = precompute_frontend(torch.as_tensor(frames),
                                make_pairs(cfg.frontend, device="cpu"),
                                cfg.frontend)
    thr = cfg.frontend.hamming_threshold
    counts = ref.match_counts(feats.bits, feats.points.mask, thr)
    np.testing.assert_array_equal(info["counts"], counts)
    # candidates, then the support gate on the float64 Procrustes
    cands = ref.select_candidates(counts, LOOP["min_gap"],
                                  LOOP["min_matches"], LOOP["max_edges"])
    edges = [tuple(e) for e in info["loop_edges"]]
    assert set(edges) | {tuple(p) for p, _ in info["rejected_edges"]} == \
        set(cands)
    assert edges, "no loop edge on the walk back"
    kmat = np.asarray(k, np.float64)
    for e, s, (zr, zt) in zip(edges, info["inliers"],
                              info["measurements"]):
        i, j = e
        fi, fj = frame_features(feats, i), frame_features(feats, j)
        rows, cols = ref.matches(fj.bits, fj.points.mask, fi.bits,
                                 fi.points.mask, thr)
        r, kept, _ = ref.trimmed_procrustes(
            fj.xy.numpy()[rows], fi.xy.numpy()[cols], np.ones(len(rows)),
            kmat)
        assert int(s) == kept >= LOOP["min_matches"]
        assert ref.rotation_deg(zr.double().numpy(), r.T) < ROT_DEG
    # the pose graph at the program's measurements
    g = ref.chain_graph(res0.rs, res0.ts, edges,
                        [zr.double().numpy() for zr, _ in
                         info["measurements"]],
                        [zt.double().numpy() for _, zt in
                         info["measurements"]], loop_weight=4.0)
    c_pre = ref.cost(res0.rs, res0.ts, g)
    assert info["initial_cost"] == pytest.approx(c_pre, rel=1e-5)
    assert abs(info["cost"] - ref.cost(res.rs, res.ts, g)) < 1e-5 * c_pre
    assert ref.gn_decrement(res.rs, res.ts, g) < 1e-8 * c_pre
    # the landmarks, re-triangulated under the corrected poses
    tb0, tb1 = res0.table, res.table
    seen = tb0.obs_mask.numpy()
    pts, depths, cond = ref.dlt_nview(tb0.obs.numpy(), seen, res.rs,
                                      res.ts, kmat)
    held = tb0.has_point.numpy() & np.where(
        seen, (depths > cfg.min_depth) & (depths < cfg.max_depth), True
    ).all(0) & (cond < 1e5)
    assert held.sum() > 20
    both = held & tb1.has_point.numpy()
    assert both.sum() >= 0.98 * held.sum()
    gap = np.linalg.norm(
        ref.project(tb1.points.double().numpy(), res.rs, res.ts, kmat)
        - ref.project(pts, res.rs, res.ts, kmat), axis=-1)
    assert np.median(gap[seen & both]) < 0.01


def test_stage_spans_and_counters(walk):
    frames, k, cfg, res0 = walk
    names = {"sfm.loop", "loop.features", "loop.detect", "loop.measure",
             "pose_graph.solve", "loop.retriangulate"}
    profiling.clear()
    _, info = run_sfm.close_loops_stage(frames, copy.copy(res0), k, cfg,
                                        "cpu", **LOOP)
    assert not profiling.spans() and not profiling.read_counters()
    with profiling.recording():
        run_sfm.close_loops_stage(frames, copy.copy(res0), k, cfg, "cpu",
                                  **LOOP)
    spans = profiling.spans()
    got = profiling.read_counters()
    profiling.clear()
    assert names <= {s.name for s in spans}
    stage = next(s for s in spans if s.name == "sfm.loop")
    inner = [s for s in spans if s.name in names - {"sfm.loop"}]
    assert all(s.root == stage.id and s.end <= stage.end for s in inner)
    n = len(frames)
    assert got["loop.pairs_matched"] == n * n
    assert got["loop.candidates"] == len(info["loop_edges"]) + len(
        info["rejected_edges"])
    assert got["loop.edges_accepted"] == len(info["loop_edges"])
    assert got["pose_graph.lm_iterations"] == 20
    assert 0 < got["pose_graph.lm_accepted"] <= 20
