"""Port parity: loop closure (place recognition, detection, loop-edge
measurement, close_loops in all four modes, the shortlist branch), the
ported orbit scene, and ``run_sfm --loop-closure``.

Both packages see the same features: the JAX frontend's keypoints, bits and
xy are carried across, so the match counts must be equal, and the
detections identical.  Rotations (Procrustes, loop-edge measurements)
within 1e-4 (f32 SVDs in two LAPACK builds); the corrected poses within
1e-4 and the pose-graph cost within 1e-4 relative.  Essential-mode draws
are JAX's, injected through ``two_view_from_samples``, on a wide-baseline
loop pair (the ``wide`` fixture says why): the supports equal, the
measurements and corrected poses within 1e-3 (the two-view parity of
tests/test_torch_geometry.py is 0.1 deg, 1.7e-3 rad).
"""
import json
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import jax_two_view_samples
from _torch_threads import _one_thread  # noqa: F401
from photogrammetry_tpu.sfm import loop_closure as jlc
from photogrammetry_tpu.sfm.frontend import DescribedFrame as JaxFrame
from photogrammetry_tpu.sfm.frontend import FrontendConfig as JaxConfig
from photogrammetry_tpu.sfm.frontend import frame_features as jax_frame
from photogrammetry_tpu.sfm.frontend import make_pairs as jax_make_pairs
from photogrammetry_tpu.sfm.frontend import \
    precompute_frontend as jax_precompute
from photogrammetry_tpu.synth import star_scene as jstar
from photogrammetry_tpu.utils.padding import PaddedPoints as JaxPoints
from photogrammetry_tpu_torch.cli import run_sfm
from photogrammetry_tpu_torch.sfm import loop_closure as lc
from photogrammetry_tpu_torch.sfm.frontend import (
    DescribedFrame, FrontendConfig,
)
from photogrammetry_tpu_torch.sfm.two_view import two_view_from_samples
from photogrammetry_tpu_torch.synth import star_scene
from photogrammetry_tpu_torch.synth.star_scene import (
    StarSceneConfig, generate_orbit_sequence, generate_sequence,
    render_frame,
)
from photogrammetry_tpu_torch.utils.padding import PaddedPoints
from test_torch_geometry import K as GEOM_K
from test_torch_geometry import _scene

JCFG = JaxConfig(detection_threshold=20.0, max_keypoints=256,
                 reduction="nms", suppression_radius=4.0,
                 hamming_threshold=80)
CFG = FrontendConfig(detection_threshold=20.0, max_keypoints=256,
                     reduction="nms", suppression_radius=4.0,
                     hamming_threshold=80)
ROT_TOL = dict(rtol=0, atol=1e-4)


def _yaw(a):
    c, s = np.cos(a), np.sin(a)
    return np.array([[c, 0.0, s], [0.0, 1.0, 0.0], [-s, 0.0, c]])


def _features(frames):
    """(JAX DescribedFrames, the same carried into the port)."""
    f = jax_precompute(jnp.asarray(np.asarray(frames), jnp.float32),
                       jax_make_pairs(JCFG), JCFG, chunk=8)
    jax_feats = [jax_frame(f, t) for t in range(len(frames))]

    def port(fr):
        return DescribedFrame(
            points=PaddedPoints(*(torch.tensor(np.asarray(x))
                                  for x in fr.points)),
            bits=torch.tensor(np.asarray(fr.bits)),
            xy=torch.tensor(np.asarray(fr.xy)))

    return jax_feats, [port(fr) for fr in jax_feats]


@pytest.fixture(scope="module")
def revisit():
    """tests/test_loop_closure.py's revisit scene from the port's renderer:
    a 5-frame pan and a last frame back at frame 2's pose (+0.02 in x)."""
    scene = generate_sequence(StarSceneConfig(num_frames=5, supersample=2))
    cfg = scene["config"]
    cx = scene["centers"][2][0] + 0.02
    r = _yaw(float(np.arctan2(cx, cfg.depth)))
    t = -r @ np.array([cx, 0.0, 0.0])
    frames = np.concatenate([scene["frames"],
                             render_frame(cfg, r, t, scene["k"])[None]])
    rs = np.concatenate([scene["rs"], r[None]]).astype(np.float32)
    ts = np.concatenate([scene["ts"], t[None]]).astype(np.float32)
    return (frames, rs, ts, scene["k"], *_features(frames))


@pytest.fixture(scope="module")
def wide():
    """A loop pair with a wide baseline for the 'essential' mode: frames 0
    and 3 see tests/test_torch_geometry.py's rigid scene (120 points, depth
    3-12, baseline 1/6 of the depth, pixel noise, 20% outliers) with the
    same random bits at each point, frames 1 and 2 random keypoints.  On
    the star scene's loop pairs (~24-67 matches at 5% baseline) a one-ulp
    difference in the f32 eight-point F moves an inlier and the RANSAC
    winner in either package."""
    xy1, xy2, mask, _, _ = _scene(10)
    n = len(xy1)
    rng = np.random.default_rng(10)
    bits = rng.integers(0, 2, (n, 256)).astype(np.uint8)
    every = np.ones(n, bool)
    frames = [(xy1, bits, mask)] + [
        (rng.uniform(0, 300, (n, 2)).astype(np.float32),
         rng.integers(0, 2, (n, 256)).astype(np.uint8), every)
        for _ in range(2)] + [(xy2, bits, every)]
    jax_feats, feats = [], []
    for xy, b, m in frames:
        pts = (np.zeros((n, 2), np.int32), np.ones(n, np.float32), m,
               np.int32(m.sum()))
        jax_feats.append(JaxFrame(
            points=JaxPoints(*(jnp.asarray(x) for x in pts)),
            bits=jnp.asarray(b), xy=jnp.asarray(xy)))
        feats.append(DescribedFrame(
            points=PaddedPoints(*(torch.tensor(np.asarray(x)) for x in pts)),
            bits=torch.tensor(b), xy=torch.tensor(xy)))
    rs = np.tile(np.eye(3, dtype=np.float32), (4, 1, 1))
    ts = np.random.default_rng(1).normal(0, 1, (4, 3)).astype(np.float32)
    return None, rs, ts, GEOM_K.astype(np.float32), jax_feats, feats


@pytest.fixture(scope="module")
def orbit():
    """tests/test_run_sfm_cli.py's 14-frame full orbit at 240x320: frames 0
    and 13 are the same pose, (0, 12) and (1, 13) one step apart."""
    scene = generate_orbit_sequence(
        StarSceneConfig(num_frames=14, image_size=(240, 320), focal=260.0,
                        supersample=2), total_angle=6.283)
    return (scene["frames"], scene["rs"].astype(np.float32),
            scene["ts"].astype(np.float32), scene["k"], scene["centers"],
            *_features(scene["frames"]))


@pytest.mark.parametrize("trajectory", ["orbit", "dolly", "roll"])
def test_ported_scenes_match_jax(trajectory):
    """The orbit, dolly and roll trajectories and the sequences rendered
    for them (generate_orbit_sequence, generate_custom_sequence) equal the
    JAX package's."""
    cfg = StarSceneConfig(num_frames=3, image_size=(60, 80), focal=65.0)
    jcfg = jstar.StarSceneConfig(num_frames=3, image_size=(60, 80),
                                 focal=65.0)
    if trajectory == "orbit":
        got = generate_orbit_sequence(cfg, total_angle=2.0)
        ref = jstar.generate_orbit_sequence(jcfg, total_angle=2.0)
    else:
        arg = {"dolly": 2.5, "roll": 0.8}[trajectory]
        ours = getattr(star_scene, f"{trajectory}_trajectory")(cfg, arg)
        theirs = getattr(jstar, f"{trajectory}_trajectory")(jcfg, arg)
        got = star_scene.generate_custom_sequence(cfg, *ours)
        ref = jstar.generate_custom_sequence(jcfg, *theirs)
    for key in ("frames", "k", "rs", "ts", "centers", "points"):
        np.testing.assert_array_equal(got[key], ref[key], key)


@pytest.mark.parametrize("budget", [lc.PAIR_BUDGET_BYTES, 5 * 4 * 256 * 256])
@pytest.mark.parametrize("scene", ["revisit", "orbit"])
def test_pairwise_counts_and_detection_equal_jax(scene, budget, request,
                                                 monkeypatch):
    """All F² pairs, in one chunk and in chunks of 5 pairs."""
    data = request.getfixturevalue(scene)
    jax_feats, feats = data[-2:]
    bits = torch.stack([f.bits for f in feats])
    masks = torch.stack([f.points.mask for f in feats])
    monkeypatch.setattr(lc, "PAIR_BUDGET_BYTES", budget)
    got = lc.pairwise_match_counts(bits, masks, 80)
    ref = np.asarray(jlc.pairwise_match_counts(
        jnp.stack([f.bits for f in jax_feats]),
        jnp.stack([f.points.mask for f in jax_feats]), 80))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), ref)
    # a frame against itself: every keypoint its own mutual nearest
    np.testing.assert_array_equal(ref.diagonal(), masks.sum(1).numpy())
    for gap, need in ((3, 18), (5, 25), (2, 1)):
        assert lc.detect_loop_closures(got.numpy(), gap, need) == \
            jlc.detect_loop_closures(ref, gap, need)


def test_detect_loop_closures_thresholds():
    counts = np.zeros((6, 6), int)
    counts[1, 5] = counts[5, 1] = 80
    counts[0, 3] = counts[3, 0] = 50
    counts[4, 5] = counts[5, 4] = 100   # temporal neighbor: gap too small
    for min_matches, want in ((18, [(1, 5), (0, 3)]), (200, [])):
        got = lc.detect_loop_closures(counts, 3, min_matches)
        assert got == want == jlc.detect_loop_closures(counts, 3,
                                                       min_matches)


def test_rotation_from_bearings_matches_jax():
    rng = np.random.default_rng(4)
    k = np.array([[520.0, 0, 320], [0, 520.0, 240], [0, 0, 1]], np.float32)
    xy1 = rng.uniform([0, 0], [640, 480], (200, 2)).astype(np.float32)
    r_true = _yaw(0.05) @ np.array([[1, 0, 0], [0, np.cos(0.02),
                                                -np.sin(0.02)],
                                    [0, np.sin(0.02), np.cos(0.02)]])
    bear = np.concatenate([xy1, np.ones((200, 1))], 1) @ np.linalg.inv(k).T
    proj = bear @ r_true.T @ k.T
    xy2 = (proj[:, :2] / proj[:, 2:]).astype(np.float32)
    xy2[:20] += rng.normal(0, 40, (20, 2)).astype(np.float32)  # outliers
    mask = rng.random(200) > 0.1
    got_r, got_n = lc.rotation_from_bearings(
        torch.tensor(xy1), torch.tensor(xy2), torch.tensor(mask),
        torch.tensor(k))
    ref_r, ref_n = jlc.rotation_from_bearings(xy1, xy2, jnp.asarray(mask),
                                              k)
    np.testing.assert_allclose(got_r.numpy(), np.asarray(ref_r), **ROT_TOL)
    assert int(got_n) == int(ref_n)
    np.testing.assert_allclose(got_r.numpy(), r_true, rtol=0, atol=1e-3)


def _inject_jax_draws(monkeypatch, key, num_pairs, num_samples=512):
    """Make the port's two_view_pipeline use the draws JAX's
    measure_loop_edges takes from ``key`` for each of its pairs in turn
    (key, sub = split(key) per pair; F from sub, H from fold_in(sub, 1))."""
    subs = []
    for _ in range(num_pairs):
        key, sub = jax.random.split(key)
        subs.append(sub)
    it = iter(subs)

    def fake(generator, xy1, xy2, mask, k, num_samples=num_samples,
             threshold=1.0):
        f_idx, h_idx = jax_two_view_samples(next(it), mask.numpy(),
                                            num_samples, 500)
        return two_view_from_samples(torch.tensor(f_idx),
                                     torch.tensor(h_idx), xy1, xy2, mask, k,
                                     threshold=threshold)

    monkeypatch.setattr(lc, "two_view_pipeline", fake)


@pytest.mark.parametrize("mode", ["rotation", "revisit", "essential"])
def test_measure_loop_edges_matches_jax(mode, request, monkeypatch):
    if mode == "essential":
        _, rs, ts, k, jax_feats, feats = request.getfixturevalue("wide")
        pairs = [(0, 3)]
    else:
        _, rs, ts, k, jax_feats, feats = request.getfixturevalue("revisit")
        pairs = [(2, 5), (1, 5)]
    tol = dict(rtol=0, atol=1e-3 if mode == "essential" else 1e-4)
    key = jax.random.PRNGKey(3)
    _inject_jax_draws(monkeypatch, key, len(pairs))
    gen = torch.Generator().manual_seed(0)
    got, got_s = lc.measure_loop_edges(feats, torch.tensor(rs),
                                       torch.tensor(ts), torch.tensor(k),
                                       pairs, CFG, gen, mode=mode)
    ref, ref_s = jlc.measure_loop_edges(jax_feats, rs, ts, k, pairs, JCFG,
                                        key, mode=mode)
    assert got_s == ref_s and min(got_s) > 10
    for (zr, zt), (jzr, jzt) in zip(got, ref):
        np.testing.assert_allclose(zr.numpy(), np.asarray(jzr), **tol)
        np.testing.assert_allclose(zt.numpy(), np.asarray(jzt), **tol)
    if mode == "rotation":     # the edge's translation residual vanishes
        (zr, zt), = got[:1]
        np.testing.assert_allclose((zr @ torch.tensor(ts[2]) + zt).numpy(),
                                   ts[5], atol=1e-6)


def _rot_err_deg(rs_a, rs_b):
    cos = (np.einsum("fij,fij->f", np.asarray(rs_a, np.float64),
                     np.asarray(rs_b, np.float64)) - 1.0) / 2.0
    return np.degrees(np.arccos(np.clip(cos, -1, 1)))


def _drifted(rs_gt, ts_gt, rate):
    """Growing yaw drift about the world origin (centres untouched)."""
    dr = np.stack([_yaw(rate * t) for t in range(len(rs_gt))])
    return (np.einsum("fij,fjk->fik", dr, rs_gt).astype(np.float32),
            np.einsum("fij,fj->fi", dr, ts_gt).astype(np.float32))


@pytest.mark.parametrize("mode", ["rotation", "revisit", "revisit_sim3",
                                  "essential"])
def test_close_loops_matches_jax(mode, request, monkeypatch):
    scene = "wide" if mode == "essential" else "revisit"
    _, rs_gt, ts_gt, k, jax_feats, feats = request.getfixturevalue(scene)
    gap, need = 3, 18
    tol = dict(rtol=0, atol=1e-3 if mode == "essential" else 1e-4)
    rs_d, ts_d = _drifted(rs_gt, ts_gt, 0.022)
    key = jax.random.PRNGKey(0)
    _inject_jax_draws(monkeypatch, key, 8)
    rs_o, ts_o, info = lc.close_loops(feats, torch.tensor(rs_d),
                                      torch.tensor(ts_d), torch.tensor(k),
                                      CFG, min_gap=gap, min_matches=need,
                                      mode=mode)
    ref_rs, ref_ts, ref = jlc.close_loops(jax_feats, rs_d, ts_d, k, JCFG,
                                          key=key, min_gap=gap,
                                          min_matches=need, mode=mode)
    np.testing.assert_array_equal(info["counts"], ref["counts"])
    assert info["loop_edges"] == ref["loop_edges"] and info["loop_edges"]
    assert info["inliers"] == ref["inliers"]
    assert info["rejected_edges"] == ref["rejected_edges"]
    np.testing.assert_allclose(info["cost"], ref["cost"],
                               rtol=tol["atol"], atol=1e-6)
    assert info["cost"] <= info["initial_cost"]
    np.testing.assert_allclose(rs_o.numpy(), np.asarray(ref_rs), **tol)
    np.testing.assert_allclose(ts_o.numpy(), np.asarray(ref_ts), **tol)
    if mode == "revisit_sim3":
        np.testing.assert_allclose(info["loop_scales"], ref["loop_scales"],
                                   rtol=1e-4)
    if mode == "rotation":
        # tests/test_loop_closure.py::test_close_loops_corrects_rotation_drift
        # on the port: the mean error falls, the loop's own gap vanishes
        assert (2, 5) in info["loop_edges"]
        err0 = _rot_err_deg(rs_d, rs_gt).mean()
        assert _rot_err_deg(rs_o, rs_gt).mean() < 0.75 * err0

        def rel(rs):
            return (np.asarray(rs[5]) @ np.asarray(rs[2]).T)[None]
        assert _rot_err_deg(rel(rs_d), rel(rs_gt))[0] > 3.0
        assert _rot_err_deg(rel(rs_o.numpy()), rel(rs_gt))[0] < 1.0


def test_close_loops_gates_on_geometric_support(revisit):
    _, rs, ts, k, _, feats = revisit
    rs_o, ts_o, info = lc.close_loops(feats, rs, ts, k, CFG, min_gap=3,
                                      min_matches=18, min_support=10_000)
    assert info["loop_edges"] == [] and info["rejected_edges"]
    assert rs_o is rs and ts_o is ts


def test_close_loops_shortlist_branch_matches_jax():
    """Past 64 frames only a global-descriptor shortlist of 64 pairs is
    fully matched (one batched launch on the card): 65 frames of 24
    keypoints, some frames near-copies of earlier ones."""
    rng = np.random.default_rng(9)
    f, kp, p = 65, 24, 256
    bits = rng.integers(0, 2, (f, kp, p)).astype(np.uint8)
    for i, j in ((2, 40), (7, 60), (11, 30), (20, 64)):
        bits[j] = bits[i] ^ (rng.random((kp, p)) < 0.05)
    mask = rng.random((f, kp)) > 0.15
    xy = rng.uniform(0, 100, (f, kp, 2)).astype(np.float32)
    coords = np.zeros((f, kp, 2), np.int32)
    jax_feats, feats = [], []
    for t in range(f):
        pts = (coords[t], np.ones(kp, np.float32), mask[t],
               np.int32(mask[t].sum()))
        # the JAX branch reads only the bits and the masks
        jax_feats.append(SimpleNamespace(
            points=SimpleNamespace(mask=jnp.asarray(mask[t])),
            bits=jnp.asarray(bits[t])))
        feats.append(DescribedFrame(
            points=PaddedPoints(*(torch.tensor(np.asarray(x)) for x in pts)),
            bits=torch.tensor(bits[t]), xy=torch.tensor(xy[t])))
    rs = np.tile(np.eye(3, dtype=np.float32), (f, 1, 1))
    ts = np.zeros((f, 3), np.float32)
    k = np.eye(3, dtype=np.float32)
    _, _, info = lc.close_loops(feats, rs, ts, k, CFG, min_gap=3,
                                min_matches=10 ** 6)
    _, _, ref = jlc.close_loops(jax_feats, rs, ts, k, JCFG, min_gap=3,
                                min_matches=10 ** 6)
    np.testing.assert_array_equal(info["counts"], ref["counts"])
    assert (info["counts"] > 0).sum() <= lc.SHORTLIST
    for i, j in ((2, 40), (7, 60), (11, 30), (20, 64)):
        assert info["counts"][i, j] >= 10


def test_run_sfm_loop_closure_cli(tmp_path, capsys, orbit):
    """tests/test_run_sfm_cli.py::test_run_sfm_loop_closure_cli on the
    port: the 14-frame orbit with its revisit, the report carrying the
    loop edges."""
    from PIL import Image

    frames = orbit[0]
    frames_dir = tmp_path / "frames"
    frames_dir.mkdir()
    for i, frame in enumerate(frames):
        Image.fromarray(frame).save(frames_dir / f"{i:03d}.png")
    traj = tmp_path / "traj.json"
    assert run_sfm.main([str(frames_dir), "--device", "cpu",
                         "--fx", "260", "--cx", "160", "--cy", "120",
                         "--detection-threshold", "20",
                         "--loop-closure", "--loop-min-gap", "5",
                         "--loop-min-matches", "25",
                         "--trajectory", str(traj),
                         "--cloud", str(tmp_path / "cloud.ply")]) == 0
    report = json.loads([ln for ln in capsys.readouterr().out.splitlines()
                         if ln.startswith("{")][0])
    edges = report["loop_closure"]["loop_edges"]
    assert (0, 13) in map(tuple, edges) and all(j - i >= 5 for i, j in edges)
    assert report["frames"] == 14
    data = json.loads(traj.read_text())
    assert len(data["centers"]) == 14
    assert np.isfinite(np.asarray(data["centers"])).all()


def _stage_with_args(frames, res, k, cfg, args, device):
    """``run_sfm.close_loops_stage`` as it was when it read its settings
    from the CLI's argparse namespace (the plain and keyframe modes), kept
    to show the keyword form changes nothing."""
    from photogrammetry_tpu_torch.sfm.frontend import (
        frame_features, make_pairs, precompute_frontend,
    )
    from photogrammetry_tpu_torch.sfm.incremental import _depth_ok
    from photogrammetry_tpu_torch.sfm.triangulate import triangulate_nview

    num = len(frames)
    min_gap = (args.loop_min_gap if args.loop_min_gap is not None
               else max(5, num // 4))
    stacked = precompute_frontend(
        torch.as_tensor(np.asarray(frames), dtype=torch.float32,
                        device=device), make_pairs(cfg.frontend,
                                                   device=device),
        cfg.frontend, chunk=cfg.frontend_chunk)
    feats = [frame_features(stacked, t) for t in range(num)]
    kmat = torch.as_tensor(np.asarray(k), dtype=torch.float32, device=device)
    gen = torch.Generator(device=device).manual_seed(run_sfm.LOOP_SEED)
    rs_lc, ts_lc, info = lc.close_loops(
        feats, torch.as_tensor(res.rs, device=device),
        torch.as_tensor(res.ts, device=device), kmat, cfg.frontend,
        generator=gen, min_gap=min_gap, min_matches=args.loop_min_matches,
        mode=args.loop_mode, max_candidates=args.loop_max_edges)
    rs_lc = torch.as_tensor(rs_lc, dtype=torch.float32, device=device)
    ts_lc = torch.as_tensor(ts_lc, dtype=torch.float32, device=device)
    report = {"loop_edges": [list(p) for p in info["loop_edges"]],
              "rejected_edges": len(info.get("rejected_edges", []))}
    table = res.table
    pts, depths = triangulate_nview(table.obs, table.obs_mask, rs_lc, ts_lc,
                                    kmat)
    has = table.has_point & _depth_ok(table.obs_mask, depths, cfg.min_depth,
                                      cfg.max_depth)
    res.table = table._replace(
        points=torch.where(has[:, None], pts, table.points), has_point=has)
    res.rs, res.ts = rs_lc.cpu().numpy(), ts_lc.cpu().numpy()
    return report


@pytest.mark.parametrize("flags,args", [
    (["--loop-min-gap", "5", "--loop-min-matches", "25"],
     dict(loop_min_gap=5, loop_min_matches=25, loop_max_edges=8,
          loop_mode="rotation")),
    (["--loop-mode", "revisit", "--loop-max-edges", "2"],
     dict(loop_min_gap=None, loop_min_matches=30, loop_max_edges=2,
          loop_mode="revisit")),
])
def test_run_sfm_loop_closure_cli_as_with_the_args_form(
        tmp_path, capsys, monkeypatch, orbit, flags, args):
    """``run_sfm --loop-closure`` passes its flags to the stage's keyword
    settings: the stage's report, poses and landmarks equal those of the
    stage as it read the argparse namespace, on the same SfM run."""
    import copy

    from PIL import Image

    frames_dir = tmp_path / "frames"
    frames_dir.mkdir()
    for i, frame in enumerate(orbit[0]):
        Image.fromarray(frame).save(frames_dir / f"{i:03d}.png")
    stage = run_sfm.close_loops_stage
    seen = []

    def both(frames, res, k, cfg, device, **settings):
        before = copy.copy(res)
        want = _stage_with_args(frames, before, k, cfg,
                                SimpleNamespace(**args), device)
        got, info = stage(frames, res, k, cfg, device, **settings)
        seen.append((want, got, before, res, info))
        return got, info

    monkeypatch.setattr(run_sfm, "close_loops_stage", both)
    traj = tmp_path / "traj.json"
    assert run_sfm.main([str(frames_dir), "--device", "cpu",
                         "--fx", "260", "--cx", "160", "--cy", "120",
                         "--detection-threshold", "20", "--loop-closure",
                         *flags, "--trajectory", str(traj),
                         "--cloud", str(tmp_path / "cloud.ply")]) == 0
    report = json.loads([ln for ln in capsys.readouterr().out.splitlines()
                         if ln.startswith("{")][0])
    (want, got, before, after, info), = seen
    assert got == want == report["loop_closure"]
    assert want["loop_edges"], "no loop edge: the comparison shows nothing"
    np.testing.assert_array_equal(after.rs, before.rs)
    np.testing.assert_array_equal(after.ts, before.ts)
    for name in ("points", "has_point"):
        assert torch.equal(getattr(after.table, name),
                           getattr(before.table, name))
    data = json.loads(traj.read_text())
    np.testing.assert_array_equal(np.asarray(data["rotations"]),
                                  before.rs.astype(np.float64))
    assert [list(e) for e in info["loop_edges"]] == want["loop_edges"]
