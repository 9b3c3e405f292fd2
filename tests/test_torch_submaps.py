"""Port parity: submaps (the Sim3 seam algebra, the union-find track merge,
``refine_submaps_global``, ``run_submap_sfm``'s stitch and seam pose
graph) and ``run_sfm --submap-*``.

The windows' reconstructions are synthetic and shared by both packages:
a known scene cut into windows, each window's poses and cloud in a gauge
of its own, its track table holding the scene's observations (float32,
the same bytes in every window that sees the frame, as the deterministic
frontend gives them), its track ids shuffled.  ``run_submap_sfm`` gets
them through ``monkeypatch`` of each package's
``run_incremental_sfm_robust``, so only the stitch, the pose graph and
the refine are compared.

Tolerances: the seam algebra and the merge are numpy in both packages:
bit-equal.  The stitched and pose-graph poses within 1e-4 (the f32
pose-graph LM, held to 1e-4 by tests/test_torch_pose_graph.py).  The
global refine (f32 BA over merged tracks) within 1e-3 in poses and the
same landmarks (count) with points within 1e-3 relative.
"""
import json
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from _torch_threads import _one_thread  # noqa: F401
from photogrammetry_tpu.sfm import submaps as jsub
from photogrammetry_tpu_torch.cli import run_sfm
from photogrammetry_tpu_torch.sfm import submaps as sub
from photogrammetry_tpu_torch.synth.star_scene import (
    StarSceneConfig, generate_sequence, orbit_trajectory, pan_trajectory,
)

POSE_TOL = dict(rtol=0, atol=1e-4)
REFINE_TOL = dict(rtol=0, atol=1e-3)
K = np.array([[260.0, 0, 160], [0, 260.0, 120], [0, 0, 1]], np.float32)


def _rotation(rng, scale):
    aa = rng.normal(0, scale, 3)
    th = np.linalg.norm(aa)
    k = aa / th
    kx = np.array([[0, -k[2], k[1]], [k[2], 0, -k[0]], [-k[1], k[0], 0]])
    return np.eye(3) + np.sin(th) * kx + (1 - np.cos(th)) * kx @ kx


def _windows(num_frames=16, submap_frames=8, overlap=3, seed=0):
    """A 240x320 pan over 400 random points at depth 4-8; its spans; each
    window's result (poses, cloud and table in its own random gauge, with
    small pose noise), and the true poses."""
    rng = np.random.default_rng(seed)
    cfg = StarSceneConfig(num_frames=num_frames, image_size=(240, 320),
                          focal=260.0)
    rs, ts, _ = pan_trajectory(cfg)
    pts = np.concatenate([rng.uniform(-3, 3, (400, 2)),
                          rng.uniform(4, 8, (400, 1))], 1)
    pc = np.einsum("fij,nj->fni", rs, pts) + ts[:, None, :]
    uv = pc[..., :2] / pc[..., 2:] * 260.0 + np.array([160.0, 120.0])
    seen = ((pc[..., 2] > 0) & (uv[..., 0] >= 0) & (uv[..., 0] < 320)
            & (uv[..., 1] >= 0) & (uv[..., 1] < 240))
    # one observation per (frame, point), shared by every window
    obs_all = (uv + rng.normal(0, 0.3, uv.shape)).astype(np.float32)
    spans = sub.submap_spans(num_frames, submap_frames, overlap)
    results = []
    for a, b in spans:
        vis = seen[a:b]
        ids = rng.permutation(np.nonzero(vis.sum(0) >= 2)[0])
        cap = 512
        obs = np.zeros((b - a, cap, 2), np.float32)
        mask = np.zeros((b - a, cap), bool)
        obs[:, :len(ids)] = obs_all[a:b][:, ids]
        mask[:, :len(ids)] = vis[:, ids]
        s, r_g = rng.uniform(0.5, 2.0), _rotation(rng, 0.5)
        t_g = rng.normal(0, 1, 3)
        noisy = np.stack([r @ _rotation(rng, 1e-3) for r in rs[a:b]])
        rs_w, ts_w, pts_w = sub._apply_sim3(s, r_g, t_g, noisy, ts[a:b],
                                            pts[ids])
        results.append(SimpleNamespace(
            rs=rs_w.astype(np.float32), ts=ts_w.astype(np.float32),
            points=pts_w.astype(np.float32),
            table=SimpleNamespace(obs=obs, obs_mask=mask,
                                  num_tracks=np.int32(len(ids)),
                                  dropped=np.int32(0)),
            quality=(len(ids), 0.3)))
    return spans, results, rs.astype(np.float32), ts.astype(np.float32)


def _loop_links(spans, results):
    """Two links fusing a track of window 0 with one of the last window
    at frames 1 and 14 (consistent: no shared frame), and one fusing two
    tracks of windows 0 and 1 that hold different keypoints in frame 6
    (a conflict: the merge falls back to the larger track)."""
    def track_obs(i, frame, nth):
        a = spans[i][0]
        t_ = results[i].table
        tid = np.nonzero(t_.obs_mask[frame - a])[0][nth]
        return tuple(t_.obs[frame - a, tid])

    last = len(spans) - 1
    return [(1, track_obs(0, 1, 3), 14, track_obs(last, 14, 5)),
            (1, track_obs(0, 1, 3), 14, track_obs(last, 14, 5)),
            (6, track_obs(0, 6, 0), 6, track_obs(1, 6, 7)),
            (6, track_obs(0, 6, 0), 6, track_obs(1, 6, 7))]


def test_align_and_apply_sim3_bit_equal_to_jax():
    rng = np.random.default_rng(3)
    rs = np.stack([_rotation(rng, 1.0) for _ in range(5)])
    ts = rng.normal(0, 2, (5, 3))
    rs2 = np.stack([_rotation(rng, 1.0) for _ in range(5)])
    ts2 = rng.normal(0, 2, (5, 3))
    pts = rng.normal(0, 3, (40, 3))
    for a, b in zip(sub._align_sim3_poses(rs, ts, rs2, ts2),
                    jsub._align_sim3_poses(rs, ts, rs2, ts2)):
        np.testing.assert_array_equal(a, b)
    sim = sub._align_sim3_poses(rs, ts, rs2, ts2)
    for a, b in zip(sub._apply_sim3(*sim, rs, ts, pts),
                    jsub._apply_sim3(*sim, rs, ts, pts)):
        np.testing.assert_array_equal(a, b)
    assert sub._apply_sim3(*sim, rs, ts)[2] is None


def test_sim3_pose_alignment_roundtrip():
    """tests/test_submaps.py's round trip on the port's functions:
    _align_sim3_poses recovers an applied similarity exactly, the roll
    that center-only Umeyama leaves free included."""
    rs, ts, _ = orbit_trajectory(StarSceneConfig(num_frames=10), 0.8)
    r_g = _rotation(np.random.default_rng(0), 0.5)
    s, t_g = 2.7, np.array([0.3, -1.0, 0.5])
    rs_m, ts_m, _ = sub._apply_sim3(1 / s, r_g.T, -r_g.T @ t_g / s, rs, ts)
    s_e, r_e, t_e = sub._align_sim3_poses(rs_m, ts_m, rs, ts)
    assert s_e == pytest.approx(s, abs=1e-9)
    np.testing.assert_allclose(r_e, r_g, atol=1e-12)
    rs2, ts2, _ = sub._apply_sim3(s_e, r_e, t_e, rs_m, ts_m)
    np.testing.assert_allclose(rs2, rs, atol=1e-12)
    np.testing.assert_allclose(ts2, ts, atol=1e-9)


@pytest.mark.parametrize("kwargs", [dict(overlap=2),
                                    dict(submap_frames=3, overlap=3)])
def test_submap_spans_and_overlap_rules(kwargs):
    for fn in (sub.run_submap_sfm, jsub.run_submap_sfm):
        with pytest.raises(ValueError):
            fn(np.zeros((8, 16, 16)), np.eye(3), **kwargs)
    assert sub.submap_spans(23, 12, 4) == [(0, 12), (8, 20), (16, 23)]
    assert sub.submap_spans(12, 8, 3) == [(0, 8), (5, 12)]
    assert sub.submap_spans(9, 8, 3) == [(0, 9)]   # tail merged


@pytest.mark.parametrize("links", [False, True])
def test_merge_submap_tracks_equal_to_jax(links):
    spans, results, _, _ = _windows()
    loop = _loop_links(spans, results) if links else None
    got = sub._merge_submap_tracks(results, spans, 16, 600, loop_links=loop)
    ref = jsub._merge_submap_tracks(results, spans, 16, 600, loop_links=loop)
    for a, b in zip(got, ref):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    # cross-seam tracks were fused: more observations a track than any
    # one window could give
    assert got[1].sum(0).max() > 8
    # the same tables as torch tensors (the port's own results) merge the
    # same way
    as_torch = [SimpleNamespace(table=SimpleNamespace(
        obs=torch.from_numpy(r.table.obs),
        obs_mask=torch.from_numpy(r.table.obs_mask))) for r in results]
    for a, b in zip(sub._merge_submap_tracks(as_torch, spans, 16, 600,
                                             loop_links=loop), ref):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("prior_weight", [300.0, 100.0, 0.0])
def test_refine_submaps_global_beside_jax(prior_weight):
    spans, results, rs, ts = _windows(num_frames=12)
    rng = np.random.default_rng(5)
    rs0 = np.stack([r @ _rotation(rng, 2e-3) for r in rs]).astype(np.float32)
    ts0 = (ts + rng.normal(0, 5e-3, ts.shape)).astype(np.float32)
    kw = dict(capacity=512, rounds=2, iterations=10,
              prior_weight=prior_weight)
    got = sub.refine_submaps_global(rs0, ts0, results, spans, K, 12,
                                    device="cpu", **kw)
    ref = jsub.refine_submaps_global(rs0, ts0, results, spans, K, 12, **kw)
    np.testing.assert_allclose(got[0], np.asarray(ref[0]), **REFINE_TOL)
    np.testing.assert_allclose(got[1], np.asarray(ref[1]), **REFINE_TOL)
    assert got[2].shape == ref[2].shape and got[2].shape[0] > 100
    np.testing.assert_allclose(got[2], ref[2], rtol=1e-3, atol=1e-3)


class _Spy:
    """Records the keyword arguments of the calls to ``fn``."""

    def __init__(self, fn):
        self.fn, self.calls = fn, []

    def __call__(self, *args, **kwargs):
        self.calls.append(kwargs)
        return self.fn(*args, **kwargs)


def test_run_submap_sfm_stitch_beside_jax(monkeypatch):
    """Both packages stitch the same per-window results (their robust SfM
    patched to hand them out by window): the poses after the Sim3 chain
    and the seam pose graph, with and without it, and the refine's
    prior-weight quirk: run_submap_sfm calls refine_submaps_global
    without prior_weight (its default 300) in both."""
    spans, results, rs, ts = _windows()
    frames = np.zeros((16, 4, 4), np.float32)

    def windows(frames, k, config, seed, **kwargs):
        assert kwargs["target_med_px"] == 0.5
        assert kwargs["max_restarts"] == 8
        return results[seed - 10]

    monkeypatch.setattr(sub, "run_incremental_sfm_robust", windows)
    monkeypatch.setattr(jsub, "run_incremental_sfm_robust", windows)
    for pg_iters in (0, 15):
        got = sub.run_submap_sfm(frames, K, submap_frames=8, overlap=3,
                                 seed=10, pose_graph_iterations=pg_iters,
                                 device="cpu")
        ref = jsub.run_submap_sfm(frames, K, submap_frames=8, overlap=3,
                                  seed=10, pose_graph_iterations=pg_iters)
        assert got.spans == ref.spans == spans
        np.testing.assert_allclose(got.rs, ref.rs, **POSE_TOL)
        np.testing.assert_allclose(got.ts, ref.ts, **POSE_TOL)
        np.testing.assert_array_equal(got.points, ref.points)
        assert (got.total_tracks, got.dropped) == (ref.total_tracks,
                                                   ref.dropped)
    assert got.camera_centers.shape == (16, 3)

    spy, jspy = (_Spy(sub.refine_submaps_global),
                 _Spy(jsub.refine_submaps_global))
    monkeypatch.setattr(sub, "refine_submaps_global", spy)
    monkeypatch.setattr(jsub, "refine_submaps_global", jspy)
    sub.run_submap_sfm(frames, K, submap_frames=8, overlap=3, seed=10,
                       global_refine_rounds=1, global_track_capacity=600,
                       device="cpu")
    jsub.run_submap_sfm(frames, K, submap_frames=8, overlap=3, seed=10,
                        global_refine_rounds=1, global_track_capacity=600)
    assert len(spy.calls) == len(jspy.calls) == 1
    assert "prior_weight" not in spy.calls[0]
    assert "prior_weight" not in jspy.calls[0]


@pytest.fixture(scope="module")
def frames_dir(tmp_path_factory):
    """tests/test_keyframes.py's 12-frame 240x320 pan as PNG files."""
    from PIL import Image

    scene = generate_sequence(StarSceneConfig(
        num_frames=12, image_size=(240, 320), focal=260.0, supersample=1))
    path = tmp_path_factory.mktemp("submap_frames")
    for i, frame in enumerate(scene["frames"]):
        Image.fromarray(frame).save(path / f"f{i:02d}.png")
    return path


@pytest.mark.parametrize("loop", [False, True])
def test_run_sfm_cli_submaps(tmp_path, capsys, monkeypatch, frames_dir,
                             loop):
    """``run_sfm --submap-frames 8 --submap-overlap 3`` (spans (0, 8) and
    (5, 12)): the report's submaps entry, nothing dropped, one center a
    frame; with --loop-closure the refine waits for the loop-closed
    trajectory and takes --submap-prior-weight (JAX's quirk: without
    loop closure it keeps the default 300)."""
    spy = _Spy(sub.refine_submaps_global)
    monkeypatch.setattr(sub, "refine_submaps_global", spy)
    traj = tmp_path / "t.json"
    args = [str(frames_dir), "--device", "cpu", "--fx", "260",
            "--submap-frames", "8", "--submap-overlap", "3",
            "--submap-refine", "1", "--submap-prior-weight", "50",
            "--cloud", str(tmp_path / "c.ply"), "--trajectory", str(traj)]
    if loop:
        args += ["--loop-closure", "--loop-mode", "revisit"]
    assert run_sfm.main(args) == 0
    report = json.loads(capsys.readouterr().out.splitlines()[0])
    assert report["submaps"]["spans"] == [[0, 8], [5, 12]]
    assert report["submaps"]["dropped"] == 0
    assert report["submaps"]["total_tracks"] > 0
    assert "quality" not in report and report["final_cost"] is None
    assert report["frames"] == 12 and report["landmarks"] > 0
    assert len(json.loads(traj.read_text())["centers"]) == 12
    assert len(spy.calls) == 1
    if loop:
        assert "loop_closure" in report
        assert spy.calls[0]["prior_weight"] == 50.0
        assert isinstance(spy.calls[0]["loop_links"], list)
    else:
        assert "prior_weight" not in spy.calls[0]
    with pytest.raises(SystemExit):
        run_sfm.main(args + ["--checkpoint", str(tmp_path / "x.npz")])


def test_submap_entry_points_default_to_the_card():
    """Without device='cpu' run_submap_sfm and refine_submaps_global ask
    for CUDA and raise without a card: no quiet fall back to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is valid")
    spans, results, rs, ts = _windows(num_frames=12)
    with pytest.raises(RuntimeError, match="CUDA"):
        sub.run_submap_sfm(np.zeros((12, 8, 8)), K, submap_frames=8,
                           overlap=3)
    with pytest.raises(RuntimeError, match="CUDA"):
        sub.refine_submaps_global(rs, ts, results, spans, K, 12,
                                  capacity=64)
