"""Port parity: triangulate_nview, metrics, the incremental SfM helpers,
the batched frontend, the whole ``run_incremental_sfm``, the ``run_sfm``
CLI and ``convert``.

Tolerances: ``triangulate_nview``, ``align_umeyama`` and ATE within rtol
1e-4 / atol 1e-5 (f32 eigh/SVD in two LAPACK builds); the JAX-semantics
median exactly; the batched frontend's keypoints and bits exactly and xy
within 1e-4; the track-table helpers' masks exactly and their points
within 1e-4 relative; the PnP stages with the JAX draws injected: the same
decisions and poses within 1e-3.  The whole run is not bitwise comparable
(the port draws its RANSAC samples from a ``torch.Generator``), so
both packages are held to the bounds of tests/test_incremental.py on the
same frames: ATE < 0.2 scene units and > 80 landmarks.
"""
import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import jax_pnp_samples
from _torch_threads import _one_thread  # noqa: F401
from photogrammetry_tpu.sfm import incremental as jinc
from photogrammetry_tpu.sfm import metrics as jmetrics
from photogrammetry_tpu.sfm.frontend import FrontendConfig as JaxConfig
from photogrammetry_tpu.sfm.frontend import make_pairs as jax_make_pairs
from photogrammetry_tpu.sfm.frontend import \
    precompute_frontend as jax_precompute
from photogrammetry_tpu.sfm.triangulate import \
    triangulate_nview as jax_nview
from photogrammetry_tpu.synth.star_scene import (
    StarSceneConfig, generate_sequence,
)
from photogrammetry_tpu_torch.cli import run_sfm
from photogrammetry_tpu_torch.convert import from_jax, state_from_jax
from photogrammetry_tpu_torch.sfm import incremental as inc
from photogrammetry_tpu_torch.sfm import metrics
from photogrammetry_tpu_torch.sfm.frontend import (
    frame_features, precompute_frontend,
)
from photogrammetry_tpu_torch.sfm.tracks import TrackTable
from photogrammetry_tpu_torch.sfm.triangulate import triangulate_nview
from photogrammetry_tpu_torch.utils.reductions import nanmedian
from test_ba import make_problem

TOL = dict(rtol=1e-4, atol=1e-5)


def _t(x):
    return torch.tensor(np.asarray(x))


@pytest.fixture(scope="module")
def pan():
    """The 8-frame 480x640 pan of tests/test_incremental.py."""
    return generate_sequence(StarSceneConfig(num_frames=8, supersample=2))


@pytest.fixture(scope="module")
def table_state():
    """A JAX TrackTable over the noisy star-scene map of test_ba, with
    every track observed where it projects, 4 gross outliers, half the
    tracks pointed; and the true poses."""
    state, prob, rs, ts, _, pts = make_problem(point_noise=0.02)
    rng = np.random.default_rng(7)
    obs = np.array(prob.obs)
    mask = np.array(prob.mask)
    obs[3, :4] += 12.0
    cap = obs.shape[1]
    has = rng.random(cap) > 0.5
    table = jinc.TrackTable(
        obs=jnp.asarray(obs, jnp.float32), obs_mask=jnp.asarray(mask),
        points=state.points, has_point=jnp.asarray(has),
        kp_track=jnp.full((8,), -1, jnp.int32), num_tracks=jnp.int32(cap),
        dropped=jnp.int32(0))
    return (table, jnp.asarray(rs, jnp.float32), jnp.asarray(ts, jnp.float32),
            prob.k)


def test_triangulate_nview_matches_jax(table_state):
    table, rs, ts, k = table_state
    got_p, got_d = triangulate_nview(_t(table.obs), _t(table.obs_mask),
                                     _t(rs), _t(ts), _t(k))
    ref_p, ref_d = jax_nview(table.obs, table.obs_mask, rs, ts, k)
    ok = np.asarray(table.obs_mask).sum(0) >= 2
    np.testing.assert_allclose(got_p.numpy()[ok], np.asarray(ref_p)[ok],
                               **TOL)
    np.testing.assert_allclose(got_d.numpy()[:, ok],
                               np.asarray(ref_d)[:, ok], **TOL)


@pytest.mark.parametrize("with_scale", [True, False])
def test_umeyama_and_ate_match_jax(with_scale):
    rng = np.random.default_rng(3)
    gt = rng.normal(size=(12, 3)).astype(np.float32)
    est = (0.5 * gt @ np.linalg.qr(rng.normal(size=(3, 3)))[0].T + 1.0
           + rng.normal(0, 0.05, gt.shape)).astype(np.float32)
    got = metrics.align_umeyama(_t(est), _t(gt), with_scale)
    ref = jmetrics.align_umeyama(jnp.asarray(est), jnp.asarray(gt),
                                 with_scale)
    for g, r in zip(got, ref):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), **TOL)
    np.testing.assert_allclose(
        float(metrics.absolute_trajectory_error(_t(est), _t(gt), with_scale)),
        float(jmetrics.absolute_trajectory_error(jnp.asarray(est),
                                                 jnp.asarray(gt),
                                                 with_scale)), **TOL)


@pytest.mark.parametrize("values", [
    [3.0, 1.0, 4.0, 2.0],                        # even: mean of 2 and 3
    [5.0, np.nan, 1.0, 2.0, np.nan, 7.0],        # even after the NaNs
    [1.0, np.inf, 2.0, np.inf],                  # even, upper middle inf
    [1.0, np.inf, np.inf],                       # odd, middle inf
    [1.0, 2.0, np.inf],
    [2.5],
    [np.nan, np.nan],                            # no values: NaN
    [0.1, 0.2, 0.3, 0.4, 0.5, 0.6, 0.7, 0.8],
])
def test_nanmedian_has_jax_semantics(values):
    x = np.asarray(values, np.float32)
    got = nanmedian(torch.tensor(x)).numpy()
    ref = np.asarray(jnp.nanmedian(jnp.asarray(x)))
    np.testing.assert_array_equal(got, ref)
    if len(values) == 4 and np.isfinite(values).all():
        assert got == 2.5 and float(torch.nanmedian(torch.tensor(x))) == 2.0


def _port_table(table):
    return state_from_jax(table, device="cpu")


def _same_masks_close_points(got: TrackTable, ref):
    np.testing.assert_array_equal(got.has_point.numpy(),
                                  np.asarray(ref.has_point))
    np.testing.assert_array_equal(got.obs_mask.numpy(),
                                  np.asarray(ref.obs_mask))
    np.testing.assert_allclose(got.points.numpy(), np.asarray(ref.points),
                               rtol=1e-4, atol=1e-4)


def test_triangulation_helpers_match_jax(table_state):
    table, rs, ts, k = table_state
    pt = _port_table(table)
    args = (_t(rs), _t(ts), _t(k), 1e-3, 1e3)
    _same_masks_close_points(
        inc._triangulate_tracks_nview(pt, *args),
        jinc._triangulate_tracks_nview(table, rs, ts, k, 1e-3, 1e3))
    _same_masks_close_points(
        inc._retriangulate_all(pt, *args),
        jinc._retriangulate_all(table, rs, ts, k, 1e-3, 1e3))
    first, last = jinc.first_last_observations(table)
    _same_masks_close_points(
        inc._triangulate_tracks(pt, *args[:3], _t(first), _t(last),
                                1e-3, 1e3),
        jinc._triangulate_tracks(table, rs, ts, k, first, last, 1e-3, 1e3))


def test_gauge_and_prune_match_jax(table_state):
    table, rs, ts, k = table_state
    pt = _port_table(table)
    ts2 = np.asarray(ts) * 1.7            # a baseline to rescale
    got = inc._rescale_gauge(_t(rs), _t(ts2), pt)
    ref = jinc._rescale_gauge(rs, jnp.asarray(ts2), table)
    np.testing.assert_allclose(got[1].numpy(), np.asarray(ref[1]), **TOL)
    np.testing.assert_allclose(got[2].points.numpy(),
                               np.asarray(ref[2].points), rtol=1e-4,
                               atol=1e-4)
    got = inc._prune_observations(pt, _t(rs), _t(ts), _t(k), 3.0)
    ref = jinc._prune_observations(table, rs, ts, k, 3.0)
    _same_masks_close_points(got, ref)
    assert not got.obs_mask[3, :4][got.has_point[:4]].any()


@pytest.mark.parametrize("prior_off", [0.0, 0.08])
def test_pnp_stages_with_jax_draws(table_state, prior_off):
    """_pnp_rescue_device: a good prior is kept, a bad one (0.08 rad off,
    tens of px) is rescued by PnP; _pnp_init_device takes PnP whenever the
    support suffices.  JAX draws from split(key)[1] in both."""
    table, rs, ts, k = table_state
    f = 5
    pnp_mask = np.asarray(table.obs_mask[f] & table.has_point)
    c, s = np.cos(prior_off), np.sin(prior_off)
    turn = np.array([[c, 0, s], [0, 1, 0], [-s, 0, c]], np.float32)
    r_prior = turn @ np.asarray(rs[f])
    key = jax.random.PRNGKey(3)
    idx = jax_pnp_samples(jax.random.split(key)[1], pnp_mask, 64)
    args = (table.points, table.obs[f], jnp.asarray(pnp_mask), k,
            jnp.asarray(r_prior), ts[f])
    _, jr, jt, jdiag = jinc._pnp_rescue_device(
        key, *args, min_inliers=6, rescue_px=16.0, threshold=4.0,
        num_samples=64)
    r, t, diag = inc._pnp_rescue_device(
        _t(idx), *(_t(a) for a in args), min_inliers=6, rescue_px=16.0,
        threshold=4.0)
    for g, ref in zip(diag[:3], jdiag[:3]):
        assert bool(g) == bool(ref) if g.dtype == torch.bool \
            else int(g) == int(ref)
    np.testing.assert_allclose(float(diag[3]), float(jdiag[3]), rtol=1e-4)
    assert bool(diag[0]) == (prior_off > 0)
    np.testing.assert_allclose(r.numpy(), np.asarray(jr), atol=1e-3)
    np.testing.assert_allclose(t.numpy(), np.asarray(jt), atol=1e-3)

    _, jr, jt = jinc._pnp_init_device(key, *args, min_inliers=6,
                                      threshold=4.0, num_samples=64)
    r, t = inc._pnp_init_device(_t(idx), *(_t(a) for a in args),
                                min_inliers=6, threshold=4.0)
    np.testing.assert_allclose(r.numpy(), np.asarray(jr), atol=1e-3)
    np.testing.assert_allclose(t.numpy(), np.asarray(jt), atol=1e-3)


def test_precompute_frontend_matches_jax():
    scene = generate_sequence(StarSceneConfig(num_frames=5,
                                              image_size=(120, 160),
                                              focal=130.0))
    jcfg = JaxConfig(detection_threshold=20.0, max_keypoints=96,
                     reduction="nms", suppression_radius=4.0,
                     hamming_threshold=80)
    pairs_np = np.asarray(jax_make_pairs(jcfg))
    pairs, _, cfg = from_jax(pairs_np, np.eye(3), dataclasses.asdict(jcfg),
                             device="cpu")
    frames = scene["frames"].astype(np.float32)
    ref = jax_precompute(jnp.asarray(frames), pairs_np, jcfg, chunk=2)
    got = precompute_frontend(torch.tensor(frames), pairs, cfg, chunk=2)
    for name in ("coords", "score", "mask", "count"):
        np.testing.assert_array_equal(getattr(got.points, name).numpy(),
                                      np.asarray(getattr(ref.points, name)),
                                      name)
    np.testing.assert_array_equal(got.bits.numpy(), np.asarray(ref.bits))
    np.testing.assert_allclose(got.xy.numpy(), np.asarray(ref.xy), rtol=0,
                               atol=1e-4)
    assert got.bits.shape[0] == 5 and int(got.points.count.min()) > 10
    one = frame_features(got, 3)
    assert torch.equal(one.bits, got.bits[3])
    assert torch.equal(one.points.count, got.points.count[3])
    # the pyramid (tests/test_torch_pyramid.py holds it in full)
    two = precompute_frontend(torch.tensor(frames), pairs, cfg, chunk=2,
                              octaves=2)
    ref2 = jax_precompute(jnp.asarray(frames), pairs_np, jcfg, chunk=2,
                          octaves=2)
    assert two.bits.shape[:2] == (5, 2 * jcfg.max_keypoints)
    np.testing.assert_array_equal(two.bits.numpy(), np.asarray(ref2.bits))


def _ate(centers, gt):
    return float(metrics.absolute_trajectory_error(
        torch.tensor(centers, dtype=torch.float32),
        torch.tensor(gt, dtype=torch.float32)))


def test_run_incremental_sfm_beside_jax(pan):
    """The whole run on the 8-frame pan: both packages within the bounds
    of tests/test_incremental.py::test_incremental_sfm_ate, and the port's
    reconstruction_quality equal to JAX's on JAX's own result."""
    frames, k, gt = pan["frames"], pan["k"], pan["centers"]
    cfg = inc.SfmConfig(collect_diagnostics=False)
    res = inc.run_incremental_sfm(frames, k, cfg, seed=0, device="cpu")
    ref = jinc.run_incremental_sfm(frames, k,
                                   jinc.SfmConfig(collect_diagnostics=False))
    for r in (res, ref):
        assert _ate(r.camera_centers, gt) < 0.2
        assert len(r.points) > 80
    assert np.isfinite(res.points).all()
    assert res.rs.shape == (8, 3, 3) and len(res.costs) == 8 - 3 + 3
    boot = [i for i in res.frame_info if i["pose_init"] == "bootstrap"]
    assert len(boot) == 1 and boot[0]["bootstrap_support"] > 0

    ref_port = inc.SfmResult(ref.rs, ref.ts, state_from_jax(ref.table,
                                                            device="cpu"),
                             ref.costs)
    support, med = inc.reconstruction_quality(ref_port, k)
    j_support, j_med = jinc.reconstruction_quality(ref, k)
    assert support == j_support
    np.testing.assert_allclose(med, j_med, rtol=1e-4)
    # export=False: the device-side handle, read back by export_sfm_result
    dres = inc.run_incremental_sfm(
        frames, k, dataclasses.replace(cfg, read_free=True), export=False,
        device="cpu")
    assert isinstance(dres, inc.DeviceSfmResult)
    assert isinstance(dres.rs, torch.Tensor)
    assert isinstance(inc.export_sfm_result(dres), inc.SfmResult)


def test_robust_picks_best_restart(pan):
    """run_incremental_sfm_robust returns the restart that
    reconstruction_quality ranks first (a cut-down config: the selection,
    not the accuracy, is under test here)."""
    frames, k = pan["frames"], pan["k"]
    cfg = inc.SfmConfig(collect_diagnostics=False, ba_iterations=10,
                        final_ba_iterations=10, final_refine_rounds=0)
    best = inc.run_incremental_sfm_robust(frames, k, cfg, seed=1,
                                          restarts=2, device="cpu")
    quals = [inc.reconstruction_quality(
        inc.run_incremental_sfm(frames, k, cfg, seed=1 + 7919 * i,
                                device="cpu"), k) for i in range(2)]
    smax = max(q[0] for q in quals)
    want = min((q for q in quals if q[0] >= 0.95 * smax), key=lambda q: q[1])
    assert best.quality == want


def test_run_sfm_cli_synthetic(tmp_path, capsys):
    cloud, traj = tmp_path / "cloud.ply", tmp_path / "traj.json"
    stats = tmp_path / "stats.json"
    assert run_sfm.main(["--device", "cpu", "--synthetic-frames", "8",
                         "--restarts", "3", "--cloud", str(cloud),
                         "--trajectory", str(traj),
                         "--stats", str(stats)]) == 0
    report = json.loads(capsys.readouterr().out.splitlines()[0])
    assert report["frames"] == 8 and report["ate"] < 0.2
    assert report["landmarks"] > 80 and report["quality"]["support"] > 80
    header = cloud.read_text().splitlines()
    assert f"element vertex {report['landmarks']}" in header
    assert len(json.loads(traj.read_text())["centers"]) == 8
    records = json.loads(stats.read_text())
    assert len(records) == 1
    # the run recorded under --stats: three sequences, their stages
    spans, counters = records[0]["spans"], records[0]["counters"]
    assert spans["sfm.sequence"]["calls"] == 3
    for name in ("sfm.frontend", "sfm.track", "sfm.bootstrap",
                 "sfm.localize", "sfm.map", "sfm.final_ba", "ba.solve"):
        assert spans[name]["calls"] >= 1 and spans[name]["total_s"] > 0
    assert 0 < counters["ba.lm_accepted"] <= counters["ba.lm_iterations"]


def test_run_sfm_cli_frames_dir_and_unported_flags(tmp_path, pan):
    from PIL import Image

    for i, frame in enumerate(pan["frames"][:5]):
        Image.fromarray(np.stack([frame] * 3, -1)).save(
            tmp_path / f"f{i:02d}.png")
    cloud = tmp_path / "c.ply"
    assert run_sfm.main([str(tmp_path), "--device", "cpu", "--fx", "520",
                         "--cloud", str(cloud), "--trajectory",
                         str(tmp_path / "t.json")]) == 0
    assert cloud.exists()
    gray = run_sfm.load_gray(str(tmp_path / "f00.png"))
    np.testing.assert_array_equal(gray, pan["frames"][0].astype(np.float32))
    # every flag of the JAX CLI is ported: an unknown one is argparse's
    # error, as is a value given to the --precompute-matching switch
    for flag in (["--precompute-matching=1"], ["--no-such-flag"]):
        with pytest.raises(SystemExit):
            run_sfm.main(["--device", "cpu", *flag])


def test_run_sfm_cli_with_dewarp(tmp_path, capsys):
    """--distortion-coeffs puts the dewarp stage in front of the SfM run, as
    tests/test_run_sfm_cli.py::test_run_sfm_with_dewarp runs it for the JAX
    CLI: small but nonzero coefficients, so the stage really resamples and
    the map lands in the cache while the geometry stays close to pinhole."""
    from PIL import Image

    scene = generate_sequence(StarSceneConfig(
        num_frames=5, image_size=(240, 320), focal=260.0, supersample=2))
    frames_dir = tmp_path / "frames"
    frames_dir.mkdir()
    for i, frame in enumerate(scene["frames"]):
        Image.fromarray(frame).save(frames_dir / f"{i:03d}.png")
    traj, cloud = tmp_path / "traj.json", tmp_path / "cloud.ply"
    argv = [str(frames_dir), "--device", "cpu", "--fx", "260", "--cx", "160",
            "--cy", "120", "--detection-threshold", "20", "--trajectory",
            str(traj), "--cloud", str(cloud)]
    assert run_sfm.main(argv + ["--distortion-coeffs", "1e-5", "0", "0", "0",
                                "0", "--dewarp-cache",
                                str(tmp_path / "maps")]) == 0
    report = json.loads(capsys.readouterr().out.splitlines()[0])
    assert report["frames"] == 5 and "dewarp" in report["timings"]
    assert cloud.is_file()
    centers = np.asarray(json.loads(traj.read_text())["centers"])
    assert centers.shape == (5, 3) and np.isfinite(centers).all()
    assert [p.name for p in (tmp_path / "maps").iterdir()] == [
        "dim_320x240_coeff_1e-05_0.0_0.0_0.0_0.0.npz"]
    # trajectory moved: the pan spans ~2.4 units of camera travel
    assert np.linalg.norm(centers[-1] - centers[0]) > 0.1

    # the stage itself: one stacked remap, the result on the device
    out = run_sfm.dewarp_frames(scene["frames"], [1e-5, 0, 0, 0, 0],
                                str(tmp_path / "maps"), "cpu")
    assert out.dtype == torch.float32 and out.shape == (5, 240, 320)
    assert float((out - torch.tensor(scene["frames"])).abs().max()) > 1
    # all-zero coefficients skip the stage
    assert run_sfm.main(argv + ["--distortion-coeffs", "0", "0", "0", "0",
                                "0", "--dewarp-cache",
                                str(tmp_path / "none")]) == 0
    report = json.loads(capsys.readouterr().out.splitlines()[0])
    assert "dewarp" not in report["timings"]
    assert not (tmp_path / "none").exists()


def test_run_incremental_sfm_takes_frames_on_the_device(pan):
    """Frames that are already a tensor on the device (the dewarp stage's
    output) go in as they are and give the numpy run's result."""
    frames, k = pan["frames"][:5], pan["k"]
    cfg = inc.SfmConfig(collect_diagnostics=False, ba_iterations=10,
                        final_ba_iterations=10, final_refine_rounds=0)
    ref = inc.run_incremental_sfm(frames, k, cfg, seed=2, device="cpu")
    as_float = torch.tensor(frames, dtype=torch.float32)
    for given in (as_float, torch.tensor(frames)):      # float32, uint8
        res = inc.run_incremental_sfm(given, k, cfg, seed=2, device="cpu")
        np.testing.assert_array_equal(res.rs, ref.rs)
        np.testing.assert_array_equal(res.ts, ref.ts)
        np.testing.assert_array_equal(res.points, ref.points)
    best = inc.run_incremental_sfm_robust(as_float, k, cfg, seed=2,
                                          restarts=1, device="cpu")
    np.testing.assert_array_equal(best.rs, ref.rs)


def test_convert_carries_config_and_state(table_state):
    d = dataclasses.asdict(jinc.SfmConfig())
    pairs = np.zeros((4, 2, 2), np.int32)
    _, _, cfg = from_jax(pairs, np.eye(3), d, device="cpu")
    assert cfg == inc.SfmConfig()
    d2 = dataclasses.asdict(jinc.SfmConfig(window=5, ba_iterations=7,
                                           fused_steady_steps=False))
    assert from_jax(pairs, np.eye(3), d2, device="cpu")[2].window == 5
    got = from_jax(pairs, np.eye(3), {**d, "read_free": True,
                                      "fused_steady_steps": True},
                   device="cpu")[2]
    assert got.read_free and got.fused_steady_steps
    table = table_state[0]
    got = state_from_jax(table, device="cpu")
    assert isinstance(got, TrackTable)
    for name in TrackTable._fields:
        a, b = getattr(got, name), np.asarray(getattr(table, name))
        assert a.dtype == torch.from_numpy(b.copy()).dtype
        np.testing.assert_array_equal(a.numpy(), b)
    with pytest.raises(TypeError):
        state_from_jax((1, 2), device="cpu")
