"""Port parity: keyframing (``select_keyframes``,
``localize_nonkeyframes``, ``run_keyframed_sfm``), ``convert``'s
``sfm_result_from_jax`` and ``run_sfm --keyframe-disp``.

Both packages see the same BRIEF pairs (the JAX package's, carried across
by ``from_jax``), so keyframe selection must give equal lists.
Localization runs on JAX's own map and features, carried across, with
JAX's RANSAC-PnP draws injected (``jax_pnp_samples`` from the key JAX
splits on each rescue): the same path and inlier count for every frame,
poses within 1e-4 (ten f32 LM iterations of motion-only BA in two
reduction orders; measured 2.6e-5).  Where a tighter ``min_pnp_inliers``
sends frames to the rescue, the paths must agree; the rescue's own counts
on those frames (2-17 correspondences of a nearly planar map, where the
six-point DLT is degenerate) are not compared, a frame that falls back
must take its keyframe's pose exactly, and the motion-BA poses after a
fallback (started from the keyframe's pose, not converged in ten
iterations) agree within 1e-3, the tolerance of the PnP stages in
tests/test_torch_sfm.py (measured 1.2e-4).
"""
import dataclasses
import json

import jax
import numpy as np
import pytest
import torch

from _torch_parity import jax_pnp_samples
from _torch_threads import _one_thread  # noqa: F401
from photogrammetry_tpu.sfm import frontend as jfront
from photogrammetry_tpu.sfm import incremental as jinc
from photogrammetry_tpu.sfm import keyframes as jkf
from photogrammetry_tpu.synth.star_scene import (
    StarSceneConfig, generate_sequence,
)
from photogrammetry_tpu_torch.cli import run_sfm
from photogrammetry_tpu_torch.convert import from_jax, sfm_result_from_jax
from photogrammetry_tpu_torch.sfm import keyframes as kf
from photogrammetry_tpu_torch.sfm.frontend import DescribedFrame
from photogrammetry_tpu_torch.sfm.incremental import SfmResult
from photogrammetry_tpu_torch.utils.padding import PaddedPoints

POSE_TOL = dict(rtol=0, atol=1e-4)
RESCUE_POSE_TOL = dict(rtol=0, atol=1e-3)


@pytest.fixture(scope="module")
def pan():
    """tests/test_keyframes.py's 12-frame 240x320 pan (~9 px of median
    motion a frame)."""
    return generate_sequence(StarSceneConfig(
        num_frames=12, image_size=(240, 320), focal=260.0, supersample=1))


@pytest.fixture(scope="module")
def configs():
    """(JAX SfmConfig, its pairs, the port's config and the same pairs)."""
    jcfg = jinc.SfmConfig(collect_diagnostics=False)
    pairs = np.asarray(jfront.make_pairs(jcfg.frontend))
    tpairs, _, cfg = from_jax(pairs, np.eye(3), dataclasses.asdict(jcfg),
                              device="cpu")
    return jcfg, cfg, tpairs


@pytest.fixture
def jax_pairs(monkeypatch, configs):
    """The port's keyframe selection on the JAX package's BRIEF pairs."""
    monkeypatch.setattr(kf, "make_pairs",
                        lambda config, device="cuda": configs[2])


@pytest.fixture(scope="module")
def jax_map(pan, configs):
    """JAX's keyframes at 20 px, its features and its SfM map over them."""
    jcfg = configs[0]
    keyframes, feats = jkf.select_keyframes(pan["frames"], jcfg, 20.0)
    res = jinc.run_incremental_sfm(
        np.stack([pan["frames"][i] for i in keyframes]), pan["k"], jcfg)
    return keyframes, feats, res


def _port_frame(fr) -> DescribedFrame:
    return DescribedFrame(
        points=PaddedPoints(*(torch.tensor(np.asarray(x))
                              for x in fr.points)),
        bits=torch.tensor(np.asarray(fr.bits)),
        xy=torch.tensor(np.asarray(fr.xy)))


@pytest.mark.parametrize("min_disp,want", [(20.0, None), (1e6, [0, 11])])
def test_select_keyframes_matches_jax(pan, configs, jax_pairs, min_disp,
                                      want):
    jcfg, cfg, _ = configs
    ref, jfeats = jkf.select_keyframes(pan["frames"], jcfg, min_disp)
    got, feats = kf.select_keyframes(pan["frames"], cfg, min_disp,
                                     device="cpu")
    assert got == ref
    if want is not None:
        assert got == want
    else:
        assert got[0] == 0 and got[-1] == 11 and 2 < len(got) < 12
    assert len(feats) == 12
    np.testing.assert_array_equal(feats[5].bits.numpy(),
                                  np.asarray(jfeats[5].bits))


def _localize_both(pan, configs, jax_map, monkeypatch, **overrides):
    """localize_nonkeyframes in both packages on JAX's map and features,
    JAX's PnP draws injected into the port."""
    jcfg, cfg, _ = configs
    jcfg = dataclasses.replace(jcfg, **overrides)
    cfg = dataclasses.replace(cfg, **overrides)
    keyframes, jfeats, res = jax_map
    ref = jkf.localize_nonkeyframes(pan["frames"], keyframes, jfeats, res,
                                    pan["k"], jcfg, seed=99)
    key = [jax.random.PRNGKey(99)]

    def draws(generator, mask, num_samples, sample_size=6):
        key[0], sub = jax.random.split(key[0])
        return torch.tensor(jax_pnp_samples(sub, mask.numpy(), num_samples,
                                            sample_size))

    monkeypatch.setattr(kf, "draw_pnp_samples", draws)
    got = kf.localize_nonkeyframes(
        pan["frames"], keyframes, [_port_frame(f) for f in jfeats],
        sfm_result_from_jax(res, device="cpu"), pan["k"], cfg, seed=99,
        device="cpu")
    return keyframes, ref, got


def test_localize_nonkeyframes_matches_jax(pan, configs, jax_map,
                                           monkeypatch):
    keyframes, (jrs, jts, jinfo), (rs, ts, info) = _localize_both(
        pan, configs, jax_map, monkeypatch)
    assert rs.shape == (12, 3, 3) and rs.dtype == np.float32
    assert info == jinfo          # frame, keyframe, path, inlier count
    assert len(info) == 12 - len(keyframes)
    np.testing.assert_allclose(rs, jrs, **POSE_TOL)
    np.testing.assert_allclose(ts, jts, **POSE_TOL)


def test_localize_rescue_paths_match_jax(pan, configs, jax_map,
                                         monkeypatch):
    """min_pnp_inliers 19 sends the low-support frames to the RANSAC-PnP
    rescue (JAX's draws injected) and then to the keyframe fallback."""
    keyframes, (jrs, jts, jinfo), (rs, ts, info) = _localize_both(
        pan, configs, jax_map, monkeypatch, min_pnp_inliers=19)
    assert [i.get("path", "fallback") for i in info] == \
        [i.get("path", "fallback") for i in jinfo]
    falls = [i for i in info if i.get("fallback")]
    assert falls
    for i in falls:
        np.testing.assert_array_equal(rs[i["frame"]], rs[i["keyframe"]])
        np.testing.assert_array_equal(ts[i["frame"]], ts[i["keyframe"]])
    for a, b in zip(info, jinfo):
        if a.get("path") == "motion_ba":
            assert a == b
    np.testing.assert_allclose(rs, jrs, **RESCUE_POSE_TOL)
    np.testing.assert_allclose(ts, jts, **RESCUE_POSE_TOL)


def test_sfm_result_from_jax(jax_map):
    res = jax_map[2]
    res.quality = (120, 0.4)
    got = sfm_result_from_jax(res, device="cpu")
    assert isinstance(got, SfmResult) and got.quality == (120, 0.4)
    np.testing.assert_array_equal(got.rs, np.asarray(res.rs, np.float32))
    np.testing.assert_array_equal(got.points, res.points)
    np.testing.assert_array_equal(got.table.obs.numpy(),
                                  np.asarray(res.table.obs))
    assert got.costs == [float(c) for c in res.costs]
    del res.quality


def test_run_keyframed_sfm_and_cli(tmp_path, capsys, pan):
    """run_keyframed_sfm gives every frame a pose; ``run_sfm
    --keyframe-disp 20 --loop-closure`` on the frames as files reports the
    keyframes and the quality of the keyframe map (its table's rows) and
    writes one center a frame; --checkpoint is refused beside it."""
    rs, ts, keyframes, res, info = kf.run_keyframed_sfm(
        pan["frames"], pan["k"], min_disp_px=20.0, device="cpu")
    assert rs.shape == (12, 3, 3) and np.isfinite(rs).all()
    assert keyframes[0] == 0 and keyframes[-1] == 11
    assert res.table.obs.shape[0] == len(keyframes)
    assert sorted([i["frame"] for i in info] + keyframes) == list(range(12))

    from PIL import Image

    for i, frame in enumerate(pan["frames"]):
        Image.fromarray(frame).save(tmp_path / f"f{i:02d}.png")
    traj = tmp_path / "t.json"
    args = [str(tmp_path), "--device", "cpu", "--fx", "260",
            "--keyframe-disp", "20", "--cloud", str(tmp_path / "c.ply"),
            "--trajectory", str(traj)]
    assert run_sfm.main(args + ["--loop-closure"]) == 0
    report = json.loads(capsys.readouterr().out.splitlines()[0])
    assert report["keyframes"][0] == 0 and report["keyframes"][-1] == 11
    assert report["frames"] == 12 and "quality" in report
    assert report["final_cost"] is not None and "loop_closure" in report
    assert len(json.loads(traj.read_text())["centers"]) == 12
    with pytest.raises(SystemExit):
        run_sfm.main(args + ["--checkpoint", str(tmp_path / "x.npz")])


def test_keyframe_entry_points_default_to_the_card(pan):
    """Without device='cpu' the keyframe entry points ask for CUDA and
    raise without a card: no quiet fall back to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is valid")
    for fn in (kf.select_keyframes, kf.run_keyframed_sfm):
        args = (pan["frames"], pan["k"]) if fn is kf.run_keyframed_sfm \
            else (pan["frames"], kf.SfmConfig())
        with pytest.raises(RuntimeError, match="CUDA"):
            fn(*args)
