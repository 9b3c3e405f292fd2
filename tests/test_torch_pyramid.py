"""Port parity: the pyramid frontend (``_downsample2``,
``detect_and_describe_pyramid``, its batch form, ``precompute_frontend``
with octaves), ``SfmConfig.pyramid_octaves`` through a whole SfM run,
``convert`` carrying it, and ``run_sfm --pyramid-octaves``.

Tolerances: the downsample, keypoint coordinates, scores, masks, counts
and bits exactly (the same pixels, the same integer arithmetic; the
octave-0 coordinates rounded half to even in both); xy within 1e-4 px at
octave 0 and 1e-4 * 2^o px at octave o (the subpixel refine's f32
arithmetic, held to 1e-4 px by tests/test_torch_sfm.py on the
single-scale frontend, runs on the octave's pixels, each 2^o octave-0
pixels wide).  The whole run is not bitwise comparable (the port draws
from a ``torch.Generator``), so both packages are held to the bounds of
tests/test_incremental.py on the same frames: ATE < 0.2 and > 80
landmarks.
"""
import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_threads import _one_thread  # noqa: F401
from photogrammetry_tpu.sfm import frontend as jfront
from photogrammetry_tpu.sfm import incremental as jinc
from photogrammetry_tpu.synth.star_scene import (
    StarSceneConfig, generate_sequence,
)
from photogrammetry_tpu_torch.cli import run_sfm
from photogrammetry_tpu_torch.convert import from_jax
from photogrammetry_tpu_torch.sfm import frontend
from photogrammetry_tpu_torch.sfm import incremental as inc
from photogrammetry_tpu_torch.sfm.metrics import trajectory_ate

JCFG = jfront.FrontendConfig(detection_threshold=20.0, max_keypoints=256,
                             reduction="nms", suppression_radius=4.0,
                             hamming_threshold=80)
XY_TOL = 1e-4      # px at octave o, times 2^o in octave-0 pixels


@pytest.fixture(scope="module")
def small_pan():
    """tests/test_keyframes.py's 12-frame 240x320 pan."""
    return generate_sequence(StarSceneConfig(
        num_frames=12, image_size=(240, 320), focal=260.0, supersample=1))


@pytest.fixture(scope="module")
def carried():
    """The JAX frontend's pairs and config, carried into the port."""
    pairs = np.asarray(jfront.make_pairs(JCFG))
    tpairs, _, cfg = from_jax(pairs, np.eye(3), dataclasses.asdict(JCFG),
                              device="cpu")
    return pairs, tpairs, cfg


def _assert_same_features(got, ref):
    for name in ("coords", "score", "mask", "count"):
        np.testing.assert_array_equal(getattr(got.points, name).numpy(),
                                      np.asarray(getattr(ref.points, name)),
                                      name)
    np.testing.assert_array_equal(got.bits.numpy(), np.asarray(ref.bits))
    # slot j of the merged keypoint axis belongs to octave j // K
    octave = np.arange(got.xy.shape[-2]) // JCFG.max_keypoints
    err = np.abs(got.xy.numpy() - np.asarray(ref.xy)).max(-1)
    assert (err <= XY_TOL * 2.0 ** octave).all(), err.max()


@pytest.mark.parametrize("shape", [(37, 53), (240, 320), (3, 21, 30),
                                   (2, 1, 9)])
def test_downsample2_exact(shape):
    """Odd sizes crop the last row/column; a batch goes through at once
    (JAX vmaps the single-frame function)."""
    rng = np.random.default_rng(sum(shape))
    img = (rng.random(shape) * 255).astype(np.float32)
    got = frontend._downsample2(torch.tensor(img)).numpy()
    if len(shape) == 2:
        ref = jfront._downsample2(jnp.asarray(img))
    else:
        ref = jax.vmap(jfront._downsample2)(jnp.asarray(img))
    assert got.shape == ref.shape
    np.testing.assert_array_equal(got, np.asarray(ref))


@pytest.mark.parametrize("octaves", [2, 3])
def test_detect_and_describe_pyramid_matches_jax(small_pan, carried,
                                                 octaves):
    pairs, tpairs, cfg = carried
    frame = small_pan["frames"][4].astype(np.float32)
    ref = jfront.detect_and_describe_pyramid(jnp.asarray(frame), pairs,
                                             JCFG, octaves=octaves)
    got = frontend.detect_and_describe_pyramid(torch.tensor(frame), tpairs,
                                               cfg, octaves=octaves)
    assert got.bits.shape[0] == octaves * JCFG.max_keypoints
    _assert_same_features(got, ref)
    # the coarse octaves found keypoints, mapped into octave-0 pixels
    second = got.points.mask[JCFG.max_keypoints:2 * JCFG.max_keypoints]
    assert int(second.sum()) > 10
    assert int(got.points.coords.max()) < 320


@pytest.mark.parametrize("octaves,chunk", [(2, 5), (3, 16)])
def test_batch_pyramid_and_precompute_match_jax(small_pan, carried, octaves,
                                                chunk):
    """The batch form on 5 frames, and precompute_frontend over all 12 in
    chunks (a ragged tail at chunk 5)."""
    pairs, tpairs, cfg = carried
    frames = small_pan["frames"].astype(np.float32)
    ref = jfront.detect_and_describe_batch_pyramid(
        jnp.asarray(frames[:5]), pairs, JCFG, octaves)
    got = frontend.detect_and_describe_batch_pyramid(
        torch.tensor(frames[:5]), tpairs, cfg, octaves)
    _assert_same_features(got, ref)
    ref = jfront.precompute_frontend(jnp.asarray(frames), pairs, JCFG,
                                     chunk=chunk, octaves=octaves)
    got = frontend.precompute_frontend(torch.tensor(frames), tpairs, cfg,
                                       chunk=chunk, octaves=octaves)
    assert got.bits.shape[:2] == (12, octaves * JCFG.max_keypoints)
    _assert_same_features(got, ref)


def test_pyramid_sfm_beside_jax():
    """A pyramid_octaves=2 run of the 8-frame 480x640 pan (the run of
    tests/test_torch_sfm.py::test_run_incremental_sfm_beside_jax, with
    tests/test_pyramid_sfm.py's track capacity 2048): both packages within
    the bounds, the table sized octaves x max_keypoints."""
    pan = generate_sequence(StarSceneConfig(num_frames=8, supersample=2))
    frames, k, gt = pan["frames"], pan["k"], pan["centers"]
    cfg = inc.SfmConfig(collect_diagnostics=False, pyramid_octaves=2,
                        track_capacity=2048)
    res = inc.run_incremental_sfm(frames, k, cfg, seed=0, device="cpu")
    ref = jinc.run_incremental_sfm(frames, k, jinc.SfmConfig(
        collect_diagnostics=False, pyramid_octaves=2, track_capacity=2048))
    for r in (res, ref):
        assert trajectory_ate(np.asarray(r.rs), np.asarray(r.ts), gt) < 0.2
        assert len(r.points) > 80
    assert res.table.kp_track.shape == (2 * cfg.frontend.max_keypoints,)
    assert res.table.obs.shape == (8, 2048, 2)


def test_convert_carries_pyramid_octaves():
    d = dataclasses.asdict(jinc.SfmConfig(pyramid_octaves=3,
                                          track_capacity=3072))
    _, _, cfg = from_jax(np.zeros((4, 2, 2), np.int32), np.eye(3), d,
                         device="cpu")
    assert cfg.pyramid_octaves == 3 and cfg.track_capacity == 3072
    _, _, cfg = from_jax(np.zeros((4, 2, 2), np.int32), np.eye(3),
                         {**d, "precompute_matching": True}, device="cpu")
    assert cfg.pyramid_octaves == 3 and cfg.precompute_matching is True


def test_run_sfm_cli_pyramid(tmp_path, capsys, small_pan):
    """``--pyramid-octaves 2`` on a frames directory: one pose a frame,
    the report's landmarks in the cloud."""
    from PIL import Image

    for i, frame in enumerate(small_pan["frames"][:6]):
        Image.fromarray(frame).save(tmp_path / f"f{i:02d}.png")
    cloud, traj = tmp_path / "c.ply", tmp_path / "t.json"
    assert run_sfm.main([str(tmp_path), "--device", "cpu", "--fx", "260",
                         "--pyramid-octaves", "2", "--cloud", str(cloud),
                         "--trajectory", str(traj)]) == 0
    report = json.loads(capsys.readouterr().out.splitlines()[0])
    assert report["frames"] == 6 and report["landmarks"] > 0
    assert "quality" in report
    assert len(json.loads(traj.read_text())["centers"]) == 6
    assert f"element vertex {report['landmarks']}" in \
        cloud.read_text().splitlines()
