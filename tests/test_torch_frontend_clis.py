"""Port parity: the frontend CLIs — ``detect_features``,
``cluster_features`` (grid and ``--exact``), ``match_keypoints``,
``estimate_pose`` and ``image_editing`` — run beside the JAX package's
CLIs on frames 0 and 2 of the 480x640 star pan, written as PNG files.

Exact: the keypoints (through each CLI's keypoint cache or overlay), the
cluster centres, the keypoint and match counts and the match indices,
the shifted image.  ``estimate_pose`` draws its RANSAC samples from a
``torch.Generator``; here JAX's draws from ``PRNGKey(0)`` are injected,
and the inlier counts must agree within INLIER_SHARE, the poses within
1e-3 rad where the counts are equal, and both within 5 degrees of the
truth.  Every port CLI raises without a card unless given ``--device
cpu``.
"""
import dataclasses
import json

import jax
import numpy as np
import pytest
import torch

from _torch_parity import jax_sample_idx
from _torch_threads import _one_thread  # noqa: F401
from photogrammetry_tpu.cli import cluster_features as jcluster_cli
from photogrammetry_tpu.cli import detect_features as jdetect_cli
from photogrammetry_tpu.cli import estimate_pose as jpose_cli
from photogrammetry_tpu.cli import image_editing as jedit_cli
from photogrammetry_tpu.cli import match_keypoints as jmatch_cli
from photogrammetry_tpu.ops import cluster as jcluster
from photogrammetry_tpu.ops.fast import extract_keypoints as jax_extract
from photogrammetry_tpu.ops.fast import fast_score_map as jax_fast
from photogrammetry_tpu.sfm import frontend as jfront
from photogrammetry_tpu.store.cache import KeypointCache as JaxCache
from photogrammetry_tpu.synth.star_scene import (
    StarSceneConfig, intrinsics, pan_trajectory, render_frame,
)
from photogrammetry_tpu_torch.cli import (
    cluster_features, detect_features, estimate_pose, image_editing,
    match_keypoints,
)
from photogrammetry_tpu_torch.io.image import read_image
from photogrammetry_tpu_torch.sfm import two_view
from photogrammetry_tpu_torch.sfm.frontend import FrontendConfig, make_pairs
from photogrammetry_tpu_torch.store.cache import KeypointCache

CPU = ["--device", "cpu"]
# estimate_pose, port against JAX on the same RANSAC samples (the CLI's
# 2000): the f32 eight-point fits of minimal samples are ill-conditioned
# in both packages, so near-best hypotheses' consensus counts can differ
# by a few correspondences, and another of them wins.  JAX's own counts
# for one sample set differ by 2 between two of its compilations (the
# hypotheses scored one by one under vmap against ransac_fundamental's
# jit: best 96 against 98).  Where the counts agree the poses agree within
# 1e-3 rad; where they do not (the pyramid case: 198 against 197, poses
# 0.0069 rad apart), both poses are held to the ground truth instead.
INLIER_SHARE = 0.05


@pytest.fixture(scope="module")
def images(tmp_path_factory):
    """Frames 0 and 2 of the default 480x640 pan as RGB PNG files, and
    the true rotation between them."""
    from PIL import Image

    out = tmp_path_factory.mktemp("frames")
    cfg = StarSceneConfig(num_frames=12)
    rs, ts, _ = pan_trajectory(cfg)
    paths = []
    for i in (0, 2):
        frame = render_frame(cfg, rs[i], ts[i], intrinsics(cfg))
        paths.append(str(out / f"f{i}.png"))
        Image.fromarray(np.stack([frame] * 3, -1)).save(paths[-1])
    return paths, rs[2] @ rs[0].T


def _run(main, argv, capsys):
    assert main(argv) == 0
    return capsys.readouterr().out.splitlines()


def _counts(line):
    """The numbers of a CLI's first line, before its timings."""
    return line.split("{")[0].split()


def test_detect_features_equals_jax(images, tmp_path, capsys):
    (img, _), _ = images
    jcache, pcache = tmp_path / "jc", tmp_path / "pc"
    jout = _run(jdetect_cli.main, [img, "-o", str(tmp_path / "j.png"),
                                   "--cache-dir", str(jcache)], capsys)
    pout = _run(detect_features.main, [img, "-o", str(tmp_path / "p.png"),
                                       "--cache-dir", str(pcache), *CPU],
                capsys)
    assert _counts(pout[0]) == _counts(jout[0])
    ref = JaxCache(str(jcache)).get(img, threshold=50.0)["coords"]
    got = KeypointCache(str(pcache)).get(img, threshold=50.0)["coords"]
    np.testing.assert_array_equal(got, ref)
    assert len(got) > 100
    np.testing.assert_array_equal(read_image(str(tmp_path / "p.png")),
                                  read_image(str(tmp_path / "j.png")))
    # a second run reads the cache
    again = _run(detect_features.main, [img, "-o", str(tmp_path / "q.png"),
                                        "--cache-dir", str(pcache), *CPU],
                 capsys)
    assert _counts(again[0]) == _counts(pout[0])


@pytest.mark.parametrize("exact,thr", [(False, 50.0), (True, 90.0)])
def test_cluster_features_equals_jax(images, tmp_path, capsys, exact, thr):
    """The grid clustering at the CLI's default threshold; the exact one,
    whose host loop (the JAX package's copy: ~7 s at this frame's 2,400
    detections) runs twice here, at a higher threshold."""
    (img, _), _ = images
    flag = (["--exact"] if exact else []) + ["--threshold", str(thr)]
    jout = _run(jcluster_cli.main, [img, "-o", str(tmp_path / "j.png"),
                                    *flag], capsys)
    pout = _run(cluster_features.main, [img, "-o", str(tmp_path / "p.png"),
                                        *flag, *CPU], capsys)
    assert _counts(pout[0]) == _counts(jout[0])
    np.testing.assert_array_equal(read_image(str(tmp_path / "p.png")),
                                  read_image(str(tmp_path / "j.png")))
    # the centres themselves, in order
    from photogrammetry_tpu_torch.cli.common import load_gray

    g = load_gray(img)
    pts = cluster_features.detect_all(torch.from_numpy(g), thr)
    got = cluster_features.cluster(pts, *g.shape, 25.0, (4, 4), exact)
    jpts = jax_extract(jax_fast(g, thr), capacity=65536)
    raw = int(jpts.count)
    if exact:
        ref = jcluster.hierarchical_cluster_exact(
            np.asarray(jpts.coords)[np.asarray(jpts.mask)], 25.0)
    else:
        out = jcluster.grid_cluster_keypoints(
            jpts, *g.shape, max_merge_dist=25.0, chunks=(4, 4),
            chunk_capacity=max(raw // 16 * 2, 256))
        ref = np.asarray(out.coords)[np.asarray(out.mask)]
    np.testing.assert_array_equal(got, ref)
    assert raw > 2 * len(ref) > 0


def test_match_keypoints_equals_jax(images, tmp_path, capsys):
    """The default (cluster) reduction: counts on the CLI's line, and the
    features and matches of its frontend."""
    (img1, img2), _ = images
    jout = _run(jmatch_cli.main, [img1, img2, "-o", str(tmp_path / "j.png")],
                capsys)
    pout = _run(match_keypoints.main, [img1, img2, "-o",
                                       str(tmp_path / "p.png"), *CPU],
                capsys)
    assert _counts(pout[0]) == _counts(jout[0])
    assert int(_counts(pout[0])[4]) >= 20
    combined = read_image(str(tmp_path / "p.png"))
    assert combined.shape == (480, 1280, 3)

    from photogrammetry_tpu_torch.cli.common import load_gray

    g1, g2 = load_gray(img1), load_gray(img2)
    jcfg = jfront.FrontendConfig(reduction="cluster")
    pairs = jfront.make_pairs(jcfg)
    r1 = jfront.detect_and_describe_split(g1, pairs, jcfg)
    r2 = jfront.detect_and_describe_split(g2, pairs, jcfg)
    rm = jfront.match_pair(r1, r2, jcfg)
    cfg = FrontendConfig(reduction="cluster")
    f1, f2, m = match_keypoints.match_images(
        torch.from_numpy(g1), torch.from_numpy(g2),
        make_pairs(cfg, device="cpu"), cfg)
    for got, ref in ((f1, r1), (f2, r2)):
        for name in ("coords", "mask", "count"):
            np.testing.assert_array_equal(
                getattr(got.points, name).numpy(),
                np.asarray(getattr(ref.points, name)), name)
        np.testing.assert_array_equal(got.bits.numpy(), np.asarray(ref.bits))
    for name in ("idx2", "dist", "mask", "num"):
        np.testing.assert_array_equal(getattr(m, name).numpy(),
                                      np.asarray(getattr(rm, name)), name)


def _inject_jax_draws(monkeypatch):
    """The port's estimate_pose on JAX's RANSAC draws (PRNGKey(0),
    model='fundamental')."""
    def pipeline(generator, xy1, xy2, mask, k, threshold=1.0,
                 num_samples=2000, model="auto", **kw):
        assert model == "fundamental"
        f_idx = jax_sample_idx(jax.random.PRNGKey(0), mask.numpy(),
                               num_samples, 8)
        return two_view.two_view_from_samples(torch.tensor(f_idx), None,
                                              xy1, xy2, mask, k,
                                              threshold=threshold)

    monkeypatch.setattr(two_view, "two_view_pipeline", pipeline)


def _angle(r1, r2):
    c = (np.trace(np.asarray(r1) @ np.asarray(r2).T) - 1) / 2
    return float(np.arccos(np.clip(c, -1, 1)))


@pytest.mark.parametrize("flags", [["--reduction", "nms", "--motion-filter"],
                                   ["--reduction", "anms"],
                                   ["--pyramid-octaves", "2"]],
                         ids=["nms-motion", "anms", "pyramid2"])
def test_estimate_pose_equals_jax(images, tmp_path, capsys, monkeypatch,
                                  flags):
    (img1, img2), r_gt = images
    common = [img1, img2, "--fx", "520"]
    jout = _run(jpose_cli.main, [*common, *flags, "--cloud",
                                 str(tmp_path / "j.ply")], capsys)
    _inject_jax_draws(monkeypatch)
    stats = tmp_path / "stats.json"
    pout = _run(estimate_pose.main, [*common, *flags, "--cloud",
                                     str(tmp_path / "p.ply"), "--plots",
                                     str(tmp_path / "p"), "--stats",
                                     str(stats), *CPU], capsys)
    ref, got = json.loads(jout[0]), json.loads(pout[0])
    assert got["keypoints"] == ref["keypoints"]
    assert got["matches"] == ref["matches"]
    assert abs(got["inliers"] - ref["inliers"]) <= INLIER_SHARE * \
        ref["inliers"]
    if got["inliers"] == ref["inliers"]:
        assert _angle(got["rotation"], ref["rotation"]) < 1e-3
    for rot in (got["rotation"], ref["rotation"]):
        assert _angle(rot, r_gt) < np.radians(5.0)
    assert got["matches"] >= 30 and got["points"] > 10
    assert f"element vertex {got['points']}" in \
        (tmp_path / "p.ply").read_text()
    assert (tmp_path / "p_xz.png").exists()
    assert len(json.loads(stats.read_text())) == 1


def test_image_editing_equals_jax(images, tmp_path, capsys):
    (img, _), _ = images
    for sx, sy in ((150, 0), (-40, 25)):
        args = [img, "--shift-x", str(sx), "--shift-y", str(sy)]
        _run(jedit_cli.main, [*args, "-o", str(tmp_path / "j.png")], capsys)
        _run(image_editing.main, [*args, "-o", str(tmp_path / "p.png"),
                                  *CPU], capsys)
        np.testing.assert_array_equal(read_image(str(tmp_path / "p.png")),
                                      read_image(str(tmp_path / "j.png")))


@pytest.mark.parametrize("cli,nargs", [
    (detect_features, 1), (cluster_features, 1), (match_keypoints, 2),
    (estimate_pose, 2), (image_editing, 1)],
    ids=["detect_features", "cluster_features", "match_keypoints",
         "estimate_pose", "image_editing"])
def test_clis_raise_without_a_card(images, tmp_path, cli, nargs):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is valid")
    (img1, img2), _ = images
    with pytest.raises(RuntimeError, match="CUDA"):
        cli.main([img1, img2][:nargs] + ["-o" if cli is not estimate_pose
                                         else "--cloud",
                                         str(tmp_path / "x.out")])
    assert not (tmp_path / "x.out").exists()


def test_frontend_config_is_carried_across(images):
    """The CLIs build their configs from flags; ``convert.from_jax`` gives
    the same config from JAX's."""
    from photogrammetry_tpu_torch.convert import from_jax

    jcfg = jfront.FrontendConfig(reduction="anms", suppression_radius=4.0)
    _, _, cfg = from_jax(np.zeros((1, 2, 2), np.int32), np.eye(3),
                         dataclasses.asdict(jcfg), device="cpu")
    assert cfg == FrontendConfig(reduction="anms", suppression_radius=4.0)
