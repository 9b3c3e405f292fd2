"""Port parity: grayscale, the content store and pipeline runner, overlay
drawing, the keypoint cache, ``pipeline_demo.build_pipeline`` and the
``de_warp`` CLI against the JAX package on the CPU.

Exact comparisons: ``bgr_to_gray_cv2`` (int32 fixed point), ``draw_squares``,
and the pipeline's keypoints when both packages read the distortion map
from one cache directory (the identical map, so the uint8 dewarp is equal
up to rounding ties and FAST sees the same corners; measured: all
coordinates, scores and masks equal).  ``rgb_to_gray_mean`` 1e-5 (a sum of
three floats).  The ``de_warp`` CLIs each generate their own map (5e-4 px
apart, tests/test_torch_dewarp.py): their uint8 outputs differ by at most
1 grey level on under 1% of the pixels (measured 0.02%).
"""
import threading

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_threads import _one_thread  # noqa: F401
from photogrammetry_tpu.cli import de_warp as jax_de_warp
from photogrammetry_tpu.cli import pipeline_demo as jax_pipeline_demo
from photogrammetry_tpu.io.draw import draw_squares as jax_draw_squares
from photogrammetry_tpu.ops import grayscale as jgray
from photogrammetry_tpu.store.content_store import Variant as JaxVariant
from photogrammetry_tpu.synth.star_scene import (
    StarSceneConfig, generate_sequence,
)
from photogrammetry_tpu_torch.cli import de_warp, pipeline_demo
from photogrammetry_tpu_torch.io.draw import draw_squares
from photogrammetry_tpu_torch.io.image import read_image, write_image
from photogrammetry_tpu_torch.ops import grayscale
from photogrammetry_tpu_torch.store.cache import KeypointCache
from photogrammetry_tpu_torch.store.content_store import (
    ContentStore, Variant,
)
from photogrammetry_tpu_torch.store.pipeline import Pipeline, Stage

COEFFS = [3e-4, 1e-7, 0.0, 0.0, 0.0]


@pytest.fixture(scope="module")
def image_files(tmp_path_factory):
    """Two 240x320 star-scene frames as tinted RGB PNGs."""
    scene = generate_sequence(StarSceneConfig(
        num_frames=2, image_size=(240, 320), focal=260.0, supersample=2))
    root = tmp_path_factory.mktemp("frames")
    paths = []
    for i, frame in enumerate(scene["frames"]):
        rgb = np.stack([frame, frame * 0.8, frame * 0.6], -1)
        paths.append(str(root / f"frame{i}.png"))
        write_image(paths[-1], rgb.astype(np.uint8))
    return paths


def test_grayscale_matches_jax():
    rng = np.random.default_rng(0)
    bgr = rng.integers(0, 256, (37, 53, 3)).astype(np.uint8)
    got = grayscale.bgr_to_gray_cv2(torch.tensor(bgr))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(jgray.bgr_to_gray_cv2(jnp.asarray(bgr))))
    # the extremes of the fixed-point rounding
    for v in (0, 255):
        px = torch.full((1, 1, 3), v, dtype=torch.uint8)
        assert int(grayscale.bgr_to_gray_cv2(px)) == v
    np.testing.assert_allclose(
        grayscale.rgb_to_gray_mean(torch.tensor(bgr)).numpy(),
        np.asarray(jgray.rgb_to_gray_mean(jnp.asarray(bgr))), rtol=1e-5)


def test_content_store_invariants():
    store = ContentStore(clock=lambda: 42.0)
    rid = store.create_record()
    assert store.created_at(rid) == 42.0 and len(store) == 1
    store.store(rid, Variant.RGB, "blob")
    assert store.has(rid, Variant.RGB) and not store.has(rid, Variant.POSE)
    assert store.fetch(rid, Variant.RGB) == "blob"
    with pytest.raises(ValueError, match="already has variant"):
        store.store(rid, Variant.RGB, "other")
    with pytest.raises(KeyError):
        store.fetch(rid, Variant.POSE)
    with pytest.raises(KeyError):
        store.store("nobody", Variant.RGB, 1)
    assert {v.value for v in Variant} == {v.value for v in JaxVariant}


def test_pipeline_validation_extra_inputs_and_workers():
    double = Stage("double", Variant.SOURCE, Variant.RGB, lambda x: 2 * x)
    with pytest.raises(ValueError, match="duplicate stage names"):
        Pipeline([double, double])
    with pytest.raises(ValueError, match="expects"):
        Pipeline([double, Stage("g", Variant.GRAYSCALE, Variant.KEYPOINTS,
                                lambda x: x)])
    seen = set()

    def add(x, source):
        seen.add(threading.get_ident())
        return x + source

    pipe = Pipeline([double, Stage("add", Variant.RGB, Variant.GRAYSCALE,
                                   add, extra_inputs=(Variant.SOURCE,))])
    blobs = list(range(16))
    for workers in (1, 2):
        rids = pipe.run(blobs, max_workers=workers)
        assert [pipe.store.fetch(r, Variant.GRAYSCALE) for r in rids] \
            == [3 * b for b in blobs]
    summary = pipe.timer.summary()
    assert summary["double"]["calls"] == summary["add"]["calls"] == 32

    def boom(x):
        raise RuntimeError("stage failed")

    bad = Pipeline([Stage("boom", Variant.SOURCE, Variant.RGB, boom)])
    for workers in (1, 2):      # a worker's exception reaches the caller
        with pytest.raises(RuntimeError, match="stage failed"):
            bad.run([1, 2], max_workers=workers)


def test_draw_squares_matches_jax():
    rng = np.random.default_rng(1)
    gray = rng.integers(0, 256, (40, 50)).astype(np.uint8)
    coords = np.array([[0, 0], [39, 49], [20, 25], [2, 47]], np.int32)
    for img in (gray, np.stack([gray] * 3, -1)):
        got = draw_squares(img, coords, half=3, color=(0, 255, 0))
        np.testing.assert_array_equal(
            got, jax_draw_squares(img, coords, half=3, color=(0, 255, 0)))
        assert got.shape == (40, 50, 3) and (got[17, 22:29] ==
                                             (0, 255, 0)).all()
    assert not np.shares_memory(draw_squares(gray, coords), gray)


def test_keypoint_cache_round_trip(tmp_path, image_files):
    cache = KeypointCache(str(tmp_path / "kp"))
    cfg = dict(threshold=20.0, reduction="nms", pair_seed=0)
    assert cache.get(image_files[0], **cfg) is None
    arrays = {"coords": np.arange(10, dtype=np.int32).reshape(5, 2),
              "bits": torch.ones((5, 8), dtype=torch.uint8)}
    cache.put(image_files[0], arrays, **cfg)
    got = cache.get(image_files[0], **cfg)
    np.testing.assert_array_equal(got["coords"], arrays["coords"])
    np.testing.assert_array_equal(got["bits"], arrays["bits"].numpy())
    assert cache.get(image_files[0], **{**cfg, "pair_seed": 1}) is None
    assert cache.get(image_files[1], **cfg) is None     # keyed by content


def test_build_pipeline_matches_jax(tmp_path, image_files):
    """read -> dewarp -> grayscale -> detect -> nms -> draw -> write on two
    files, two worker threads, beside the JAX pipeline; both read the map
    the JAX pipeline cached."""
    args = (COEFFS, 20.0, 8.0, 512)
    cache_dir = str(tmp_path / "maps")
    ref = jax_pipeline_demo.build_pipeline(*args, str(tmp_path / "jax_out"),
                                           cache_dir)
    ref_rids = ref.run(image_files, max_workers=1)
    pipe = pipeline_demo.build_pipeline(*args, str(tmp_path / "out"),
                                        cache_dir, device="cpu")
    rids = pipe.run(image_files, max_workers=2)
    for rid, ref_rid, path in zip(rids, ref_rids, image_files):
        for variant in (Variant.KEYPOINTS, Variant.DENOISED_KEYPOINTS):
            pts = pipe.store.fetch(rid, variant)
            j_pts = ref.store.fetch(ref_rid, JaxVariant(variant.value))
            for name in ("coords", "score", "mask", "count"):
                np.testing.assert_array_equal(
                    getattr(pts, name).numpy(),
                    np.asarray(getattr(j_pts, name)), f"{variant} {name}")
        kept = int(pipe.store.fetch(rid, Variant.DENOISED_KEYPOINTS).count)
        assert 10 < kept < int(pipe.store.fetch(rid,
                                                Variant.KEYPOINTS).count)
        dewarped = pipe.store.fetch(rid, Variant.DEWARPED_RGB)
        assert dewarped.dtype == torch.uint8
        assert dewarped.shape == (240, 320, 3)
        assert not np.array_equal(dewarped.numpy(), read_image(path))
        out = pipe.store.fetch(rid, Variant.ARTIFACT)
        overlay = read_image(out)
        np.testing.assert_array_equal(
            overlay, read_image(ref.store.fetch(ref_rid,
                                                JaxVariant.ARTIFACT)))
        assert (overlay == (0, 255, 0)).all(-1).sum() > 10 * kept
    assert set(pipe.timer.summary()) == {"read", "dewarp", "grayscale",
                                         "detect", "nms", "draw", "write"}

    # zero coefficients: the identity model, no map is made
    ident = pipeline_demo.build_pipeline(
        [0.0] * 5, 20.0, 8.0, 512, str(tmp_path / "ident_out"),
        str(tmp_path / "no_maps"), device="cpu")
    rid = ident.run(image_files[:1])[0]
    np.testing.assert_array_equal(
        ident.store.fetch(rid, Variant.DEWARPED_RGB).numpy(),
        read_image(image_files[0]))
    assert not (tmp_path / "no_maps").exists()


def test_pipeline_demo_cli(tmp_path, image_files, capsys):
    out_dir = tmp_path / "out"
    rc = pipeline_demo.main([*image_files, "--device", "cpu",
                             "--detection-threshold", "20",
                             "--suppression-radius", "8",
                             "--max-keypoints", "512", "--out-dir",
                             str(out_dir), "--cache-dir",
                             str(tmp_path / "maps")])
    assert rc == 0
    lines = capsys.readouterr().out.splitlines()
    assert len(lines) == 3 and "keypoints ->" in lines[0]
    assert sorted(p.name for p in out_dir.iterdir()) == [
        "keypoints_frame0.png", "keypoints_frame1.png"]
    assert len(list((tmp_path / "maps").iterdir())) == 1


def test_de_warp_cli_matches_jax(tmp_path, image_files, capsys):
    out, ref_out = tmp_path / "port.png", tmp_path / "jax.png"
    stats = tmp_path / "stats.json"
    assert de_warp.main([image_files[0], "a comment", "-o", str(out),
                         "--device", "cpu", "--no-cache", "--fast-apply",
                         "--stats", str(stats)]) == 0
    assert jax_de_warp.main([image_files[0], "-o", str(ref_out),
                             "--no-cache"]) == 0
    got, ref = read_image(str(out)), read_image(str(ref_out))
    assert got.shape == ref.shape == (240, 320, 3)
    diff = np.abs(got.astype(np.int32) - ref)
    assert diff.max() <= 1 and (diff > 0).mean() < 1e-2
    assert np.abs(got.astype(np.int32)
                  - read_image(image_files[0])).max() > 50   # it dewarped
    assert "apply_map" in capsys.readouterr().out
    # the cached path writes the map where the JAX package would look
    cached = tmp_path / "cached.png"
    assert de_warp.main([image_files[0], "-o", str(cached), "--device",
                         "cpu", "--cache-dir", str(tmp_path / "maps")]) == 0
    np.testing.assert_array_equal(read_image(str(cached)), got)
    assert [p.name for p in (tmp_path / "maps").iterdir()] == [
        "dim_320x240_coeff_0.0003_1e-07_0.0_0.0_0.0.npz"]
