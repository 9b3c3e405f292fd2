"""Port parity for the slice as a whole, and the port's import guards.

A two-frame star-scene pair from the JAX package's renderer goes through
the JAX chain of ``__graft_entry__.entry`` (detect_and_describe x2 →
match_pair → two_view_pipeline) and through the port's ``entry.forward``
with the same BRIEF pairs (``convert.from_jax``) and the JAX RANSAC draws
injected.  Keypoints, bits and matches: identical.  Pose: rotation within
0.1 deg, translation direction within 0.5 deg, inlier count within 1 (the
LO-RANSAC refits run f32 eigh in two LAPACK builds).  The frontend is
compared on 120x160 frames; the pose on the 480x640 pan of
``__graft_entry__``'s size, because at 120x160 the few matches leave the
pose so ill-determined (10-30 deg from ground truth in both packages) that
f32 rounding alone moves it by degrees.
"""
import dataclasses
import os
import re
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import (
    direction_angle_deg, jax_two_view_samples, rotation_angle_deg,
)
from _torch_threads import _one_thread  # noqa: F401
from photogrammetry_tpu.sfm.frontend import FrontendConfig as JaxConfig
from photogrammetry_tpu.sfm.frontend import detect_and_describe as jax_dd
from photogrammetry_tpu.sfm.frontend import make_pairs as jax_make_pairs
from photogrammetry_tpu.sfm.frontend import match_pair as jax_match
from photogrammetry_tpu.sfm.two_view import two_view_pipeline as jax_two_view
from photogrammetry_tpu.synth.star_scene import (
    StarSceneConfig, generate_sequence, intrinsics, pan_trajectory,
    render_frame,
)
from photogrammetry_tpu_torch import entry
from photogrammetry_tpu_torch.cli import run_sfm
from photogrammetry_tpu_torch.convert import from_jax
from photogrammetry_tpu_torch.core.camera import intrinsic_matrix
from photogrammetry_tpu_torch.sfm.frontend import (
    detect_and_describe, make_pairs, match_pair,
)
from photogrammetry_tpu_torch.sfm.incremental import run_incremental_sfm
from photogrammetry_tpu_torch.sfm.tracks import make_track_table
from photogrammetry_tpu_torch.sfm.two_view import two_view_from_samples
from photogrammetry_tpu_torch.synth import star_scene as port_star_scene

REPO = Path(__file__).resolve().parents[1]
PORT = REPO / "photogrammetry_tpu_torch"
JAX_CFG = JaxConfig(detection_threshold=20.0, max_keypoints=128,
                    reduction="nms", suppression_radius=4.0,
                    hamming_threshold=80)


@pytest.fixture(scope="module")
def scene():
    return generate_sequence(StarSceneConfig(num_frames=6,
                                             image_size=(120, 160),
                                             focal=130.0))


@pytest.fixture(scope="module")
def pan_pair():
    """Frames 0 and 1 of the default 480x640 pan, as test_end_to_end uses."""
    cfg = StarSceneConfig(num_frames=8)
    rs, ts, _ = pan_trajectory(cfg)
    k = intrinsics(cfg)
    frames = [render_frame(cfg, rs[i], ts[i], k).astype(np.float32)
              for i in (0, 1)]
    return frames, k, rs[1] @ rs[0].T


@pytest.fixture(scope="module")
def state():
    pairs = np.asarray(jax_make_pairs(JAX_CFG))
    return pairs, from_jax(pairs, np.eye(3), dataclasses.asdict(JAX_CFG),
                           device="cpu")


def _frames(scene, i, j):
    return (scene["frames"][i].astype(np.float32),
            scene["frames"][j].astype(np.float32))


@pytest.mark.parametrize("i,j", [(0, 2), (1, 2)])
def test_frontend_identical(scene, state, i, j):
    pairs_np, (pairs, _, cfg) = state
    im1, im2 = _frames(scene, i, j)
    ref1 = jax_dd(im1, pairs_np, JAX_CFG)
    ref2 = jax_dd(im2, pairs_np, JAX_CFG)
    ref_m = jax_match(ref1, ref2, JAX_CFG)
    got1 = detect_and_describe(torch.tensor(im1), pairs, cfg)
    got2 = detect_and_describe(torch.tensor(im2), pairs, cfg)
    got_m = match_pair(got1, got2, cfg)
    for got, ref in ((got1, ref1), (got2, ref2)):
        for name in ("coords", "score", "mask", "count"):
            np.testing.assert_array_equal(
                getattr(got.points, name).numpy(),
                np.asarray(getattr(ref.points, name)), name)
        np.testing.assert_array_equal(got.bits.numpy(), np.asarray(ref.bits))
        np.testing.assert_allclose(got.xy.numpy(), np.asarray(ref.xy),
                                   rtol=0, atol=1e-4)
    for name in ("idx2", "dist", "mask", "num"):
        np.testing.assert_array_equal(getattr(got_m, name).numpy(),
                                      np.asarray(getattr(ref_m, name)), name)
    assert int(got_m.num) >= 10


def test_slice_end_to_end(pan_pair, state):
    """The whole forward step, port vs JAX, and both vs ground truth."""
    pairs_np, (pairs, _, _) = state
    jcfg = dataclasses.replace(JAX_CFG, detection_threshold=50.0,
                               max_keypoints=256)
    _, _, cfg = from_jax(pairs_np, np.eye(3), dataclasses.asdict(jcfg),
                         device="cpu")
    (im1, im2), k, r_gt = pan_pair
    key = jax.random.PRNGKey(0)
    ref_m = jax_match(jax_dd(im1, pairs_np, jcfg),
                      jax_dd(im2, pairs_np, jcfg), jcfg)
    ref = jax_two_view(key, ref_m.xy1, ref_m.xy2, ref_m.mask,
                       jnp.asarray(k), threshold=1.5, num_samples=256,
                       h_samples=64)

    out = entry.forward(im1, im2, pairs, k, cfg, device="cpu",
                        num_samples=256, h_samples=64)
    m = out.match
    for name in ("idx2", "dist", "mask", "num"):
        np.testing.assert_array_equal(getattr(m, name).numpy(),
                                      np.asarray(getattr(ref_m, name)), name)
    assert int(m.num) >= 30
    f_idx, h_idx = jax_two_view_samples(key, np.asarray(ref_m.mask), 256, 64)
    got = two_view_from_samples(torch.tensor(f_idx), torch.tensor(h_idx),
                                m.xy1, m.xy2, m.mask,
                                torch.tensor(k), threshold=1.5)
    assert bool(got.used_homography) == bool(ref.used_homography)
    assert abs(int(got.num_inliers) - int(ref.num_inliers)) <= 1
    assert rotation_angle_deg(got.r.numpy(), ref.r) < 0.1
    assert direction_angle_deg(got.t.numpy(), ref.t) < 0.5

    # the bound of tests/test_end_to_end.py, for the injected and the
    # port's own (torch.Generator) draws alike
    for r in (got.r.numpy(), out.two_view.r.numpy()):
        assert rotation_angle_deg(r, r_gt) < 5.0
    assert np.isfinite(out.two_view.points.numpy()).all()


def test_from_jax_drops_pallas_flags():
    pairs = np.asarray(jax_make_pairs(JAX_CFG))
    p, k, cfg = from_jax(pairs, np.eye(3), dataclasses.asdict(JAX_CFG),
                         device="cpu")
    assert p.dtype == torch.int32 and p.shape == (256, 2, 2)
    np.testing.assert_array_equal(p.numpy(), pairs)
    assert k.dtype == torch.float32
    assert cfg.max_keypoints == 128 and cfg.suppression_radius == 4.0
    assert not hasattr(cfg, "use_pallas_detect")


def test_port_renderer_matches_jax_package(scene):
    port = port_star_scene.generate_sequence(port_star_scene.StarSceneConfig(
        num_frames=6, image_size=(120, 160), focal=130.0))
    np.testing.assert_array_equal(port["frames"], scene["frames"])
    np.testing.assert_array_equal(port["k"], scene["k"])


def test_port_imports_without_jax():
    modules = sorted(
        "photogrammetry_tpu_torch." + ".".join(p.relative_to(PORT)
                                               .with_suffix("").parts)
        for p in PORT.rglob("*.py") if p.name != "__init__.py")
    code = ("import sys\nsys.modules['jax'] = None\n"
            + "".join(f"import {m}\n" for m in modules)
            + "bad = [m for m in sys.modules if m == 'photogrammetry_tpu' "
              "or m.startswith('photogrammetry_tpu.')]\n"
              "assert not bad, bad\nprint('ok', len(sys.modules))\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120,
                         env={**os.environ, "PYTHONPATH": str(REPO)})
    assert res.returncode == 0, res.stderr
    assert res.stdout.startswith("ok")
    assert len(modules) >= 27


def test_port_sources_import_no_jax():
    forbidden = ("import jax", "from jax", "from photogrammetry_tpu.",
                 "import photogrammetry_tpu.", "from photogrammetry_tpu ",
                 "import photogrammetry_tpu\n")
    files = list(PORT.rglob("*.py")) + [REPO / "chip_smoke.py"]
    for path in files:
        text = path.read_text() + "\n"
        for f in forbidden:
            assert f not in text, (path, f)


def test_port_sources_name_no_jax_module():
    """Not even prose names a module path of the JAX package: the port's
    sources and chip_smoke.py give no ``photogrammetry_tpu.<name>`` to a
    reader or to a search for imports of it."""
    pattern = re.compile(r"import jax|from jax|photogrammetry_tpu\.|"
                         r"photogrammetry_tpu import")
    files = list(PORT.rglob("*.py")) + [REPO / "chip_smoke.py"]
    hits = [(path.name, m.group()) for path in files
            for m in pattern.finditer(path.read_text())]
    assert not hits, hits


def test_entry_points_raise_without_a_card(scene, state):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is valid")
    _, (pairs, _, cfg) = state
    im1, im2 = _frames(scene, 0, 2)
    with pytest.raises(RuntimeError, match="CUDA"):
        entry.forward(im1, im2, pairs, scene["k"], cfg)
    with pytest.raises(RuntimeError, match="CUDA"):
        make_pairs(cfg)
    with pytest.raises(RuntimeError, match="CUDA"):
        from_jax(np.asarray(pairs), np.eye(3), {})
    with pytest.raises(RuntimeError, match="CUDA"):
        intrinsic_matrix(520.0, 520.0, 320.0, 240.0)
    with pytest.raises(RuntimeError, match="CUDA"):
        make_track_table(4, 16, 8)
    with pytest.raises(RuntimeError, match="CUDA"):
        run_incremental_sfm(scene["frames"], scene["k"])
    with pytest.raises(RuntimeError, match="CUDA"):
        run_sfm.main(["--synthetic-frames", "2"])
