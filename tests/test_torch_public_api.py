"""Port parity: the public names.  Every name a JAX subpackage's
``__init__.py`` exports (read with ``ast``, nothing of JAX imported for
it) imports from the port's subpackage of the same name, apart from the
TPU-only names listed below; every module of the JAX package has a port
module at the same path; and the functions the port added for those
names agree with JAX's on the same inputs.

Tolerances: ``project_points``, ``pad_to``, ``brief_descriptors``,
``read_ply`` and the split / batched describe's keypoints and bits
exactly; ``refine_subpixel`` within 1e-4 px (f32 window sums in two
summation orders).  ``profiler_trace`` writes a trace file under its
directory and nothing for ``None``.  Importing the subpackages builds no
kernel and leaves ``torch.distributed.tensor`` unimported (bar
``parallel``, whose modules need it).  Every port test file runs torch on
one thread through the one shared fixture.
"""
import ast
import importlib
import json
import pathlib
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_threads import _one_thread  # noqa: F401
from photogrammetry_tpu.core import camera as jcamera
from photogrammetry_tpu.io import ply as jply
from photogrammetry_tpu.ops import brief as jbrief
from photogrammetry_tpu.ops import refine as jrefine
from photogrammetry_tpu.sfm import frontend as jf
from photogrammetry_tpu.synth.star_scene import (
    StarSceneConfig, generate_sequence,
)
from photogrammetry_tpu.utils import padding as jpadding
from photogrammetry_tpu_torch.core import camera
from photogrammetry_tpu_torch.io import ply
from photogrammetry_tpu_torch.ops import brief
from photogrammetry_tpu_torch.ops import refine
from photogrammetry_tpu_torch.sfm import frontend as pf
from photogrammetry_tpu_torch.utils import padding
from photogrammetry_tpu_torch.utils.profiling import profiler_trace

REPO = pathlib.Path(__file__).resolve().parents[1]
JAX_PKG = REPO / "photogrammetry_tpu"
PORT_PKG = REPO / "photogrammetry_tpu_torch"
TPU_ONLY = {
    "hamming_distance_matrix_pallas": "the Pallas TPU kernel; the port's "
    "kernels.hamming_distance_matrix launches csrc/hamming.cu",
    "fast_score_map_pallas": "the Pallas TPU kernel; the port's "
    "kernels.fast_score_map launches csrc/fast_stencil.cu",
    "schur_products_pallas": "the Pallas TPU kernel; the port's "
    "kernels.schur_products launches csrc/schur.cu",
}


def _exports():
    """(subpackage, name) for every name a JAX ``__init__.py`` imports."""
    out = []
    for init in sorted(JAX_PKG.glob("*/__init__.py")):
        for node in ast.parse(init.read_text()).body:
            if isinstance(node, ast.ImportFrom):
                out += [(init.parent.name, a.asname or a.name)
                        for a in node.names]
    return out


EXPORTS = _exports()


@pytest.mark.parametrize("sub", sorted({s for s, _ in EXPORTS}))
def test_every_jax_export_imports_from_the_port(sub):
    pkg = importlib.import_module(f"photogrammetry_tpu_torch.{sub}")
    names = [n for s, n in EXPORTS if s == sub]
    missing = [n for n in names if n not in TPU_ONLY
               and not hasattr(pkg, n)]
    assert not missing, (sub, missing)
    assert set(getattr(pkg, "__all__", ())) >= \
        {n for n in names if n not in TPU_ONLY}


def test_every_port_test_file_runs_torch_on_one_thread():
    """Every ``tests/test_torch_*.py`` imports the one-thread fixture of
    ``tests/_torch_threads.py`` (autouse, so its tests run on one torch
    thread, as this one does), defines no fixture of its own and sets no
    thread count itself."""
    assert torch.get_num_threads() == 1
    files = sorted((REPO / "tests").glob("test_torch_*.py"))
    assert len(files) > 30
    for path in files:
        tree = ast.parse(path.read_text())
        imported = {(node.module, alias.name) for node in tree.body
                    if isinstance(node, ast.ImportFrom)
                    for alias in node.names}
        assert ("_torch_threads", "_one_thread") in imported, path.name
        assert "_one_thread" not in {
            node.name for node in ast.walk(tree)
            if isinstance(node, ast.FunctionDef)}, path.name
        assert "set_num_threads" not in {
            node.attr for node in ast.walk(tree)
            if isinstance(node, ast.Attribute)}, path.name


def test_kernels_exports_the_entry_points():
    from photogrammetry_tpu_torch import kernels

    assert kernels.__all__ == ["hamming_distance_matrix", "fast_score_map",
                               "schur_products"]
    assert {n for s, n in EXPORTS if s == "kernels"} == set(TPU_ONLY)


def test_every_jax_module_has_a_port():
    def modules(root):
        return {p.relative_to(root).as_posix() for p in root.rglob("*.py")}

    assert modules(JAX_PKG) - modules(PORT_PKG) == set()


def test_imports_build_no_kernel():
    code = (
        "import sys\n"
        "import photogrammetry_tpu_torch.ops, photogrammetry_tpu_torch.sfm\n"
        "import photogrammetry_tpu_torch.kernels as k\n"
        "for m in ('core', 'io', 'store', 'synth', 'utils'):\n"
        "    __import__('photogrammetry_tpu_torch.' + m)\n"
        "from photogrammetry_tpu_torch.kernels import (\n"
        "    _build, brief_pack, fast_stencil, hamming, remap, schur)\n"
        "caches = [fast_stencil._launcher, hamming._launcher,\n"
        "          hamming._pairs_launcher, brief_pack._launchers,\n"
        "          remap._launcher, schur._launcher]\n"
        "print(len(_build._libs), sum(c.cache_info().currsize\n"
        "      for c in caches), 'torch.distributed.tensor' in sys.modules)\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, check=True)
    assert out.stdout.split() == ["0", "0", "False"]


def test_project_points_and_reference_k():
    assert camera.REFERENCE_K == jcamera.REFERENCE_K
    rng = np.random.default_rng(0)
    pts = rng.uniform(-1, 1, (5, 7, 3)).astype(np.float32)
    pts[..., 2] += 4.0
    pts[0, 0] = [0.3, 0.1, -0.0]           # |z| < 1e-12 after the pose
    r = np.eye(3, dtype=np.float32)
    t = np.zeros(3, np.float32)
    k = np.asarray(jcamera.REFERENCE_K, np.float32)
    xy, z = camera.project_points(torch.tensor(pts), torch.tensor(r),
                                  torch.tensor(t), torch.tensor(k))
    jxy, jz = jcamera.project_points(pts, r, t, k)
    np.testing.assert_array_equal(z.numpy(), np.asarray(jz))
    np.testing.assert_allclose(xy.numpy(), np.asarray(jxy), rtol=1e-6)


def test_read_ply_round_trip(tmp_path):
    pts = np.random.default_rng(1).normal(size=(9, 3)).astype(np.float32)
    path = str(tmp_path / "c.ply")
    ply.write_ply(path, pts, colors=np.full((9, 3), 200, np.uint8))
    got = ply.read_ply(path)
    np.testing.assert_array_equal(got, jply.read_ply(path))
    np.testing.assert_allclose(got, pts, rtol=1e-6)


def test_pad_to():
    rng = np.random.default_rng(2)
    coords = rng.integers(0, 100, (5, 2))
    score = rng.random(5)
    got = padding.pad_to(coords, score, 8, device="cpu")
    ref = jpadding.pad_to(coords, score, 8)
    for a, b in zip(got, ref):
        assert a.numpy().dtype == np.asarray(b).dtype
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    with pytest.raises(ValueError, match="capacity"):
        padding.pad_to(coords, score, 4, device="cpu")


@pytest.fixture(scope="module")
def frame():
    return generate_sequence(StarSceneConfig(
        num_frames=2, image_size=(240, 320), focal=260.0,
        supersample=2))["frames"].astype(np.float32)


def test_brief_descriptors(frame):
    rng = np.random.default_rng(3)
    coords = rng.integers(0, (240, 320), (40, 2)).astype(np.int32)
    pairs = brief.gaussian_pairs(0, device="cpu")
    bits, packed = brief.brief_descriptors(torch.tensor(frame[0]),
                                           torch.tensor(coords), pairs)
    jbits, jpacked = jbrief.brief_descriptors(jnp.asarray(frame[0]),
                                              jnp.asarray(coords),
                                              jnp.asarray(pairs.numpy()))
    np.testing.assert_array_equal(bits.numpy(), np.asarray(jbits))
    np.testing.assert_array_equal(packed.numpy(), np.asarray(jpacked))
    assert packed.dtype == torch.uint32 and packed.shape == (40, 8)


def test_refine_subpixel(frame):
    rng = np.random.default_rng(4)
    coords = np.concatenate([rng.integers(0, (240, 320), (60, 2)),
                             [[0, 0], [239, 319], [1, 318]]]).astype(np.int32)
    got = refine.refine_subpixel(torch.tensor(frame[0]), torch.tensor(coords))
    ref = jrefine.refine_subpixel(jnp.asarray(frame[0]), jnp.asarray(coords))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=0,
                               atol=1e-4)
    assert (np.abs(got.numpy() - coords) <= 1.5).all()
    assert (got.numpy() != coords).any()


def test_detect_and_describe_split_and_batch(frame):
    cfg = jf.FrontendConfig(max_keypoints=256, detection_threshold=20.0,
                            suppression_radius=4.0)
    pcfg = pf.FrontendConfig(max_keypoints=256, detection_threshold=20.0,
                             suppression_radius=4.0)
    pairs = pf.make_pairs(pcfg, device="cpu")
    jpairs = jf.make_pairs(cfg)
    one = pf.detect_and_describe_split(torch.tensor(frame[0]), pairs, pcfg)
    jone = jf.detect_and_describe_split(jnp.asarray(frame[0]), jpairs, cfg)
    batch = pf.detect_and_describe_batch(torch.tensor(frame), pairs, pcfg)
    jbatch = jf.detect_and_describe_batch(jnp.asarray(frame), jpairs, cfg)
    for got, ref in ((one, jone), (batch, jbatch)):
        for a, b in zip(got.points, ref.points):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
        np.testing.assert_array_equal(got.bits.numpy(), np.asarray(ref.bits))
        np.testing.assert_allclose(got.xy.numpy(), np.asarray(ref.xy),
                                   atol=1e-4)
    assert int(one.points.count) > 30


def test_profiler_trace(tmp_path):
    with profiler_trace(None):
        torch.ones(3).sum()
    with profiler_trace(""):
        pass
    log = tmp_path / "trace"
    with profiler_trace(str(log)):
        (torch.ones(64, 64) @ torch.ones(64, 64)).sum()
    files = list(log.glob("*.json"))
    assert len(files) == 1
    events = json.loads(files[0].read_text())["traceEvents"]
    assert any("mm" in e.get("name", "") for e in events)
