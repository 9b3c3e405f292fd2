"""Port parity: steered BRIEF and the batched, masked describe stage.

Same numpy inputs through the JAX package (XLA ops) and
photogrammetry_tpu_torch on the CPU (the kernel wrapper's plain path).
Tolerances, each beside its reason:

* ``keypoint_orientations``: atol 1e-4 rad on keypoints whose intensity
  centroid lies more than 1e-3 px from the keypoint (the box sums are
  taken in the same order in f32; the angle of a centroid nearer than that
  is the angle of rounding noise), measured 1.2e-6 rad;
* ``brief_bits_oriented`` with JAX's angles: every bit equal except where
  a rotated offset lies within 1e-5 px of a .5 rounding boundary in a
  float64 recomputation (there the f32 products of torch and XLA may round
  to either side); those bits are counted;
* batched, masked ``brief_bits``: integers, exact;
* ``precompute_frontend(oriented_brief=True)``: keypoints exact, xy 1e-4
  px (as tests/test_torch_sfm.py), bits equal except where a rotated
  offset lies within 2e-3 px of a .5 boundary (the two packages' angles
  differ by up to 1e-5 rad, times offsets of up to ~250 px) or the
  keypoint's orientation is undefined (centroid within 1e-3 px).
"""
import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy import ndimage

from _torch_threads import _one_thread  # noqa: F401
from photogrammetry_tpu.ops import brief as jbrief
from photogrammetry_tpu.sfm.frontend import FrontendConfig as JaxConfig
from photogrammetry_tpu.sfm.frontend import make_pairs as jax_make_pairs
from photogrammetry_tpu.sfm.frontend import \
    precompute_frontend as jax_precompute
from photogrammetry_tpu_torch.cli import run_sfm
from photogrammetry_tpu_torch.convert import from_jax
from photogrammetry_tpu_torch.kernels import brief_pack
from photogrammetry_tpu_torch.ops import brief
from photogrammetry_tpu_torch.sfm.frontend import (
    FrontendConfig, detect_and_describe, match_pair, precompute_frontend,
)


def _texture(rng, h, w):
    """Noise smoothed at two scales (3 and 12 px, weighted by scale) and
    stretched over 0..255: corners everywhere, and patches whose intensity
    centroid has a stable direction."""
    t = sum(ndimage.gaussian_filter(rng.normal(size=(h, w)), s) * s
            for s in (3.0, 12.0))
    t = (t - t.min()) / (t.max() - t.min()) * 255.0
    return t.astype(np.float32)


def _rotate(img, deg):
    """``img`` rotated by ``deg`` about its centre (bilinear, zero outside)
    and the map of a (row, col) of ``img`` to its place in the result."""
    h, w = img.shape
    a = np.radians(deg)
    rot = np.array([[np.cos(a), -np.sin(a)], [np.sin(a), np.cos(a)]])
    c = np.array([(h - 1) / 2.0, (w - 1) / 2.0])
    # out[o] = img[rot @ o + c - rot @ c]
    out = ndimage.affine_transform(img, rot, offset=c - rot @ c, order=1)

    def where(rc):
        return (rc - c) @ rot + c      # rot^T (rc - c) + c, row-wise
    return out.astype(np.float32), where


def _centroid_offset(img, coords, radius=15):
    """|intensity centroid - keypoint| in float64 (the keypoints whose
    orientation is defined)."""
    h, w = img.shape
    rr, cc = np.mgrid[0:h, 0:w].astype(np.float64)
    k = 2 * radius + 1

    def box(x):
        return ndimage.uniform_filter(x, k, mode="constant") * k * k
    m00, m_r, m_c = box(img.astype(np.float64)), box(img * rr), box(img * cc)
    r = np.clip(coords[:, 0], 0, h - 1)
    c = np.clip(coords[:, 1], 0, w - 1)
    d = np.maximum(m00[r, c], 1e-6)
    return np.hypot(m_r[r, c] / d - r, m_c[r, c] / d - c)


def _near_tie_bits(pairs, thetas, window):
    """(N, P) bool: a rotated offset of the pair lies within ``window`` px
    of a .5 rounding boundary (float64)."""
    c, s = np.cos(thetas)[:, None, None], np.sin(thetas)[:, None, None]
    pr = pairs[None, :, :, 0].astype(np.float64)
    pc = pairs[None, :, :, 1].astype(np.float64)
    rot = np.stack([c * pr + s * pc, -s * pr + c * pc], -1)  # (N, P, 2, 2)
    frac = np.abs(np.abs(rot - np.floor(rot)) - 0.5)
    return (frac < window).any(axis=(2, 3))


def _keypoints(rng, n, h, w):
    return np.stack([rng.integers(0, h, n), rng.integers(0, w, n)],
                    -1).astype(np.int32)


def test_keypoint_orientations_match_jax_batched():
    rng = np.random.default_rng(20)
    h, w = 96, 128
    imgs = np.stack([_texture(rng, h, w) for _ in range(2)])
    coords = np.stack([_keypoints(rng, 150, h, w) for _ in range(2)])
    coords[:, :5] = [[0, 0], [h - 1, w - 1], [0, w - 1], [h - 1, 0],
                     [h // 2, 0]]                    # patches cut by a border
    got = brief.keypoint_orientations(torch.tensor(imgs),
                                      torch.tensor(coords)).numpy()
    assert got.shape == (2, 150)
    for f in range(2):
        ref = np.asarray(jbrief.keypoint_orientations(imgs[f], coords[f]))
        one = brief.keypoint_orientations(torch.tensor(imgs[f]),
                                          torch.tensor(coords[f])).numpy()
        # batch = frame by frame, up to the last bit of torch's atan2,
        # whose vectorised and scalar paths round apart
        np.testing.assert_allclose(one, got[f], rtol=0, atol=1e-6)
        defined = _centroid_offset(imgs[f], coords[f]) > 1e-3
        assert defined.mean() > 0.9
        diff = np.angle(np.exp(1j * (got[f] - ref)))  # modulo 2 pi
        assert np.abs(diff[defined]).max() < 1e-4


@pytest.mark.parametrize("num_pairs", [48, 256])
def test_brief_bits_oriented_matches_jax_with_its_angles(num_pairs):
    rng = np.random.default_rng(21)
    h, w = 96, 128
    img = _texture(rng, h, w)
    coords = _keypoints(rng, 200, h, w)
    pairs = np.asarray(jbrief.gaussian_pairs(jax.random.PRNGKey(5), 50.0,
                                             num_pairs))
    thetas = rng.uniform(-np.pi, np.pi, 200).astype(np.float32)
    thetas[:20] = np.float32(np.pi / 3)     # cos 0.5: offsets near .5
    ref = np.asarray(jbrief.brief_bits_oriented(img, coords, pairs, thetas))
    got = brief.brief_bits_oriented(torch.tensor(img), torch.tensor(coords),
                                    torch.tensor(pairs),
                                    torch.tensor(thetas)).numpy()
    assert got.dtype == np.uint8 and got.shape == (200, num_pairs)
    near = _near_tie_bits(pairs, thetas.astype(np.float64), 1e-5)
    differ = got != ref
    assert not (differ & ~near).any()
    assert differ.sum() <= near.sum()
    # the wrapper on CPU tensors is this plain version
    cs = brief.angles_cos_sin(torch.tensor(thetas))
    assert torch.equal(brief_pack.brief_bits(
        torch.tensor(img), torch.tensor(coords), torch.tensor(pairs),
        cos_sin=cs), torch.tensor(got))


@pytest.mark.parametrize("num_pairs", [48, 256])
def test_batched_masked_brief_matches_jax_vmap(num_pairs):
    rng = np.random.default_rng(22)
    b, n, h, w = 3, 120, 80, 112
    imgs = rng.integers(0, 256, (b, h, w)).astype(np.float32)
    coords = np.stack([_keypoints(rng, n, h, w) for _ in range(b)])
    coords[:, :10, 0] -= 30                          # past the top border
    mask = np.arange(n)[None] < np.array([[n], [n // 2], [0]])
    pairs = np.asarray(jbrief.gaussian_pairs(jax.random.PRNGKey(6), 30.0,
                                             num_pairs))
    ref = np.asarray(jax.vmap(
        lambda g, c, m: jbrief.brief_bits(g, c, jnp.asarray(pairs))
        * m[:, None].astype(jnp.uint8))(imgs, coords, mask))
    got = brief_pack.brief_bits(torch.tensor(imgs), torch.tensor(coords),
                                torch.tensor(pairs), torch.tensor(mask))
    assert got.shape == (b, n, num_pairs)
    np.testing.assert_array_equal(got.numpy(), ref)
    assert ref[0].any() and not ref[2].any()


def test_precompute_frontend_oriented_matches_jax():
    rng = np.random.default_rng(23)
    h, w = 240, 320
    base = _texture(rng, h, w)
    frames = np.stack([base, _rotate(base, 12.0)[0]])
    jcfg = JaxConfig(detection_threshold=6.0, max_keypoints=128,
                     reduction="nms", suppression_radius=4.0,
                     oriented_brief=True)
    pairs_np = np.asarray(jax_make_pairs(jcfg))
    pairs, _, cfg = from_jax(pairs_np, np.eye(3), dataclasses.asdict(jcfg),
                             device="cpu")
    assert cfg.oriented_brief
    ref = jax_precompute(jnp.asarray(frames), pairs_np, jcfg, chunk=2)
    got = precompute_frontend(torch.tensor(frames), pairs, cfg, chunk=2)
    for name in ("coords", "score", "mask", "count"):
        np.testing.assert_array_equal(getattr(got.points, name).numpy(),
                                      np.asarray(getattr(ref.points, name)),
                                      name)
    np.testing.assert_allclose(got.xy.numpy(), np.asarray(ref.xy), rtol=0,
                               atol=1e-4)
    assert int(got.points.count.min()) > 50
    flipped = 0
    for f in range(2):
        coords = np.asarray(ref.points.coords[f])
        thetas = np.asarray(jbrief.keypoint_orientations(frames[f], coords),
                            np.float64)
        exempt = (_near_tie_bits(pairs_np, thetas, 2e-3)
                  | (_centroid_offset(frames[f], coords) <= 1e-3)[:, None])
        differ = got.bits[f].numpy() != np.asarray(ref.bits[f])
        assert not (differ & ~exempt).any()
        flipped += int(differ.sum())
    assert flipped <= 0.001 * got.bits.numel()
    unsteered = precompute_frontend(
        torch.tensor(frames), pairs,
        dataclasses.replace(cfg, oriented_brief=False), chunk=2)
    assert not torch.equal(unsteered.bits, got.bits)


def _correct_matches(img1, img2, where, oriented, px=2.0):
    cfg = FrontendConfig(detection_threshold=6.0, max_keypoints=512,
                         suppression_radius=4.0, hamming_threshold=75,
                         subpixel=False, oriented_brief=oriented)
    pairs = torch.tensor(np.asarray(jax_make_pairs(JaxConfig())))
    f1, f2 = (detect_and_describe(torch.tensor(im), pairs, cfg)
              for im in (img1, img2))
    m = match_pair(f1, f2, cfg)
    ok = m.mask.numpy()
    p1 = f1.points.coords.numpy()[ok].astype(np.float64)
    p2 = f2.points.coords.numpy()[m.idx2.numpy()[ok]].astype(np.float64)
    return int((np.linalg.norm(where(p1) - p2, axis=1) < px).sum())


def test_steered_brief_survives_rotation():
    """On a texture rotated by 30 degrees, steered BRIEF keeps at least
    twice the correct mutual-nearest matches of plain BRIEF, and at least
    20 (the gate of tests/test_pyramid_sfm.py's roll test; a match is
    correct within 2 px of where the rotation puts the keypoint)."""
    rng = np.random.default_rng(24)
    img = _texture(rng, 240, 320)
    rotated, where = _rotate(img, 30.0)
    plain = _correct_matches(img, rotated, where, oriented=False)
    steered = _correct_matches(img, rotated, where, oriented=True)
    assert steered >= 2 * max(plain, 1) and steered >= 20, (plain, steered)
    # measured: 0 and 57 of 279 keypoints


def test_run_sfm_cli_oriented_brief(tmp_path, capsys):
    cloud, traj = tmp_path / "cloud.ply", tmp_path / "traj.json"
    assert run_sfm.main(["--device", "cpu", "--synthetic-frames", "6",
                         "--oriented-brief", "--cloud", str(cloud),
                         "--trajectory", str(traj)]) == 0
    report = json.loads(capsys.readouterr().out.splitlines()[0])
    assert report["frames"] == 6 and np.isfinite(report["ate"])
    assert report["landmarks"] > 0
    assert len(json.loads(traj.read_text())["centers"]) == 6
