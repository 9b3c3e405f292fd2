"""Port parity: two-view geometry (8-point F, RANSAC F and H with the JAX
package's own sample draws injected, essential and homography
decomposition, DLT triangulation, cheirality pose selection).

Tolerances: F and H are defined up to sign and compared up to sign at atol
1e-4 (f32 eigh/SVD of LAPACK in two frameworks; on these well-conditioned
scenes the O(1) entries agree to ~1e-6).  Inlier sets, counts and
winning samples are exact.  Points at atol 1e-4 / rtol 1e-4; poses as
stated in each test.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import (
    assert_same_up_to_sign, jax_sample_idx, jax_two_view_samples,
    rotation_angle_deg, direction_angle_deg,
)
from _torch_threads import _one_thread  # noqa: F401
from photogrammetry_tpu.sfm import epipolar as jep
from photogrammetry_tpu.sfm import homography as jho
from photogrammetry_tpu.sfm import triangulate as jtr
from photogrammetry_tpu.sfm.two_view import two_view_pipeline as jax_two_view
from photogrammetry_tpu_torch.sfm import epipolar, homography, triangulate
from photogrammetry_tpu_torch.sfm.two_view import two_view_from_samples

K = np.array([[300.0, 0.0, 160.0], [0.0, 300.0, 120.0], [0.0, 0.0, 1.0]],
             np.float32)


def _rot(ax, ay, az):
    cx, sx, cy, sy, cz, sz = (np.cos(ax), np.sin(ax), np.cos(ay), np.sin(ay),
                              np.cos(az), np.sin(az))
    rx = np.array([[1, 0, 0], [0, cx, -sx], [0, sx, cx]])
    ry = np.array([[cy, 0, sy], [0, 1, 0], [-sy, 0, cy]])
    rz = np.array([[cz, -sz, 0], [sz, cz, 0], [0, 0, 1]])
    return rz @ ry @ rx


def _scene(seed, n=120, planar=False, outliers=0.2, noise=0.3):
    """Correspondences of a rigid scene under a known motion, with pixel
    noise, gross outliers and some masked-off rows."""
    rng = np.random.default_rng(seed)
    # a wide depth range and a baseline of 1/6 of the mean depth keep the
    # second-smallest eigenvalue of the 8-point Gram matrix well away from
    # 0: with a 0.6-unit baseline at depth 5-9 the f32 null vector itself
    # moves by up to 1e-3 between two LAPACK builds (and from float64)
    pts = rng.uniform([-2, -1.5, 3], [2, 1.5, 12], (n, 3))
    pts[:, :2] *= pts[:, 2:] / 6.0  # fill the frame at every depth
    if planar:
        pts[:, 2] = 6.0 + 0.1 * pts[:, 0]
    r = _rot(0.05, 0.1, -0.05)
    t = np.array([1.0, 0.3, 0.5])

    def proj(p):
        uvw = p @ K.T
        return uvw[:, :2] / uvw[:, 2:]

    xy1 = proj(pts) + rng.normal(0, noise, (n, 2))
    xy2 = proj(pts @ r.T + t) + rng.normal(0, noise, (n, 2))
    bad = rng.random(n) < outliers
    xy2[bad] = rng.uniform([0, 0], [320, 240], (bad.sum(), 2))
    mask = rng.random(n) > 0.1
    return (xy1.astype(np.float32), xy2.astype(np.float32), mask,
            r, t / np.linalg.norm(t))


def _t(x):
    return torch.tensor(np.asarray(x))


@pytest.mark.parametrize("weighted", [False, True])
def test_eight_point_fundamental_up_to_sign(weighted):
    xy1, xy2, mask, _, _ = _scene(1, n=40, outliers=0.0)
    w = mask.astype(np.float32) if weighted else None
    ref = jep.eight_point_fundamental(xy1, xy2, weights=w)
    got = epipolar.eight_point_fundamental(
        _t(xy1), _t(xy2), weights=None if w is None else _t(w))
    assert_same_up_to_sign(got.numpy(), ref, atol=1e-4)


def test_eight_point_batched_hypotheses():
    """The batched hypotheses of RANSAC equal the one-at-a-time port.

    A minimal 8-point sample is not compared with JAX entry by entry: its
    f32 null vector is ill-conditioned in both packages (measured: entries
    differ by up to 3e-3 even on noise-free correspondences).  The RANSAC
    tests hold the hypotheses to JAX through exact inlier sets and winning
    samples instead."""
    xy1, xy2, mask, _, _ = _scene(2)
    idx = jax_sample_idx(jax.random.PRNGKey(5), mask, 16, 8)
    idx = idx[[len(set(i)) == 8 for i in idx]]  # no double null space
    got = epipolar.eight_point_fundamental(_t(xy1)[idx], _t(xy2)[idx])
    for h in range(len(idx)):
        one = epipolar.eight_point_fundamental(_t(xy1[idx[h]]),
                                               _t(xy2[idx[h]]))
        assert_same_up_to_sign(got[h].numpy(), one.numpy(), atol=1e-6)
    assert len(idx) >= 4


def test_draw_samples_valid_and_uniform():
    _, _, mask, _, _ = _scene(3)
    gen = torch.Generator().manual_seed(0)
    idx = epipolar.draw_samples(gen, _t(mask), 4000, 8).numpy()
    assert idx.shape == (4000, 8)
    assert mask[idx].all()
    counts = np.bincount(idx.ravel(), minlength=len(mask))[mask]
    assert counts.min() > 0.6 * counts.mean()


def test_ransac_fundamental_injected_samples():
    xy1, xy2, mask, _, _ = _scene(4)
    key = jax.random.PRNGKey(7)
    ref = jep.ransac_fundamental(key, xy1, xy2, mask, 1.0, num_samples=128)
    idx = jax_sample_idx(key, mask, 128, 8)
    got = epipolar.ransac_fundamental(_t(idx), _t(xy1), _t(xy2), _t(mask),
                                      1.0)
    np.testing.assert_array_equal(got.inliers.numpy(),
                                  np.asarray(ref.inliers))
    assert int(got.num_inliers) == int(ref.num_inliers) > 50
    np.testing.assert_array_equal(got.best_sample.numpy(),
                                  np.asarray(ref.best_sample))
    assert_same_up_to_sign(got.f.numpy(), ref.f, atol=1e-4)


def test_ransac_homography_injected_samples():
    xy1, xy2, mask, _, _ = _scene(5, planar=True)
    key = jax.random.PRNGKey(8)
    ref = jho.ransac_homography(key, xy1, xy2, mask, 1.5, num_samples=96)
    idx = jax_sample_idx(key, mask, 96, 4)
    got = homography.ransac_homography(_t(idx), _t(xy1), _t(xy2), _t(mask),
                                       1.5)
    np.testing.assert_array_equal(got.inliers.numpy(),
                                  np.asarray(ref.inliers))
    assert int(got.num_inliers) == int(ref.num_inliers) > 50
    assert_same_up_to_sign(got.h.numpy(), ref.h, atol=1e-4)


def _match_candidates(got, ref, atol):
    """Every candidate of ``ref`` equals some candidate of ``got``."""
    got = [np.concatenate([np.asarray(g[i]).ravel() for g in got])
           for i in range(4)]
    for i in range(4):
        rc = np.concatenate([np.asarray(r[i]).ravel() for r in ref])
        assert min(np.abs(g - rc).max() for g in got) < atol, i


def test_decompose_essential_candidate_set():
    xy1, xy2, mask, _, _ = _scene(6, outliers=0.0)
    f = np.asarray(jep.eight_point_fundamental(xy1, xy2))
    e = np.asarray(jep.essential_from_fundamental(f, K, K))
    ref = jep.decompose_essential(e)
    got = epipolar.decompose_essential(_t(e))
    _match_candidates(got, ref, atol=1e-4)
    for r in got[0].numpy():
        assert abs(np.linalg.det(r) - 1) < 1e-4


def test_decompose_homography_candidate_set():
    xy1, xy2, mask, _, _ = _scene(7, planar=True, outliers=0.0)
    h = np.asarray(jho.dlt_homography(xy1, xy2))
    ref = jho.decompose_homography(h, K, K)
    got = homography.decompose_homography(_t(h), _t(K), _t(K))
    _match_candidates(got, ref, atol=1e-4)


def test_triangulate_and_select_pose():
    xy1, xy2, mask, r_true, t_true = _scene(8, outliers=0.0)
    pts_ref, z_ref = jtr.triangulate_dlt(xy1, xy2, r_true.astype(np.float32),
                                         t_true.astype(np.float32), K, K)
    pts, z = triangulate.triangulate_dlt(
        _t(xy1), _t(xy2), _t(r_true.astype(np.float32)),
        _t(t_true.astype(np.float32)), _t(K), _t(K))
    np.testing.assert_allclose(pts.numpy(), pts_ref, rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(z.numpy(), z_ref, rtol=1e-4, atol=1e-4)

    f = np.asarray(jep.eight_point_fundamental(xy1, xy2))
    rs, ts = jep.decompose_essential(jep.essential_from_fundamental(f, K, K))
    ref = jtr.select_pose(xy1, xy2, rs, ts, K, K, mask)
    got = triangulate.select_pose(_t(xy1), _t(xy2), _t(rs), _t(ts), _t(K),
                                  _t(K), _t(mask))
    np.testing.assert_array_equal(got[3].numpy(), np.asarray(ref[3]))
    assert int(got[4]) == int(ref[4])
    np.testing.assert_allclose(got[0].numpy(), ref[0], atol=1e-5)
    assert rotation_angle_deg(got[0].numpy(), r_true) < 1.0


def test_select_pose_ties_go_to_first():
    """All four candidates identical → every count ties → index 0."""
    xy1, xy2, mask, r_true, t_true = _scene(9, outliers=0.0)
    rs = np.repeat(r_true[None].astype(np.float32), 4, 0)
    ts = np.repeat(t_true[None].astype(np.float32), 4, 0)
    got = triangulate.select_pose(_t(xy1), _t(xy2), _t(rs), _t(ts), _t(K),
                                  _t(K), _t(mask))
    counts = got[3].numpy()
    assert (counts == counts[0]).all() and int(got[4]) == 0


@pytest.mark.parametrize("planar,model", [(False, "fundamental"),
                                          (False, "auto"), (True, "auto")])
def test_two_view_injected_samples(planar, model):
    """Same samples → same inlier set and model choice; the cheirality
    votes as a multiset (the candidate order follows the SVD's signs); the
    pose within 0.1 deg / 0.5 deg (the LO refits' f32 eigh differs in the
    last bits between the two LAPACK builds)."""
    xy1, xy2, mask, _, _ = _scene(10, planar=planar)
    key = jax.random.PRNGKey(11)
    ref = jax_two_view(key, xy1, xy2, mask, jnp.asarray(K), threshold=1.5,
                       num_samples=256, model=model, h_samples=64)
    f_idx, h_idx = jax_two_view_samples(key, mask, 256, 64)
    got = two_view_from_samples(_t(f_idx),
                                _t(h_idx) if model == "auto" else None,
                                _t(xy1), _t(xy2), _t(mask), _t(K),
                                threshold=1.5)
    assert bool(got.used_homography) == bool(ref.used_homography)
    assert bool(got.used_homography) == planar
    np.testing.assert_array_equal(got.inliers.numpy(),
                                  np.asarray(ref.inliers))
    np.testing.assert_array_equal(np.sort(got.cheirality.numpy()),
                                  np.sort(np.asarray(ref.cheirality)))
    assert rotation_angle_deg(got.r.numpy(), ref.r) < 0.1
    assert direction_angle_deg(got.t.numpy(), ref.t) < 0.5


def test_smallest_eigvec_gives_nan_for_a_non_finite_matrix():
    """jnp.linalg.eigh returns NaN for a matrix with a NaN entry, where
    torch.linalg.eigh raises for the whole batch: the port gives NaN for
    that matrix and the eigenvector for the others."""
    from photogrammetry_tpu_torch.sfm.epipolar import smallest_eigvec

    rng = np.random.default_rng(4)
    m = rng.normal(size=(3, 5, 5)).astype(np.float32)
    gram = m @ m.transpose(0, 2, 1)
    gram[1, 2, 3] = np.nan
    gram[2, 0, 0] = np.inf
    got = smallest_eigvec(_t(gram)).numpy()
    assert np.isnan(got[1:]).all() and np.isfinite(got[0]).all()
    ref = np.asarray(jnp.linalg.eigh(jnp.asarray(gram))[1][..., :, 0])
    assert np.isnan(ref[1]).all()
    assert_same_up_to_sign(got[0], ref[0], atol=1e-5)
