"""Port parity on non-finite input: every decomposition on the SfM,
two-view and loop paths gives NaN for a batch item with a NaN entry, as
the JAX package's ``jnp.linalg`` calls do, where ``torch.linalg`` raises
for the whole batch; the other items keep their bits.

``dlt_pnp`` is the case that crashed a whole SfM run: a NaN landmark
weighted by 0 still puts NaN into a RANSAC-PnP refit's Gram matrix, whose
null vector is NaN, and the SVD after it raised.  Each repaired call gets
one case here: ``eight_point_fundamental`` and ``decompose_essential``
(sfm/epipolar.py), ``dlt_homography``, ``homography_residuals`` and
``decompose_homography`` (sfm/homography.py), ``align_umeyama``
(sfm/metrics.py), ``rotation_from_bearings`` (sfm/loop_closure.py) and
incremental SfM's two-view ``_triangulate_tracks``.

Tolerances: NaN exactly where JAX has NaN; finite values as the port's
existing parity tests hold them (poses 1e-3 as tests/test_torch_pnp.py,
F up to sign 1e-3, H 1e-4, landmarks 1e-4 relative);
the other batch items bit-equal to a run without the bad item.  Only NaN
is used: LAPACK's SVD on an infinite entry does not return in JAX.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import assert_same_up_to_sign, jax_pnp_samples
from _torch_threads import _one_thread  # noqa: F401
from photogrammetry_tpu.sfm import epipolar as jep
from photogrammetry_tpu.sfm import homography as jhom
from photogrammetry_tpu.sfm import incremental as jinc
from photogrammetry_tpu.sfm import loop_closure as jloop
from photogrammetry_tpu.sfm import metrics as jmetrics
from photogrammetry_tpu.sfm import pnp as jpnp
from photogrammetry_tpu_torch.sfm import epipolar as ep
from photogrammetry_tpu_torch.sfm import homography as hom
from photogrammetry_tpu_torch.sfm import incremental as inc
from photogrammetry_tpu_torch.sfm import loop_closure as loop
from photogrammetry_tpu_torch.sfm import metrics
from photogrammetry_tpu_torch.sfm import pnp
from photogrammetry_tpu_torch.sfm.tracks import TrackTable

K = np.array([[500.0, 0, 320], [0, 500.0, 240], [0, 0, 1]], np.float32)


def _t(x):
    return torch.tensor(np.asarray(x))


def _rot(rng, scale=0.2):
    w = rng.normal(size=3) * scale
    th = np.linalg.norm(w)
    kx = np.array([[0, -w[2], w[1]], [w[2], 0, -w[0]], [-w[1], w[0], 0]])
    return (np.eye(3) + np.sin(th) / th * kx
            + (1 - np.cos(th)) / th ** 2 * kx @ kx).astype(np.float32)


def _scene(rng, n=40):
    """n world points in front of a camera at pose (r, t), their pixels."""
    pts = rng.uniform([-1, -1, 4], [1, 1, 6], (n, 3)).astype(np.float32)
    r = _rot(rng)
    t = rng.normal(size=3).astype(np.float32) * 0.1
    pc = pts @ r.T + t
    xy = (pc[:, :2] / pc[:, 2:]) * 500.0 + np.array([320, 240])
    return pts, xy.astype(np.float32), r, t


def _nan_like_jax(got, want, atol):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    ok = ~np.isnan(want)
    np.testing.assert_allclose(got[ok], want[ok], rtol=0, atol=atol)


def _pnp_batch(rng):
    """Four DLT problems of 16 correspondences; item 2 gets a NaN
    point."""
    pts, xn = [], []
    for _ in range(4):
        p, xy, _, _ = _scene(rng, 16)
        pts.append(p)
        xn.append((xy - [320, 240]) / 500.0)
    pts = np.stack(pts).astype(np.float32)
    xn = np.stack(xn).astype(np.float32)
    bad = pts.copy()
    bad[2, 3, 1] = np.nan
    return pts, xn, bad


def test_dlt_pnp_nan_item_gives_nan_as_jax(seed=0):
    rng = np.random.default_rng(seed)
    pts, xn, bad = _pnp_batch(rng)
    r, t = pnp.dlt_pnp(_t(bad), _t(xn))              # raised before
    jr, jt = jax.vmap(jpnp.dlt_pnp)(jnp.asarray(bad), jnp.asarray(xn))
    assert torch.isnan(r[2]).all() and torch.isnan(t[2]).all()
    assert np.isnan(np.asarray(jr[2])).all()
    assert np.isnan(np.asarray(jt[2])).all()
    keep = [0, 1, 3]
    r0, t0 = pnp.dlt_pnp(_t(pts[keep]), _t(xn[keep]))
    assert torch.equal(r[keep], r0) and torch.equal(t[keep], t0)
    np.testing.assert_allclose(r[keep].numpy(), np.asarray(jr)[keep],
                               atol=1e-3)
    np.testing.assert_allclose(t[keep].numpy(), np.asarray(jt)[keep],
                               atol=1e-3)


def test_ransac_pnp_refit_through_a_nan_landmark():
    """A masked NaN landmark reaches the refit's Gram matrix: the refit's
    pose is NaN and is not kept; the winner is JAX's (its draws
    injected)."""
    rng = np.random.default_rng(1)
    pts, xy, r_true, t_true = _scene(rng, 40)
    mask = np.ones(40, bool)
    pts[5] = np.nan
    mask[5] = False
    key = jax.random.PRNGKey(3)
    idx = jax_pnp_samples(key, mask, 64)
    got = pnp.ransac_pnp(_t(idx), _t(pts), _t(xy), _t(mask), _t(K))
    ref = jpnp.ransac_pnp(key, jnp.asarray(pts), jnp.asarray(xy),
                          jnp.asarray(mask), jnp.asarray(K),
                          num_samples=64)
    assert torch.isfinite(got.r).all() and torch.isfinite(got.t).all()
    np.testing.assert_array_equal(got.inliers.numpy(),
                                  np.asarray(ref.inliers))
    np.testing.assert_allclose(got.r.numpy(), np.asarray(ref.r), atol=1e-3)
    np.testing.assert_allclose(got.t.numpy(), np.asarray(ref.t), atol=1e-3)
    np.testing.assert_allclose(got.r.numpy(), r_true, atol=1e-2)


def _two_view(rng, n=30):
    pts, xy1, _, _ = _scene(rng, n)
    r, t = _rot(rng, 0.05), np.array([0.3, 0.0, 0.05], np.float32)
    pc = pts @ r.T + t
    xy2 = ((pc[:, :2] / pc[:, 2:]) * 500.0 + [320, 240]).astype(np.float32)
    return xy1, xy2


def test_eight_point_fundamental_nan_item():
    rng = np.random.default_rng(2)
    xy1 = np.stack([_two_view(rng)[0][:8] for _ in range(3)])
    xy2 = xy1 + rng.normal(size=xy1.shape).astype(np.float32) * 5
    xy1[1, 4, 0] = np.nan
    f = ep.eight_point_fundamental(_t(xy1), _t(xy2))
    jf = jax.vmap(jep.eight_point_fundamental)(jnp.asarray(xy1),
                                               jnp.asarray(xy2))
    assert torch.isnan(f[1]).all() and np.isnan(np.asarray(jf[1])).all()
    f0 = ep.eight_point_fundamental(_t(xy1[[0, 2]]), _t(xy2[[0, 2]]))
    assert torch.equal(f[[0, 2]], f0)
    for i in (0, 2):
        assert_same_up_to_sign(f[i].numpy(), np.asarray(jf[i]), atol=1e-3)


def test_decompose_essential_nan():
    e = np.full((3, 3), np.nan, np.float32)
    rs, ts = ep.decompose_essential(_t(e))
    jrs, jts = jep.decompose_essential(jnp.asarray(e))
    _nan_like_jax(rs.numpy(), np.asarray(jrs), 0)
    _nan_like_jax(ts.numpy(), np.asarray(jts), 0)


def test_homography_nan_items():
    """``dlt_homography`` (its denormalizing solve), the residuals' inverse
    and ``decompose_homography``'s solve and SVD."""
    rng = np.random.default_rng(4)
    xy1 = rng.uniform(0, 640, (3, 40, 2)).astype(np.float32)
    h_true = np.array([[1.02, 0.01, 5.0], [-0.01, 0.98, -3.0],
                       [1e-5, 2e-5, 1.0]], np.float32)
    p = np.concatenate([xy1, np.ones_like(xy1[..., :1])], -1) @ h_true.T
    xy2 = (p[..., :2] / p[..., 2:]).astype(np.float32)
    xy1[1, 2, 1] = np.nan
    h = hom.dlt_homography(_t(xy1), _t(xy2))
    jh = jax.vmap(jhom.dlt_homography)(jnp.asarray(xy1), jnp.asarray(xy2))
    assert torch.isnan(h[1]).all() and np.isnan(np.asarray(jh[1])).all()
    for i in (0, 2):
        assert_same_up_to_sign(h[i].numpy(), np.asarray(jh[i]), atol=1e-4)

    pts = rng.uniform(0, 640, (10, 2)).astype(np.float32)
    singular = np.array([[1, 1, 0], [1, 1, 0], [0, 0, 1]], np.float32)
    for bad in (np.full((3, 3), np.nan, np.float32), singular):
        res = hom.homography_residuals(_t(bad), _t(pts), _t(pts))
        jres = jhom.homography_residuals(jnp.asarray(bad), jnp.asarray(pts),
                                         jnp.asarray(pts))
        assert not np.isfinite(res.numpy()).any()
        assert not np.isfinite(np.asarray(jres)).any()

    hn = np.full((3, 3), np.nan, np.float32)
    out = hom.decompose_homography(_t(hn), _t(K), _t(K))
    jout = jhom.decompose_homography(jnp.asarray(hn), jnp.asarray(K),
                                     jnp.asarray(K))
    for a, b in zip(out, jout):
        assert torch.isnan(a).all() and np.isnan(np.asarray(b)).all()


def test_align_umeyama_nan_trajectory():
    rng = np.random.default_rng(5)
    gt = rng.normal(size=(6, 3)).astype(np.float32)
    est = gt * 2.0 + 1.0
    est[3, 0] = np.nan
    s, r, t = metrics.align_umeyama(_t(est), _t(gt))
    js, jr, jt = jmetrics.align_umeyama(jnp.asarray(est), jnp.asarray(gt))
    for a, b in ((s, js), (r, jr), (t, jt)):
        _nan_like_jax(a.numpy(), np.asarray(b), 0)
    ate = metrics.absolute_trajectory_error(_t(est), _t(gt))
    assert torch.isnan(ate)


def test_rotation_from_bearings_nan_pixel():
    rng = np.random.default_rng(6)
    xy1 = rng.uniform(0, 640, (20, 2)).astype(np.float32)
    xy2 = xy1 + 3.0
    xy1[7] = np.nan
    mask = np.ones(20, bool)
    r, kept = loop.rotation_from_bearings(_t(xy1), _t(xy2), _t(mask), _t(K))
    jr, jkept = jloop.rotation_from_bearings(jnp.asarray(xy1),
                                             jnp.asarray(xy2),
                                             jnp.asarray(mask),
                                             jnp.asarray(K))
    _nan_like_jax(r.numpy(), np.asarray(jr), 0)
    assert int(kept) == int(jkept)


def test_triangulate_tracks_nan_observation():
    """The two-view DLT triangulation (``nview_triangulation=False``): a
    track with a NaN observation gets no landmark, as in JAX; the other
    tracks' landmarks are JAX's."""
    rng = np.random.default_rng(7)
    pts, xy0, r0, t0 = _scene(rng, 12)
    r1, t1 = r0 @ _rot(rng, 0.05), t0 + np.array([0.3, 0, 0], np.float32)
    pc = pts @ r1.T + t1
    xy1 = ((pc[:, :2] / pc[:, 2:]) * 500.0 + [320, 240]).astype(np.float32)
    obs = np.stack([xy0, xy1]).astype(np.float32)
    obs[1, 4] = np.nan
    fields = dict(obs=obs, obs_mask=np.ones((2, 12), bool),
                  points=np.zeros((12, 3), np.float32),
                  has_point=np.zeros(12, bool),
                  kp_track=np.full(12, -1, np.int32),
                  num_tracks=np.int32(12), dropped=np.int32(0))
    rs = np.stack([r0, r1]).astype(np.float32)
    ts = np.stack([t0, t1]).astype(np.float32)
    first, last = np.zeros(12, np.int32), np.ones(12, np.int32)
    got = inc._triangulate_tracks(
        TrackTable(**{k: _t(v) for k, v in fields.items()}), _t(rs),
        _t(ts), _t(K), _t(first), _t(last), 1e-3, 1e3)
    ref = jinc._triangulate_tracks(
        jinc.TrackTable(**{k: jnp.asarray(v) for k, v in fields.items()}),
        jnp.asarray(rs), jnp.asarray(ts), jnp.asarray(K), jnp.asarray(first),
        jnp.asarray(last), 1e-3, 1e3)
    np.testing.assert_array_equal(got.has_point.numpy(),
                                  np.asarray(ref.has_point))
    assert not bool(got.has_point[4])
    hp = got.has_point.numpy()
    np.testing.assert_allclose(got.points.numpy()[hp],
                               np.asarray(ref.points)[hp], rtol=1e-4,
                               atol=1e-4)
    np.testing.assert_allclose(got.points.numpy()[hp], pts[hp], atol=1e-2)


@pytest.mark.parametrize("fn", [ep.svd_or_nan, ep.inv_or_nan,
                                lambda a: ep.solve_or_nan(a, a)])
def test_nan_helpers_keep_finite_items_bitwise(fn):
    """The helpers give the plain call's bits for every finite item."""
    rng = np.random.default_rng(8)
    a = _t(rng.normal(size=(5, 3, 3)).astype(np.float32))
    bad = a.clone()
    bad[3, 1, 1] = float("nan")
    got, want = fn(bad), fn(a)
    for g, w in zip(got if isinstance(got, tuple) else (got,),
                    want if isinstance(want, tuple) else (want,)):
        assert torch.equal(g[[0, 1, 2, 4]], w[[0, 1, 2, 4]])
        assert torch.isnan(g[3]).all()
