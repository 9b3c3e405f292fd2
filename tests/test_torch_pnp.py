"""Port parity: sfm/pnp.py.

DLT-PnP on the same correspondences in both packages, and RANSAC PnP with
the JAX package's own draws injected (``jax_pnp_samples`` reproduces
them): the same inlier set, exactly, and the same pose within 1e-3 (the
12x12 f32 eigh and 3x3 SVD run in two LAPACK builds).  The port's own
draws (``draw_pnp_samples``) are checked for what they promise.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import jax_pnp_samples, rotation_angle_deg
from _torch_threads import _one_thread  # noqa: F401
from photogrammetry_tpu.core.camera import normalize_pixels as jnorm
from photogrammetry_tpu.sfm import pnp as jpnp
from photogrammetry_tpu_torch.sfm import pnp

K = np.array([[520.0, 0, 320], [0, 520.0, 240], [0, 0, 1]], np.float32)


def _scene(seed, n=120, outliers=0.25, noise=0.3):
    """World points, a pose, and their noisy pixels with gross outliers."""
    rng = np.random.default_rng(seed)
    pts = np.concatenate([rng.uniform(-2, 2, (n, 2)), rng.uniform(4, 8, (n, 1))],
                         1).astype(np.float32)
    w = rng.normal(0, 0.1, 3)
    th = np.linalg.norm(w)
    kx = np.array([[0, -w[2], w[1]], [w[2], 0, -w[0]], [-w[1], w[0], 0]]) / th
    r = np.eye(3) + np.sin(th) * kx + (1 - np.cos(th)) * kx @ kx
    t = rng.normal(0, 0.3, 3)
    pc = pts @ r.T + t
    xy = pc[:, :2] / pc[:, 2:] * 520 + [320, 240]
    xy += rng.normal(0, noise, xy.shape)
    bad = rng.random(n) < outliers
    xy[bad] += rng.uniform(20, 60, (bad.sum(), 2))
    mask = rng.random(n) > 0.1
    return (pts, xy.astype(np.float32), mask, r.astype(np.float32),
            t.astype(np.float32))


@pytest.mark.parametrize("seed", [0, 1])
def test_dlt_pnp_matches_jax(seed):
    pts, xy, _, r_gt, _ = _scene(seed, outliers=0.0, noise=0.0)
    xn = np.asarray(jnorm(jnp.asarray(xy), jnp.asarray(K)))
    w = (np.random.default_rng(seed).random(len(pts)) > 0.3).astype(
        np.float32)
    for weights in (None, w):
        jr, jt = jpnp.dlt_pnp(jnp.asarray(pts), jnp.asarray(xn),
                              None if weights is None
                              else jnp.asarray(weights))
        r, t = pnp.dlt_pnp(torch.tensor(pts), torch.tensor(xn),
                           None if weights is None else torch.tensor(weights))
        np.testing.assert_allclose(r.numpy(), np.asarray(jr), atol=1e-3)
        np.testing.assert_allclose(t.numpy(), np.asarray(jt), atol=1e-3)
        assert rotation_angle_deg(r.numpy(), r_gt) < 0.05
    # a batch of hypotheses equals one call per hypothesis
    idx = np.random.default_rng(seed).integers(0, len(pts), (4, 6))
    rb, tb = pnp.dlt_pnp(torch.tensor(pts[idx]), torch.tensor(xn[idx]))
    for h in range(4):
        r1, t1 = pnp.dlt_pnp(torch.tensor(pts[idx[h]]),
                             torch.tensor(xn[idx[h]]))
        np.testing.assert_allclose(rb[h].numpy(), r1.numpy(), atol=1e-5)
        np.testing.assert_allclose(tb[h].numpy(), t1.numpy(), atol=1e-4)


def test_reprojection_errors_match_jax():
    pts, xy, _, r, t = _scene(3)
    err, z = pnp.pnp_reprojection_errors(torch.tensor(r), torch.tensor(t),
                                         torch.tensor(pts), torch.tensor(xy),
                                         torch.tensor(K))
    jerr, jz = jpnp.pnp_reprojection_errors(r, t, pts, xy, K)
    np.testing.assert_allclose(err.numpy(), np.asarray(jerr), rtol=1e-5,
                               atol=1e-4)
    np.testing.assert_allclose(z.numpy(), np.asarray(jz), rtol=1e-6)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_ransac_pnp_with_jax_draws(seed):
    pts, xy, mask, r_gt, _ = _scene(seed)
    key = jax.random.PRNGKey(seed)
    ref = jpnp.ransac_pnp(key, jnp.asarray(pts), jnp.asarray(xy),
                          jnp.asarray(mask), jnp.asarray(K), threshold=4.0,
                          num_samples=128)
    idx = jax_pnp_samples(key, mask, 128)
    got = pnp.ransac_pnp(torch.tensor(idx), torch.tensor(pts),
                         torch.tensor(xy), torch.tensor(mask),
                         torch.tensor(K), threshold=4.0)
    np.testing.assert_array_equal(got.inliers.numpy(),
                                  np.asarray(ref.inliers))
    assert int(got.num_inliers) == int(ref.num_inliers) > 50
    np.testing.assert_allclose(got.r.numpy(), np.asarray(ref.r), atol=1e-3)
    np.testing.assert_allclose(got.t.numpy(), np.asarray(ref.t), atol=1e-3)
    assert rotation_angle_deg(got.r.numpy(), r_gt) < 1.0


def test_draw_pnp_samples_without_replacement():
    gen = torch.Generator().manual_seed(0)
    mask = torch.zeros(50, dtype=torch.bool)
    mask[torch.tensor([3, 7, 9, 20, 21, 33, 40, 41])] = True
    idx = pnp.draw_pnp_samples(gen, mask, 200)
    assert idx.shape == (200, 6)
    assert mask[idx].all()                       # only valid rows
    assert all(len(set(row.tolist())) == 6 for row in idx)
    # with fewer than 6 valid rows the invalid ones fill in, lowest first
    few = torch.zeros(50, dtype=torch.bool)
    few[[5, 9]] = True
    idx = pnp.draw_pnp_samples(gen, few, 3)
    assert (idx[:, :2].sort(-1).values == torch.tensor([5, 9])).all()
    assert (idx[:, 2:] == torch.tensor([0, 1, 2, 3])).all()
