"""Shared helpers of the tests/test_torch_*.py parity tests."""
import jax
import jax.numpy as jnp
import numpy as np


def jax_sample_idx(key, mask, num_samples, sample_size):
    """The (H, S) RANSAC sample indices the JAX package draws from ``key``
    (split -> randint -> valid_idx, sfm/epipolar.py ransac_fundamental and
    sfm/homography.py ransac_homography), as numpy int64."""
    mask = jnp.asarray(mask)
    n = mask.shape[0]
    count = jnp.maximum(jnp.sum(mask.astype(jnp.int32)), 1)
    (valid_idx,) = jnp.nonzero(mask, size=n, fill_value=0)
    keys = jax.random.split(key, num_samples)
    u = jax.vmap(lambda k: jax.random.randint(k, (sample_size,), 0,
                                              count))(keys)
    return np.asarray(valid_idx[u]).astype(np.int64)


def jax_two_view_samples(key, mask, num_samples, h_samples):
    """(F samples, H samples) of JAX two_view_pipeline(model='auto'): the H
    draws use fold_in(key, 1) (sfm/two_view.py)."""
    return (jax_sample_idx(key, mask, num_samples, 8),
            jax_sample_idx(jax.random.fold_in(key, 1), mask, h_samples, 4))


def assert_same_up_to_sign(a, b, atol):
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    s = 1.0 if np.sum(a * b) >= 0 else -1.0
    np.testing.assert_allclose(a, s * b, rtol=0, atol=atol)


def rotation_angle_deg(r1, r2):
    cos = (np.trace(np.asarray(r1) @ np.asarray(r2).T) - 1) / 2
    return float(np.degrees(np.arccos(np.clip(cos, -1, 1))))


def direction_angle_deg(t1, t2):
    t1 = np.asarray(t1, np.float64)
    t2 = np.asarray(t2, np.float64)
    c = (t1 @ t2) / (np.linalg.norm(t1) * np.linalg.norm(t2))
    return float(np.degrees(np.arccos(np.clip(c, -1, 1))))
