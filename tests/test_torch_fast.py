"""Port parity: FAST score map, keypoint extraction and static NMS.

The same numpy inputs go through the JAX package (XLA op and the Pallas
kernel in interpret mode) and through photogrammetry_tpu_torch on the CPU
(the kernel wrappers' plain path).  All integer outputs: exact.
"""
import numpy as np
import pytest
import torch

from photogrammetry_tpu.kernels.fast_stencil import (
    fast_score_map_pallas, fast_score_map_pallas_batch,
)
from photogrammetry_tpu.ops.fast import extract_keypoints as jax_extract
from photogrammetry_tpu.ops.fast import fast_score_map as jax_fast
from photogrammetry_tpu.ops.nms import compact_points as jax_compact
from photogrammetry_tpu.ops.nms import nms_keypoints_static as jax_nms
from photogrammetry_tpu_torch.kernels import fast_stencil
from photogrammetry_tpu_torch.ops.fast import extract_keypoints
from photogrammetry_tpu_torch.ops.nms import (
    compact_points, nms_keypoints_static,
)
from photogrammetry_tpu_torch.utils.padding import PaddedPoints


def _image(seed, shape):
    rng = np.random.default_rng(seed)
    # noise with saturated rows: corners, edges and equal-valued runs
    img = rng.integers(0, 255, shape).astype(np.float32)
    img[..., ::7, :] = 255.0
    return img


@pytest.mark.parametrize("thr", [20.0, 30.0, 50.0])
def test_fast_score_map_exact(thr):
    img = _image(1, (120, 160))
    got = fast_stencil.fast_score_map(torch.from_numpy(img), thr).numpy()
    np.testing.assert_array_equal(got, np.asarray(jax_fast(img, thr)))
    np.testing.assert_array_equal(
        got, np.asarray(fast_score_map_pallas(img, thr, interpret=True)))
    assert (got > 0).sum() > 50


def test_fast_threshold_band_edges_exact():
    """Ring pixels exactly at c +- thr (and a fractional threshold) hit the
    <= / >= band edges formed in f32."""
    rng = np.random.default_rng(2)
    img = (rng.integers(0, 8, (64, 96)) * 12.5).astype(np.float32)
    for thr in (12.5, 25.0, 37.3):
        got = fast_stencil.fast_score_map(torch.from_numpy(img), thr).numpy()
        np.testing.assert_array_equal(got, np.asarray(jax_fast(img, thr)))


def test_fast_score_map_batch_exact():
    imgs = np.stack([_image(3, (72, 100)), _image(4, (72, 100))])
    got = fast_stencil.fast_score_map_batch(torch.from_numpy(imgs),
                                            30.0).numpy()
    ref = np.asarray(fast_score_map_pallas_batch(imgs, 30.0, interpret=True))
    np.testing.assert_array_equal(got, ref)
    for b in range(2):
        np.testing.assert_array_equal(got[b], np.asarray(jax_fast(imgs[b],
                                                                  30.0)))


@pytest.mark.parametrize("capacity", [64, 128])
def test_extract_keypoints_score_order_exact(capacity):
    img = _image(5, (120, 160))
    score = np.asarray(jax_fast(img, 30.0))
    ref = jax_extract(score, capacity=capacity, order="score")
    got = extract_keypoints(torch.tensor(score), capacity)
    for name in PaddedPoints._fields:
        np.testing.assert_array_equal(getattr(got, name).numpy(),
                                      np.asarray(getattr(ref, name)), name)


def test_extract_keypoints_fewer_than_capacity_exact():
    """Fill entries (past the count) follow lax.top_k's lower-index tie."""
    score = np.zeros((40, 50), np.int32)
    score[10, 12] = 13
    score[20, 30] = 16
    score[5, 5] = 13
    ref = jax_extract(score, capacity=16, order="score")
    got = extract_keypoints(torch.tensor(score), 16)
    for name in PaddedPoints._fields:
        np.testing.assert_array_equal(getattr(got, name).numpy(),
                                      np.asarray(getattr(ref, name)), name)


@pytest.mark.parametrize("radius", [4.0, 10.0])
def test_nms_static_and_compact_exact(radius):
    img = _image(6, (120, 160))
    score = np.asarray(jax_fast(img, 20.0))
    ref = jax_compact(jax_nms(jax_extract(score, capacity=128,
                                          order="score"), radius), 128)
    got = compact_points(nms_keypoints_static(
        extract_keypoints(torch.tensor(score), 128), radius), 128)
    for name in PaddedPoints._fields:
        np.testing.assert_array_equal(getattr(got, name).numpy(),
                                      np.asarray(getattr(ref, name)), name)
    assert 0 < int(got.count) < 128
