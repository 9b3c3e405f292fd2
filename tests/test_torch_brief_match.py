"""Port parity: BRIEF bits and packing, Hamming distances, mutual-nearest
matching and dense subpixel refinement.

Same numpy inputs through the JAX package (XLA ops; the Pallas kernels in
interpret mode) and photogrammetry_tpu_torch on the CPU (the kernel
wrappers' plain path).  Bits, words, distances and matches are integers:
exact.  Refinement is float: atol 1e-4 px, for f32 rounding of the same
arithmetic in another evaluation order (XLA may fuse).
"""
import jax
import numpy as np
import pytest
import torch

from _torch_threads import _one_thread  # noqa: F401
from photogrammetry_tpu.kernels.brief_pack import brief_bits_packed
from photogrammetry_tpu.kernels.hamming import hamming_distance_matrix_pallas
from photogrammetry_tpu.ops.brief import brief_bits as jax_brief
from photogrammetry_tpu.ops.brief import gaussian_pairs as jax_pairs
from photogrammetry_tpu.ops.brief import pack_bits as jax_pack
from photogrammetry_tpu.ops.match import hamming_distance_matrix as jax_ham
from photogrammetry_tpu.ops.match import mutual_nearest_matches as jax_mnn
from photogrammetry_tpu.ops.refine import refine_subpixel_dense as jax_refine
from photogrammetry_tpu_torch.kernels import brief_pack, hamming
from photogrammetry_tpu_torch.ops.brief import pack_bits
from photogrammetry_tpu_torch.ops.match import INT_INF, mutual_nearest_matches
from photogrammetry_tpu_torch.ops.refine import refine_subpixel_dense


def _border_coords(rng, n, h, w):
    """Keypoints everywhere, many within sigma of the border so that
    out-of-bounds pair endpoints occur."""
    rows = np.concatenate([rng.integers(0, 12, n // 4),
                           rng.integers(h - 12, h, n // 4),
                           rng.integers(0, h, n - n // 2)])
    cols = rng.integers(0, w, n)
    return np.stack([rows, cols], -1).astype(np.int32)


@pytest.mark.parametrize("num_pairs,sigma", [(256, 50.0), (64, 20.0)])
def test_brief_bits_exact_with_out_of_bounds(num_pairs, sigma):
    rng = np.random.default_rng(10)
    h, w = 96, 128
    img = rng.integers(0, 255, (h, w)).astype(np.float32)
    coords = _border_coords(rng, 100, h, w)
    pairs = np.asarray(jax_pairs(jax.random.PRNGKey(3), sigma, num_pairs))
    ref = np.asarray(jax_brief(img, coords, pairs))
    got = brief_pack.brief_bits(torch.tensor(img), torch.tensor(coords),
                                torch.tensor(pairs)).numpy()
    assert got.dtype == np.uint8
    np.testing.assert_array_equal(got, ref)
    # out-of-bounds pairs really occur and give 0
    p = coords[:, None, None, :] + pairs[None]
    oob = ~np.all((p >= 0) & (p < [h, w]), axis=(2, 3))
    assert oob.sum() > 100 and not got[oob].any()


def test_brief_bits_matches_pallas_kernel():
    rng = np.random.default_rng(11)
    h, w = 64, 96
    img = rng.integers(0, 255, (h, w)).astype(np.float32)
    coords = _border_coords(rng, 48, h, w)
    pairs = np.asarray(jax_pairs(jax.random.PRNGKey(4), 20.0, 64))
    ref = np.asarray(brief_bits_packed(img, coords, pairs, interpret=True))
    got = brief_pack.brief_bits(torch.tensor(img), torch.tensor(coords),
                                torch.tensor(pairs)).numpy()
    np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("p", [32, 256])
def test_pack_bits_exact(p):
    rng = np.random.default_rng(12)
    bits = rng.integers(0, 2, (37, p)).astype(np.uint8)
    bits[0] = 1  # bit 31 set in every word
    got = pack_bits(torch.tensor(bits))
    assert got.dtype == torch.uint32
    np.testing.assert_array_equal(got.numpy(), np.asarray(jax_pack(bits)))


@pytest.mark.parametrize("n1,n2", [(200, 150), (37, 129)])
def test_hamming_exact(n1, n2):
    rng = np.random.default_rng(13)
    b1 = rng.integers(0, 2, (n1, 256)).astype(np.uint8)
    b2 = rng.integers(0, 2, (n2, 256)).astype(np.uint8)
    m1 = rng.random(n1) > 0.2
    m2 = rng.random(n2) > 0.2
    got = hamming.hamming_distance_matrix(torch.tensor(b1), torch.tensor(b2))
    np.testing.assert_array_equal(got.numpy(), np.asarray(jax_ham(b1, b2)))
    np.testing.assert_array_equal(
        got.numpy(),
        np.asarray(hamming_distance_matrix_pallas(b1, b2, interpret=True)))
    got_m = hamming.hamming_distance_matrix(
        torch.tensor(b1), torch.tensor(b2), torch.tensor(m1),
        torch.tensor(m2))
    np.testing.assert_array_equal(got_m.numpy(),
                                  np.asarray(jax_ham(b1, b2, m1, m2)))
    assert (got_m.numpy() == INT_INF).any()


def _tied_distances(rng, n1, n2):
    """Small-range distances: many rows/columns with tied minima, plus
    INT_INF rows and columns."""
    d = rng.integers(0, 6, (n1, n2)).astype(np.int32)
    d[::9, :] = INT_INF
    d[:, ::11] = INT_INF
    return d


@pytest.mark.parametrize("max_ratio", [None, 0.8])
def test_mutual_nearest_matches_ties_exact(max_ratio):
    rng = np.random.default_rng(14)
    d = _tied_distances(rng, 60, 45)
    ref = jax_mnn(d, 3, max_ratio=max_ratio)
    got = mutual_nearest_matches(torch.tensor(d), 3, max_ratio=max_ratio)
    for g, r in zip(got, ref):
        np.testing.assert_array_equal(g.numpy(), np.asarray(r))
    assert got[2].any()


def test_refine_subpixel_dense_close():
    rng = np.random.default_rng(15)
    h, w = 96, 128
    yy, xx = np.mgrid[0:h, 0:w]
    img = (100 + 80 * np.sin(xx / 5.0) * np.cos(yy / 7.0)
           + rng.normal(0, 4, (h, w))).astype(np.float32)
    coords = np.stack([rng.integers(3, h - 3, 80),
                       rng.integers(3, w - 3, 80)], -1).astype(np.int32)
    ref = np.asarray(jax_refine(img, coords))
    got = refine_subpixel_dense(torch.tensor(img),
                                torch.tensor(coords)).numpy()
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-4)
    assert np.abs(got - coords).max() > 0.1  # refinement moved points
