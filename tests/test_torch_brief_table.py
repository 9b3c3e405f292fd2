"""Port parity: the BRIEF pair table and the random stream behind it.

``ops/brief.gaussian_pairs`` and ``sfm/frontend.make_pairs`` draw the
table with ``utils/prng.py``, JAX's threefry stream and normal transform
in numpy.  Exact: the raw key of ``PRNGKey(seed)``, the threefry words
(``jax.random.bits``) and the integer table for seeds
0-31, P of 48, 256 and 1024 and sigma of 30 and 50.  The uniforms are
exact on the normal transform's range; the normals themselves
are held to a few ulp: XLA fuses some of the erf_inv
polynomial's products into FMAs, which numpy does not.
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from _torch_threads import _one_thread  # noqa: F401
from photogrammetry_tpu.ops.brief import gaussian_pairs as jax_pairs
from photogrammetry_tpu.sfm import frontend as jfront
from photogrammetry_tpu_torch.ops.brief import gaussian_pairs
from photogrammetry_tpu_torch.sfm import frontend
from photogrammetry_tpu_torch.utils import prng


@pytest.mark.parametrize("seed", [0, 1, 5, 12345, 2 ** 31 - 1, -1, -7])
def test_prng_key_equals_jax(seed):
    np.testing.assert_array_equal(
        prng.prng_key(seed),
        np.asarray(jax.random.key_data(jax.random.PRNGKey(seed))))


def test_prng_key_refuses_wider_seeds():
    with pytest.raises(ValueError, match="int32"):
        prng.prng_key(2 ** 31)


@pytest.mark.parametrize("shape", [(1,), (7, 3, 5), (1000,), (256, 2, 2)])
def test_threefry_words_equal_jax_bits(shape):
    for seed in (0, 3, 99):
        got = prng.random_bits(prng.prng_key(seed), shape)
        ref = np.asarray(jax.random.bits(jax.random.PRNGKey(seed), shape,
                                         dtype=np.uint32))
        assert got.dtype == np.uint32 and got.shape == shape
        np.testing.assert_array_equal(got, ref)


def test_threefry2x32_known_answer():
    """The Threefry-2x32 (20 rounds) test vector of the Random123 suite,
    as JAX's own tests pin it."""
    key = np.array([0x13198A2E, 0x03707344], np.uint32)
    x = prng.threefry2x32(key, np.array([0x243F6A88], np.uint32),
                          np.array([0x85A308D3], np.uint32))
    assert [int(x[0][0]), int(x[1][0])] == [0xC4923A9C, 0x483DF7A0]


@pytest.mark.parametrize("lo,hi,ulps", [
    (0.0, 1.0, 0),
    (float(np.nextafter(np.float32(-1), np.float32(0))), 1.0, 0),
    (-2.5, 7.0, 1)])
def test_uniform_equals_jax(lo, hi, ulps):
    """Exact on [0, 1) and on the normal transform's range (a scale of
    2.0: the product is exact, so XLA's fused multiply-add rounds as
    numpy's two steps do); elsewhere within an ulp of the range's
    largest magnitude."""
    for seed in range(4):
        got = prng.uniform(prng.prng_key(seed), (4096,), lo, hi)
        ref = np.asarray(jax.random.uniform(jax.random.PRNGKey(seed),
                                            (4096,), minval=lo, maxval=hi))
        ulp = np.spacing(np.float32(max(abs(lo), abs(hi))))
        assert np.all(np.abs(got - ref) <= ulps * ulp)


def test_normal_within_a_few_ulp_of_jax():
    for seed in range(4):
        got = prng.normal(prng.prng_key(seed), (8192,))
        ref = np.asarray(jax.random.normal(jax.random.PRNGKey(seed),
                                           (8192,)))
        assert got.dtype == np.float32
        ulp = np.spacing(np.abs(ref).astype(np.float32))
        assert np.all(np.abs(got - ref) <= 4 * ulp)
        assert np.mean(got == ref) > 0.9


@pytest.mark.parametrize("num_pairs", [48, 256, 1024])
@pytest.mark.parametrize("sigma", [30.0, 50.0])
def test_pair_table_equals_jax(num_pairs, sigma):
    """Seeds 0-31: the port's table is JAX's, entry for entry."""
    for seed in range(32):
        got = gaussian_pairs(seed, sigma, num_pairs, device="cpu")
        ref = np.asarray(jax_pairs(jax.random.PRNGKey(seed), sigma,
                                   num_pairs))
        assert got.dtype == torch.int32 and got.shape == (num_pairs, 2, 2)
        np.testing.assert_array_equal(got.numpy(), ref, err_msg=str(seed))


@pytest.mark.parametrize("kw", [{}, dict(pair_seed=3, num_pairs=512),
                                dict(pair_seed=11, brief_sigma=30.0,
                                     num_pairs=48)])
def test_make_pairs_equals_jax_make_pairs(kw):
    jcfg = jfront.FrontendConfig(**kw)
    cfg = frontend.FrontendConfig(**{
        k: v for k, v in dataclasses.asdict(jcfg).items()
        if not k.startswith("use_pallas")})
    got = frontend.make_pairs(cfg, device="cpu")
    np.testing.assert_array_equal(got.numpy(),
                                  np.asarray(jfront.make_pairs(jcfg)))


def test_pair_table_raises_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is valid")
    with pytest.raises(RuntimeError, match="CUDA"):
        gaussian_pairs(0)
    with pytest.raises(RuntimeError, match="CUDA"):
        frontend.make_pairs(frontend.FrontendConfig())
