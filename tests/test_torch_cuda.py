"""The port's CUDA kernels against their plain PyTorch versions on the card.

Marked ``cuda``: each test skips without a card (decided inside the
fixture).  On a machine with one, and without JAX:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda.py

Every output is an integer: bit-exact.
"""
import numpy as np
import pytest
import torch

from photogrammetry_tpu_torch.kernels import brief_pack, fast_stencil, hamming

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


def test_fast_kernel_exact(dev):
    rng = np.random.default_rng(0)
    imgs = torch.tensor(rng.integers(0, 256, (3, 131, 257)), dtype=torch.float32,
                        device=dev)
    before = fast_stencil.fast_score_map_batch.launches
    got = fast_stencil.fast_score_map_batch(imgs, 30.0)
    assert fast_stencil.fast_score_map_batch.launches == before + 1
    assert torch.equal(got, fast_stencil.fast_score_map_plain(imgs, 30.0))


def test_brief_kernel_exact(dev):
    rng = np.random.default_rng(1)
    img = torch.tensor(rng.integers(0, 256, (96, 128)), dtype=torch.float32,
                       device=dev)
    coords = torch.tensor(np.stack([rng.integers(-5, 101, 300),
                                    rng.integers(-5, 133, 300)], -1),
                          dtype=torch.int32, device=dev)
    pairs = torch.tensor(np.rint(rng.normal(0, 20, (64, 2, 2))),
                         dtype=torch.int32, device=dev)
    got = brief_pack.brief_bits(img, coords, pairs)
    assert torch.equal(got, brief_pack.brief_bits_plain(img, coords, pairs))


def test_hamming_kernel_exact(dev):
    rng = np.random.default_rng(2)
    b1 = torch.tensor(rng.integers(0, 2, (77, 256)), dtype=torch.uint8,
                      device=dev)
    b2 = torch.tensor(rng.integers(0, 2, (45, 256)), dtype=torch.uint8,
                      device=dev)
    m1 = torch.tensor(rng.random(77) > 0.2, device=dev)
    m2 = torch.tensor(rng.random(45) > 0.2, device=dev)
    for args in ((b1, b2), (b1, b2, m1, m2)):
        got = hamming.hamming_distance_matrix(*args)
        assert torch.equal(got, hamming.hamming_distance_matrix_plain(*args))
