"""The mask algebra, launch plan and argument checks of the redesigned FAST
and Hamming kernels, on the CPU.

The CUDA kernels themselves run only on a card (``tests/test_torch_cuda.py``);
what can be held here is held here:

- the FAST kernel's bit-parallel run length, through its Python mirror
  ``fast_stencil.ring_score``, against the plain version's recurrence
  (``ops/fast.py``) for all 65,536 ring masks, and its compass pre-test
  (``fast_stencil.compass_pass``);
- the Hamming kernel's tiling (``hamming.tile_plan`` and ``TILES``), down
  to which thread of which warp stores which output from its mma fragments;
- the wrappers' refusals, reached with tensors on the ``meta`` device (no
  card needed: they are refused before anything is launched), and that CPU
  tensors still take the plain versions, which ``tests/test_torch_fast.py``
  and ``tests/test_torch_brief_match.py`` hold against the JAX package.
"""
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from _torch_threads import _one_thread  # noqa: F401
from photogrammetry_tpu_torch.kernels import brief_pack, fast_stencil, hamming
from photogrammetry_tpu_torch.ops.fast import RING_OFFSETS

ALL_MASKS = torch.arange(1 << 16)


def _plain_scores_of_every_mask():
    """The plain version's score of each 16-bit mask: a 7 x 7 image whose
    ring pixel k is 100 where bit k is set and 0 elsewhere, threshold 50, so
    that exactly the set ring pixels lie outside the band; the centre is the
    only interior pixel."""
    imgs = torch.zeros((1 << 16, 7, 7))
    for k, (dr, dc) in enumerate(RING_OFFSETS):
        imgs[:, 3 + dr, 3 + dc] = ((ALL_MASKS >> k) & 1).float() * 100.0
    return fast_stencil.fast_score_map_plain(imgs, 50.0)[:, 3, 3]


def test_ring_score_equals_the_plain_recurrence_for_every_mask():
    plain = _plain_scores_of_every_mask()
    got = fast_stencil.ring_score(ALL_MASKS)
    assert torch.equal(got, plain)
    # how many masks have a longest circular run of 12, 13, 14, 15 and 16
    assert torch.bincount(got, minlength=17)[12:].tolist() == [64, 32, 16,
                                                               16, 1]


def test_compass_pretest_never_rejects_a_mask_that_scores():
    scores = fast_stencil.ring_score(ALL_MASKS)
    passed = fast_stencil.compass_pass(ALL_MASKS)
    assert bool(passed[scores > 0].all())
    # it rejects the masks with fewer than 3 of the 4 compass bits: 11/16
    assert int((~passed).sum()) == (1 << 16) * 11 // 16


def _stored_outputs(plan: hamming.TilePlan, n1: int, n2: int):
    """(i, j) of every output of the grid's tiles, as csrc/hamming.cu's
    epilogue places its mma.m16n8k32 accumulator fragments in a block's
    output tile: lane = 4 g + t4 holds rows g and g + 8 of each 16-row
    tile and columns 2 t4, 2 t4 + 1 of each 8-column tile; those inside
    (N1, N2) are stored."""
    warps_n = plan.bn // plan.wn
    warps = (plan.bm // plan.wm) * warps_n
    w, lane, mt, half, nt, col = np.meshgrid(
        np.arange(warps), np.arange(32), np.arange(plan.wm // 16),
        np.arange(2), np.arange(plan.wn // 8), np.arange(2), indexing="ij")
    r = (w // warps_n) * plan.wm + mt * 16 + half * 8 + lane // 4
    c = (w % warps_n) * plan.wn + nt * 8 + (lane % 4) * 2 + col
    by, bx = np.meshgrid(np.arange(plan.grid_y), np.arange(plan.grid_x),
                         indexing="ij")
    i = (by.reshape(-1, 1) * plan.bm + r.reshape(1, -1)).ravel()
    j = (bx.reshape(-1, 1) * plan.bn + c.reshape(1, -1)).ravel()
    keep = (i < n1) & (j < n2)
    return i[keep], j[keep]


@pytest.mark.parametrize("n1,n2", [(1, 1), (17, 129), (512, 512),
                                   (2048, 2048), (2049, 3)])
def test_hamming_tile_plan_covers_every_output_once(n1, n2):
    plan = hamming.tile_plan(n1, n2)
    assert plan[:4] in hamming.TILES
    assert plan.grid_y * plan.bm >= n1 > (plan.grid_y - 1) * plan.bm
    assert plan.grid_x * plan.bn >= n2 > (plan.grid_x - 1) * plan.bn
    i, j = _stored_outputs(plan, n1, n2)
    count = np.zeros((n1, n2), np.int64)
    np.add.at(count, (i, j), 1)
    assert (count == 1).all()


@pytest.mark.parametrize("n,tile", [(2048, (128, 128)), (512, (32, 32))])
def test_hamming_tile_plan_fills_the_card_at_the_main_shapes(n, tile):
    plan = hamming.tile_plan(n, n)
    assert (plan.bm, plan.bn) == tile
    assert plan.grid_x * plan.grid_y >= hamming.SM_COUNT


@pytest.mark.parametrize("tile", hamming.TILES)
def test_hamming_tiles_fit_the_kernel(tile):
    bm, bn, wm, wn = tile
    assert bm % wm == 0 and bn % wn == 0
    assert wm % 16 == 0 and wn % 8 == 0         # whole m16n8k32 tiles
    threads = (bm // wm) * (bn // wn) * 32
    assert 32 <= threads <= 1024
    # one pass of both operands' rows (CHUNK_BITS columns), 16 bytes apart
    # (or, after the products, the int32 output tile, rows 8 ints apart),
    # and the row sums within a block's 227 KB of shared memory
    staged = max((bm + bn) * (hamming.CHUNK_BITS + 16), bm * (bn + 8) * 4)
    assert staged + 4 * (bm + bn) <= 232448


def test_hamming_tiles_are_the_ones_the_source_compiles():
    src = (Path(hamming.__file__).parents[1] / "csrc" / "hamming.cu")
    compiled = re.findall(r"^\s*TILE\((\d+), (\d+), (\d+), (\d+)\)$",
                          src.read_text(), re.M)
    assert tuple(tuple(map(int, t)) for t in compiled) == hamming.TILES


def test_hamming_chunk_is_the_one_the_source_stages():
    src = (Path(hamming.__file__).parents[1] / "csrc" / "hamming.cu")
    staged = re.findall(r"^constexpr int CHUNK_BITS = (\d+);", src.read_text(),
                        re.M)
    assert staged == [str(hamming.CHUNK_BITS)]
    assert hamming.CHUNK_BITS % 32 == 0          # whole k-steps a pass


@pytest.mark.parametrize("name", ["THREADS", "SMEM_LIMIT"])
def test_brief_constants_are_the_ones_the_source_uses(name):
    src = (Path(brief_pack.__file__).parents[1] / "csrc" / "brief_pack.cu")
    found = re.findall(rf"^constexpr int {name} = (\d+);", src.read_text(),
                       re.M)
    assert found == [str(getattr(brief_pack, name))]


def _meta(shape, dtype=torch.uint8):
    return torch.empty(shape, dtype=dtype, device="meta")


@pytest.mark.parametrize("case", ["shape_pair", "shape_dim", "two_devices",
                                  "dtype", "p_not_32", "p_zero", "p_too_big",
                                  "non_contiguous", "mask_shape",
                                  "mask_dtype", "device"])
def test_hamming_wrapper_refuses(case):
    b1, b2 = _meta((40, 256)), _meta((30, 256))
    args, match = (b1, b2), "unsupported device"
    if case == "shape_pair":
        args, match = (b1, _meta((30, 224))), "do not pair"
    elif case == "shape_dim":
        args, match = (b1[0], b2), "do not pair"
    elif case == "two_devices":
        args, match = (b1, torch.zeros((30, 256), dtype=torch.uint8)), \
            "two devices"
    elif case == "dtype":
        args, match = (b1, _meta((30, 256), torch.int32)), "uint8"
    elif case == "p_not_32":      # any P passes the checks
        args = (_meta((40, 48)), _meta((30, 48)))
    elif case == "p_zero":        # an empty reduction, done by the kernel
        args = (_meta((40, 0)), _meta((30, 0)))
    elif case == "p_too_big":     # past one 512-column pass
        args = (_meta((40, 544)), _meta((30, 544)))
    elif case == "non_contiguous":
        args, match = (_meta((256, 40)).t(), b2), "contiguous"
    elif case == "mask_shape":
        args, match = (b1, b2, _meta((39,), torch.bool)), "mask"
    elif case == "mask_dtype":
        args, match = (b1, b2, None, _meta((30,))), "mask"
    with pytest.raises(ValueError, match=match):
        hamming.hamming_distance_matrix(*args)


@pytest.mark.parametrize("case", ["dim", "single_dim", "dtype",
                                  "non_contiguous", "device"])
def test_fast_wrapper_refuses(case):
    imgs = _meta((2, 40, 64), torch.float32)
    fn, args, match = (fast_stencil.fast_score_map_batch, (imgs, 20.0),
                       "unsupported device")
    if case == "dim":
        args, match = (imgs[0], 20.0), "expected \\(B, H, W\\)"
    elif case == "single_dim":
        fn, args, match = (fast_stencil.fast_score_map, (imgs, 20.0),
                           "expected \\(H, W\\)")
    elif case == "dtype":
        args, match = (imgs.to(torch.float64), 20.0), "contiguous float32"
    elif case == "non_contiguous":
        args, match = (imgs.transpose(1, 2), 20.0), "contiguous float32"
    with pytest.raises(ValueError, match=match):
        fn(*args)


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("n1,n2,p", [(1, 1, 32), (17, 45, 256),
                                     (64, 33, 512)])
def test_hamming_wrapper_takes_the_plain_version_on_the_cpu(n1, n2, p,
                                                            masked):
    rng = np.random.default_rng(n1 * n2 + p)
    args = [torch.tensor(rng.integers(0, 2, (n, p)), dtype=torch.uint8)
            for n in (n1, n2)]
    if masked:
        args += [torch.tensor(rng.random(n) > 0.3) for n in (n1, n2)]
    before = hamming.hamming_distance_matrix.launches
    got = hamming.hamming_distance_matrix(*args)
    assert hamming.hamming_distance_matrix.launches == before
    assert got.dtype == torch.int32 and got.shape == (n1, n2)
    assert torch.equal(got, hamming.hamming_distance_matrix_plain(*args))
    # against popcounts of the bits taken one pair of rows at a time
    a, b = (x.numpy().astype(np.int64) for x in args[:2])
    ref = (a[:, None, :] != b[None, :, :]).sum(-1)
    if masked:
        ok = args[2].numpy()[:, None] & args[3].numpy()[None, :]
        ref = np.where(ok, ref, 2 ** 31 - 1)
    np.testing.assert_array_equal(got.numpy(), ref)


@pytest.mark.parametrize("shape", [(1, 5, 6), (2, 37, 33), (13, 20, 44)])
def test_fast_wrapper_takes_the_plain_version_on_the_cpu(shape):
    rng = np.random.default_rng(sum(shape))
    imgs = torch.tensor(rng.integers(0, 256, shape), dtype=torch.float32)
    before = fast_stencil.fast_score_map_batch.launches
    got = fast_stencil.fast_score_map_batch(imgs, 30.0)
    one = fast_stencil.fast_score_map(imgs[0], 30.0)
    assert fast_stencil.fast_score_map_batch.launches == before
    assert torch.equal(got, fast_stencil.fast_score_map_plain(imgs, 30.0))
    assert torch.equal(one, got[0])
