"""The launch plans and argument checks of the redesigned Schur, remap and
BRIEF kernels and of the Hamming kernel's batched entry, on the CPU.

The CUDA kernels themselves run only on a card (``tests/test_torch_cuda.py``);
what decides their grids is plain Python and is held here: the Schur
kernel's split of the landmark axis into slabs (``schur.split_plan``) and
the remap kernel's chunking of the frames (``remap.frame_plan``), the
Hamming kernel's tile over a batch of frame pairs (``hamming.tile_plan``
with ``batch``) and loop closure's chunks of pairs
(``loop_closure.pair_chunk``).  The
wrappers' refusals are reached with tensors on the ``meta`` device (no
card needed: they are refused before anything is launched), and CPU
tensors still take the plain versions, which ``tests/test_torch_ba.py`` and
``tests/test_torch_dewarp.py`` hold against the JAX package.
"""
import numpy as np
import pytest
import torch

from _torch_threads import _one_thread  # noqa: F401
from photogrammetry_tpu_torch.kernels import brief_pack, hamming, remap, schur
from photogrammetry_tpu_torch.ops.match import (
    INT_INF, mutual_nearest_counts, mutual_nearest_matches,
)
from photogrammetry_tpu_torch.sfm import loop_closure

SCHUR_F = (1, 5, 12, 16, 17, 201)
SCHUR_T = (0, 1, 31, 32, 33, 700, 701, 1024, 4096)


@pytest.mark.parametrize("t", SCHUR_T)
@pytest.mark.parametrize("f", SCHUR_F)
def test_schur_split_plan_covers_the_landmarks_once(f, t):
    plan = schur.split_plan(f, t)
    assert 1 <= plan.slabs <= schur.MAX_SLABS
    assert plan.slab_len >= schur.TILE_T
    assert plan.slab_len % schur.TILE_T == 0
    assert plan.scratch_shape == (plan.slabs, 6 * f, 6 * f + 1)
    # the slabs, as the kernel cuts them: in order, disjoint, none empty
    # (but the single slab of T = 0), together [0, T)
    edges = [(s * plan.slab_len, min(t, (s + 1) * plan.slab_len))
             for s in range(plan.slabs)]
    assert edges[0][0] == 0 and edges[-1][1] == t
    assert all(a[1] == b[0] for a, b in zip(edges, edges[1:]))
    assert all(lo < hi for lo, hi in edges) or (t == 0 and plan.slabs == 1)


@pytest.mark.parametrize("f,t", [(12, 1024), (16, 4096)])
def test_schur_split_plan_fills_the_card_at_the_main_shapes(f, t):
    plan = schur.split_plan(f, t)
    tiles = -(-f // schur.CAM_TILE)
    assert tiles * tiles * plan.slabs >= schur.SM_COUNT


@pytest.mark.parametrize("asked", [1, 2, 7, 16, 64, 10 ** 6])
@pytest.mark.parametrize("f,t", [(12, 1024), (5, 701), (16, 1)])
def test_schur_split_plan_takes_an_asked_number_of_slabs(f, t, asked):
    plan = schur.split_plan(f, t, asked)
    assert 1 <= plan.slabs <= min(asked, -(-t // schur.TILE_T))
    assert plan.slabs * plan.slab_len >= t
    assert (plan.slabs - 1) * plan.slab_len < t


@pytest.mark.parametrize("h,w", [(1, 1), (97, 131), (480, 640),
                                 (1080, 1920)])
@pytest.mark.parametrize("b", [1, 12, 13, 70000])
def test_remap_frame_plan_covers_the_frames_once(b, h, w):
    frame_chunk, chunks = remap.frame_plan(b, h, w)
    assert frame_chunk >= 1 and 1 <= chunks <= remap.MAX_CHUNKS
    # the chunks, as the kernel cuts them: together [0, B), none empty
    assert chunks * frame_chunk >= b > (chunks - 1) * frame_chunk
    # a full-size frame fills the card alone: the whole stack is one chunk
    # and reads the map once
    if h * w >= remap.TARGET_BLOCKS * remap.TILE_H * remap.TILE_W:
        assert (frame_chunk, chunks) == (b, 1)
    # a batch of small images is cut up until the grid comes near the
    # target (rounding the chunk length up may leave it a little short),
    # or every frame is a chunk of its own
    blocks = -(-h // remap.TILE_H) * -(-w // remap.TILE_W) * chunks
    assert (2 * blocks >= remap.TARGET_BLOCKS or frame_chunk == 1
            or chunks == remap.MAX_CHUNKS)


def _schur_meta(f=3, t=10, dtype=torch.float32):
    return [torch.empty(shape, dtype=dtype, device="meta")
            for shape in ((f, t, 6, 3), (f, t, 6, 3), (t, 3))]


@pytest.mark.parametrize("case", ["shape_w_cp", "shape_b_p", "two_devices",
                                  "dtype", "non_contiguous", "device"])
def test_schur_wrapper_refuses(case):
    w_hinv, w_cp, b_p = _schur_meta()
    if case == "shape_w_cp":
        args, match = (w_hinv, w_cp[:, :9], b_p), "pair"
    elif case == "shape_b_p":
        args, match = (w_hinv, w_cp, b_p[:, :2]), "pair"
    elif case == "two_devices":
        args, match = (w_hinv, torch.zeros(3, 10, 6, 3), b_p), "two devices"
    elif case == "dtype":
        args, match = _schur_meta(dtype=torch.float64), "contiguous float32"
    elif case == "non_contiguous":
        swapped = torch.empty((3, 10, 3, 6), device="meta").transpose(2, 3)
        args, match = (swapped, w_cp, b_p), "contiguous float32"
    else:
        args, match = (w_hinv, w_cp, b_p), "unsupported device"
    with pytest.raises(ValueError, match=match):
        schur.schur_products(*args)


@pytest.mark.parametrize("case", ["shape_images", "shape_map", "two_devices",
                                  "dtype_images", "dtype_map",
                                  "non_contiguous", "device"])
def test_remap_wrapper_refuses(case):
    imgs = torch.empty((2, 8, 9, 3), device="meta")
    dmap = torch.empty((8, 9, 2), device="meta")
    if case == "shape_images":
        args, match = (imgs[0], dmap), "want B, H, W, C"
    elif case == "shape_map":
        args, match = (imgs, dmap[..., :1]), "want H, W, 2"
    elif case == "two_devices":
        args, match = (imgs, torch.zeros(8, 9, 2)), "two devices"
    elif case == "dtype_images":
        args, match = (imgs.to(torch.float16), dmap), "float32 and uint8"
    elif case == "dtype_map":
        args, match = (imgs, dmap.to(torch.float64)), "float32 map"
    elif case == "non_contiguous":
        args, match = (imgs.transpose(1, 2), dmap), "contiguous"
    else:
        args, match = (imgs, dmap), "unsupported device"
    with pytest.raises(ValueError, match=match):
        remap.remap_bilinear(*args)


@pytest.mark.parametrize("f,t", [(1, 1), (3, 0), (5, 33)])
def test_schur_wrapper_takes_the_plain_version_on_the_cpu(f, t):
    rng = np.random.default_rng(f * 100 + t)
    args = [torch.tensor(rng.normal(size=shape), dtype=torch.float32)
            for shape in ((f, t, 6, 3), (f, t, 6, 3), (t, 3))]
    before = schur.schur_products.launches
    s, c = schur.schur_products(*args)
    s_ref, c_ref = schur.schur_products_plain(*args)
    assert schur.schur_products.launches == before
    assert torch.equal(s, s_ref) and torch.equal(c, c_ref)
    assert s.shape == (f, f, 6, 6) and c.shape == (f, 6)


@pytest.mark.parametrize("dtype", [torch.float32, torch.uint8])
@pytest.mark.parametrize("b,ch", [(1, 1), (5, 3)])
def test_remap_wrapper_takes_the_plain_version_on_the_cpu(dtype, b, ch):
    rng = np.random.default_rng(b * 10 + ch)
    imgs = torch.tensor(rng.uniform(0, 255, (b, 17, 23, ch))).to(dtype)
    dmap = torch.tensor(np.stack([rng.uniform(-2, 19, (20, 21)),
                                  rng.uniform(-2, 25, (20, 21))], -1),
                        dtype=torch.float32)
    before = remap.remap_bilinear.launches
    got = remap.remap_bilinear(imgs, dmap)
    assert remap.remap_bilinear.launches == before
    assert got.dtype == dtype and got.shape == (b, 20, 21, ch)
    assert torch.equal(got, remap.remap_bilinear_plain(imgs, dmap))
    # the frames of a stack are remapped independently of their chunking
    assert torch.equal(got[:1], remap.remap_bilinear(imgs[:1], dmap))


def _brief_meta():
    return [torch.empty((2, 8, 9), device="meta"),
            torch.empty((2, 5, 2), dtype=torch.int32, device="meta"),
            torch.empty((7, 2, 2), dtype=torch.int32, device="meta"),
            torch.empty((2, 5), dtype=torch.bool, device="meta"),
            torch.empty((2, 5, 2), device="meta")]


@pytest.mark.parametrize("case", ["dims", "coords_batch", "pairs_shape",
                                  "mask_shape", "cos_sin_shape",
                                  "two_devices", "dtype_images",
                                  "dtype_mask", "dtype_cos_sin",
                                  "non_contiguous", "device"])
def test_brief_wrapper_refuses(case):
    args, match = _brief_meta(), "unsupported device"
    imgs, coords, pairs, mask, cs = args
    if case == "dims":
        args[0], match = imgs[None], "expected"
    elif case == "coords_batch":
        args[1], match = coords[:1], "expected"
    elif case == "pairs_shape":
        args[2], match = pairs[:, :1], "expected"
    elif case == "mask_shape":
        args[3], match = mask[:, :4], "mask"
    elif case == "cos_sin_shape":
        args[4], match = cs[..., :1], "cos_sin"
    elif case == "two_devices":
        args[3], match = torch.ones((2, 5), dtype=torch.bool), "devices"
    elif case == "dtype_images":
        args[0], match = imgs.to(torch.float64), "float32 images"
    elif case == "dtype_mask":
        args[3], match = mask.to(torch.uint8), "bool mask"
    elif case == "dtype_cos_sin":
        args[4], match = cs.to(torch.float16), "float32 cos_sin"
    elif case == "non_contiguous":
        args[0] = torch.empty((2, 9, 8), device="meta").transpose(1, 2)
        match = "contiguous"
    with pytest.raises(ValueError, match=match):
        brief_pack.brief_bits(*args)


def test_brief_wrapper_takes_the_plain_version_on_the_cpu():
    rng = np.random.default_rng(3)
    imgs = torch.tensor(rng.integers(0, 256, (3, 20, 30)),
                        dtype=torch.float32)
    coords = torch.tensor(rng.integers(-3, 33, (3, 11, 2)),
                          dtype=torch.int32)
    pairs = torch.tensor(rng.integers(-6, 7, (9, 2, 2)), dtype=torch.int32)
    mask = torch.tensor(rng.random((3, 11)) > 0.3)
    cs = torch.tensor(rng.normal(size=(3, 11, 2)), dtype=torch.float32)
    before = brief_pack.brief_bits.launches
    for extra in ((), (mask,), (mask, cs)):
        got = brief_pack.brief_bits(imgs, coords, pairs, *extra)
        assert got.shape == (3, 11, 9) and got.dtype == torch.uint8
        assert torch.equal(got, brief_pack.brief_bits_plain(
            imgs, coords, pairs, *extra))
        # a frame alone is the batch of one
        assert torch.equal(brief_pack.brief_bits(
            imgs[1], coords[1], pairs, *(x[1] for x in extra)), got[1])
    assert brief_pack.brief_bits.launches == before  # no kernel on the CPU
    assert not got[~mask].any()
    assert brief_pack.SOURCE.endswith("csrc/brief_pack.cu")
    assert brief_pack.REPLACES.startswith(
        "photogrammetry_tpu/kernels/brief_pack.py")


@pytest.mark.parametrize("p", [1, 48, 256, 1024])
@pytest.mark.parametrize("n", [1, 512, 2048])
def test_brief_plan_covers_the_keypoints_and_fits_shared_memory(n, p):
    blocks = brief_pack.blocks_per_frame(n)
    kpb = brief_pack.KEYPOINTS_PER_BLOCK
    assert blocks * kpb >= n > (blocks - 1) * kpb
    assert kpb == brief_pack.THREADS // 32          # one keypoint a warp
    assert brief_pack.smem_bytes(p) <= brief_pack.SMEM_LIMIT
    # the pair table: four int arrays, P rounded up to a whole 16-byte word
    assert brief_pack.smem_bytes(p) == 16 * (-(-p // 4) * 4)


@pytest.mark.parametrize("batch", [1, 2, 7, 9, 529, 4096, 65535])
@pytest.mark.parametrize("n", [1, 17, 512, 513, 2048])
def test_hamming_batched_tile_plan_covers_and_fills_the_card(n, batch):
    plan = hamming.tile_plan(n, n, batch)
    assert plan[:4] in hamming.TILES
    assert plan.grid_y * plan.bm >= n > (plan.grid_y - 1) * plan.bm
    assert plan.grid_x * plan.bn >= n > (plan.grid_x - 1) * plan.bn
    blocks = plan.grid_x * plan.grid_y * batch
    # the largest tile that still gives every SM a block, else the smallest
    assert blocks >= hamming.SM_COUNT or plan[:4] == hamming.TILES[-1]
    bigger = [t for t in hamming.TILES if t[0] * t[1] > plan.bm * plan.bn]
    for t in bigger:
        assert -(-n // t[0]) * -(-n // t[1]) * batch < hamming.SM_COUNT
    assert hamming.tile_plan(n, n) == hamming.tile_plan(n, n, 1)


def test_hamming_batched_tile_plan_at_the_loop_shapes():
    # F = 23 and 64 frames of 512 keypoints: 529 and 4,096 pairs
    for q in (529, 4096):
        plan = hamming.tile_plan(512, 512, q)
        assert (plan.bm, plan.bn) == (128, 128)
        assert plan.grid_x * plan.grid_y * q == 16 * q
    # one pair alone keeps the single matrix's 32 x 32 tile
    assert hamming.tile_plan(512, 512, 1)[:2] == (32, 32)


@pytest.mark.parametrize("k", [1, 17, 256, 512, 513, 4096])
@pytest.mark.parametrize("budget", [1, 1 << 20, loop_closure.PAIR_BUDGET_BYTES])
def test_pair_chunk_stays_within_the_budget(k, budget, monkeypatch):
    assert loop_closure.pair_chunk(512) == 1024   # F = 23: one launch
    monkeypatch.setattr(loop_closure, "PAIR_BUDGET_BYTES", budget)
    chunk = loop_closure.pair_chunk(k)
    assert 1 <= chunk <= hamming.MAX_PAIRS
    assert chunk == 1 or chunk * k * k * 4 <= budget
    assert chunk == hamming.MAX_PAIRS or (chunk + 1) * k * k * 4 > budget


def _pairs_meta(f=3, k=8, p=32, q=5):
    return [torch.empty((f, k, p), dtype=torch.uint8, device="meta"),
            torch.empty((f, k), dtype=torch.bool, device="meta"),
            torch.empty((q,), dtype=torch.int32, device="meta"),
            torch.empty((q,), dtype=torch.int32, device="meta")]


@pytest.mark.parametrize("case", ["dims", "mask_shape", "index_shape",
                                  "two_devices", "dtype_bits", "dtype_mask",
                                  "dtype_index", "non_contiguous",
                                  "too_many_pairs", "device"])
def test_hamming_pairs_wrapper_refuses(case):
    args, match = _pairs_meta(), "unsupported device"
    bits, masks, ii, jj = args
    if case == "dims":
        args[0], match = bits[0], "do not pair"
    elif case == "mask_shape":
        args[1], match = masks[:, :7], "do not pair"
    elif case == "index_shape":
        args[3], match = jj[:4], "do not pair"
    elif case == "two_devices":
        args[2], match = torch.zeros(5, dtype=torch.int32), "two devices"
    elif case == "dtype_bits":
        args[0], match = bits.to(torch.int32), "uint8 bits"
    elif case == "dtype_mask":
        args[1], match = masks.to(torch.uint8), "bool masks"
    elif case == "dtype_index":
        args[2], match = ii.to(torch.int64), "int32 indices"
    elif case == "non_contiguous":
        args[0] = torch.empty((3, 32, 8), dtype=torch.uint8,
                              device="meta").transpose(1, 2)
        match = "contiguous"
    elif case == "too_many_pairs":
        args[2:], match = _pairs_meta(q=hamming.MAX_PAIRS + 1)[2:], "at most"
    with pytest.raises(ValueError, match=match):
        hamming.hamming_distance_matrix_pairs(*args)


@pytest.mark.parametrize("p", [1, 48, 256])
def test_hamming_pairs_wrapper_takes_the_plain_version_on_the_cpu(p):
    """Every pair, repeats and ii == jj included, equal to the single
    matrix of its two frames; no kernel launch on the CPU."""
    rng = np.random.default_rng(p)
    f, k = 5, 37
    bits = torch.tensor(rng.integers(0, 2, (f, k, p)), dtype=torch.uint8)
    masks = torch.tensor(rng.random((f, k)) > 0.25)
    masks[3] = False                                  # a frame all masked
    ii = torch.tensor([0, 1, 1, 4, 3, 2, 0], dtype=torch.int32)
    jj = torch.tensor([0, 2, 1, 0, 1, 2, 3], dtype=torch.int32)
    before = hamming.hamming_distance_matrix_pairs.launches
    got = hamming.hamming_distance_matrix_pairs(bits, masks, ii, jj)
    assert hamming.hamming_distance_matrix_pairs.launches == before
    assert got.shape == (7, k, k) and got.dtype == torch.int32
    for q, (a, b) in enumerate(zip(ii.tolist(), jj.tolist())):
        assert torch.equal(got[q], hamming.hamming_distance_matrix_plain(
            bits[a], bits[b], masks[a], masks[b]))
    assert bool((got[4] == INT_INF).all())


def test_mutual_nearest_counts_is_the_batched_match_count():
    """Ties (repeated descriptors) go to the first index on both axes, as
    mutual_nearest_matches (and jnp.argmin) break them."""
    rng = np.random.default_rng(5)
    bits = torch.tensor(rng.integers(0, 2, (4, 30, 64)), dtype=torch.uint8)
    bits[1, 10:20] = bits[0, :10]          # ties across and within frames
    bits[1, 20:25] = bits[1, 10:15]
    masks = torch.tensor(rng.random((4, 30)) > 0.1)
    idx = torch.arange(4, dtype=torch.int32)
    ii, jj = idx.repeat_interleave(4), idx.repeat(4)
    d = hamming.hamming_distance_matrix_pairs(bits, masks, ii, jj)
    for thr in (0, 20, 80):
        got = mutual_nearest_counts(d, thr)
        want = [int(mutual_nearest_matches(m, thr)[2].sum()) for m in d]
        assert got.dtype == torch.int32 and got.tolist() == want
    counts = loop_closure.pairwise_match_counts(bits, masks, 80)
    assert counts.tolist() == mutual_nearest_counts(d, 80).view(4, 4).tolist()
    # (i, j) and (j, i) take their argmins on opposite axes, and find the
    # same mutual pairs (tests/test_loop_closure.py asserts the symmetry)
    assert torch.equal(counts, counts.T)
