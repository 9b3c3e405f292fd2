"""The launch plans and argument checks of the redesigned Schur, remap and
BRIEF kernels, on the CPU.

The CUDA kernels themselves run only on a card (``tests/test_torch_cuda.py``);
what decides their grids is plain Python and is held here: the Schur
kernel's split of the landmark axis into slabs (``schur.split_plan``) and
the remap kernel's chunking of the frames (``remap.frame_plan``).  The
wrappers' refusals are reached with tensors on the ``meta`` device (no
card needed: they are refused before anything is launched), and CPU
tensors still take the plain versions, which ``tests/test_torch_ba.py`` and
``tests/test_torch_dewarp.py`` hold against the JAX package.
"""
import numpy as np
import pytest
import torch

from photogrammetry_tpu_torch.kernels import brief_pack, remap, schur

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
