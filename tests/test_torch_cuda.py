"""The port's CUDA kernels against their plain PyTorch versions on the card.

Marked ``cuda``: each test skips without a card (decided inside the
fixture).  On a machine with one, and without JAX:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda.py

FAST, BRIEF and Hamming outputs are integers: bit-exact.  The Schur
products are f32 sums of 3T terms taken in another order than the plain
einsums: within the worst-case bound ``schur.error_bound``.  The remap
kernel repeats its plain version's f32 arithmetic operation for operation
(no FMA): bit-exact for float32 and uint8.  The fused SfM step, captured
as CUDA graphs and replayed, gives the eager staged run's bits.
"""
import numpy as np
import pytest
import torch

from _torch_threads import _one_thread  # noqa: F401
from photogrammetry_tpu_torch.kernels import (
    brief_pack, fast_stencil, hamming, remap, schur,
)
from photogrammetry_tpu_torch.ops.dewarp import (
    generate_distortion_map, make_distortion_applier,
)

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


def _brief_inputs(dev, b, n, p, seed, h=96, w=128):
    """Frames, ragged-masked coords reaching past every border, pairs and
    (cos, sin) with rint ties: (0.5, 0.5) and (1.5, 0) put the rotated
    offsets of odd sums on .5, beside random angles."""
    rng = np.random.default_rng(seed)
    imgs = torch.tensor(rng.integers(0, 256, (b, h, w)), dtype=torch.float32,
                        device=dev)
    coords = torch.tensor(np.stack([rng.integers(-5, h + 5, (b, n)),
                                    rng.integers(-5, w + 5, (b, n))], -1),
                          dtype=torch.int32, device=dev)
    mask = torch.tensor(np.arange(n)[None] < rng.integers(0, n + 1, (b, 1)),
                        device=dev)
    pairs = torch.tensor(np.rint(rng.normal(0, 20, (p, 2, 2))),
                         dtype=torch.int32, device=dev)
    theta = rng.uniform(0, 2 * np.pi, (b, n))
    cs = np.stack([np.cos(theta), np.sin(theta)], -1)
    cs[:, ::3] = (0.5, 0.5)
    cs[:, 1::5] = (1.5, 0.0)
    return imgs, coords, mask, pairs, torch.tensor(cs, dtype=torch.float32,
                                                   device=dev)


@pytest.mark.parametrize("p", [1, 48, 50, 256, 1024])
@pytest.mark.parametrize("steered", [False, True])
def test_brief_kernel_batched_masked(dev, p, steered):
    imgs, coords, mask, pairs, cs = _brief_inputs(dev, 3, 301, p, seed=p)
    cs = cs if steered else None
    ref = brief_pack.brief_bits_plain(imgs, coords, pairs, mask, cs)
    assert ref.any() and not ref[~mask].any()
    before = brief_pack.brief_bits.launches
    got = brief_pack.brief_bits(imgs, coords, pairs, mask, cs)
    torch.cuda.synchronize()
    assert brief_pack.brief_bits.launches == before + 1
    assert torch.equal(got, ref)    # 301 % 8: warps without a keypoint


def test_brief_kernel_single_frame_and_probe(dev):
    imgs, coords, mask, pairs, cs = _brief_inputs(dev, 1, 77, 64, seed=3)
    got = brief_pack.brief_bits(imgs[0], coords[0], pairs,
                                cos_sin=cs[0])
    assert got.shape == (77, 64)
    assert torch.equal(got, brief_pack.brief_bits_plain(
        imgs[0], coords[0], pairs, cos_sin=cs[0]))
    before = brief_pack.brief_bits.launches
    words = brief_pack.gather_probe(imgs, coords, pairs, mask)
    torch.cuda.synchronize()
    assert brief_pack.brief_bits.launches == before     # not counted
    assert words.shape == (brief_pack.blocks_per_frame(77) * 256,)


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


def _bits(dev, n, p, seed, high=2):
    gen = torch.Generator(device=dev).manual_seed(seed)
    return torch.randint(0, high, (n, p), generator=gen,
                         device=dev).to(torch.uint8)


def _masks(dev, n1, n2, seed):
    gen = torch.Generator(device=dev).manual_seed(seed)
    return (torch.rand(n1, generator=gen, device=dev) > 0.2,
            torch.rand(n2, generator=gen, device=dev) > 0.2)


# every N of 1, 17, 129, 512, 2049 (one row; ragged tiles; the SfM shape;
# a ragged last tile at the largest tile), odd and even N2 (scalar and
# 8-byte stores), at the smallest, the usual and the largest P
@pytest.mark.parametrize("p", [32, 256, 512])
@pytest.mark.parametrize("n1,n2", [(1, 1), (17, 129), (129, 17), (512, 512),
                                   (2049, 2049), (2049, 2050), (1, 2049)])
def test_hamming_kernel_shapes(dev, n1, n2, p):
    b1 = _bits(dev, n1, p, seed=n1 + p)
    b2 = _bits(dev, n2, p, seed=n2 + p + 1)
    m1, m2 = _masks(dev, n1, n2, seed=n1 * n2)
    for args in ((b1, b2), (b1, b2, m1, m2)):
        before = hamming.hamming_distance_matrix.launches
        got = hamming.hamming_distance_matrix(*args)
        torch.cuda.synchronize()
        assert hamming.hamming_distance_matrix.launches == before + 1
        assert torch.equal(got, hamming.hamming_distance_matrix_plain(*args))


# any P: no bits, P % 16 != 0 (byte staging), P % 32 != 0 (a zero-filled
# tail), one 512-column pass and more than one
@pytest.mark.parametrize("p", [0, 8, 48, 96, 100, 544, 1024])
@pytest.mark.parametrize("n1,n2", [(17, 129), (512, 512), (300, 1)])
def test_hamming_kernel_any_p(dev, n1, n2, p):
    b1 = _bits(dev, n1, p, seed=n1 + p)
    b2 = _bits(dev, n2, p, seed=n2 + p + 1)
    m1, m2 = _masks(dev, n1, n2, seed=n1 * n2 + p)
    for args in ((b1, b2), (b1, b2, m1, m2)):
        before = hamming.hamming_distance_matrix.launches
        got = hamming.hamming_distance_matrix(*args)
        torch.cuda.synchronize()
        assert hamming.hamming_distance_matrix.launches == before + 1
        assert torch.equal(got, hamming.hamming_distance_matrix_plain(*args))


@pytest.mark.parametrize("tile", hamming.TILES)
def test_hamming_kernel_every_tile(dev, tile):
    n1, n2, p = 97, 203, 256
    b1, b2 = _bits(dev, n1, p, seed=5), _bits(dev, n2, p, seed=6)
    m1, m2 = _masks(dev, n1, n2, seed=7)
    plan = hamming.TilePlan(*tile, -(-n2 // tile[1]), -(-n1 // tile[0]))
    out = torch.empty((n1, n2), dtype=torch.int32, device=dev)
    hamming.launch(b1, b2, m1.data_ptr(), m2.data_ptr(), out, plan)
    torch.cuda.synchronize()
    assert torch.equal(out, hamming.hamming_distance_matrix_plain(
        b1, b2, m1, m2))


def test_hamming_kernel_all_masked_and_any_byte(dev):
    n1, n2, p = 300, 77, 256
    b1, b2 = _bits(dev, n1, p, seed=8), _bits(dev, n2, p, seed=9)
    off = torch.zeros(n1, dtype=torch.bool, device=dev)
    got = hamming.hamming_distance_matrix(b1, b2, off, None)
    assert (got == 2 ** 31 - 1).all()
    got = hamming.hamming_distance_matrix(b1, b2, None, off[:n2])
    assert (got == 2 ** 31 - 1).all()
    # any byte values: at P = 256 the plain f32 product of bytes is still
    # exact (256 * 255^2 < 2^24), and so is the kernel's integer one
    w1, w2 = _bits(dev, n1, p, 10, 256), _bits(dev, n2, p, 11, 256)
    got = hamming.hamming_distance_matrix(w1, w2)
    torch.cuda.synchronize()
    assert torch.equal(got, hamming.hamming_distance_matrix_plain(w1, w2))


def test_hamming_kernel_offset_operands_and_side_stream(dev):
    n1, n2, p = 513, 130, 256
    b1, b2 = _bits(dev, n1, p, seed=12), _bits(dev, n2, p, seed=13)
    m1, m2 = _masks(dev, n1, n2, seed=14)
    ref = hamming.hamming_distance_matrix_plain(b1, b2, m1, m2)
    # the same bits one byte into a larger allocation: the kernel's byte
    # loads in place of its 16-byte copies
    shifted = []
    for x in (b1, b2):
        buf = torch.empty(x.numel() + 1, dtype=x.dtype, device=dev)
        buf[1:].view(x.shape).copy_(x)
        shifted.append(buf[1:].view(x.shape))
    assert shifted[0].data_ptr() % 16 != 0
    got = hamming.hamming_distance_matrix(*shifted, m1, m2)
    side = torch.cuda.Stream(dev)
    side.wait_stream(torch.cuda.current_stream(dev))
    with torch.cuda.stream(side):
        on_side = hamming.hamming_distance_matrix(b1, b2, m1, m2)
    torch.cuda.synchronize()
    assert torch.equal(got, ref) and torch.equal(on_side, ref)


def _pairs_inputs(dev, f, k, p, q, seed):
    """Stacked bits, ragged masks (one frame all masked) and q pairs that
    repeat frames and pair frames with themselves."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    bits = torch.randint(0, 2, (f, k, p), generator=gen,
                         device=dev).to(torch.uint8)
    masks = torch.rand((f, k), generator=gen, device=dev) > 0.2
    masks[f - 1] = False
    ii = torch.randint(0, f, (q,), generator=gen, device=dev)
    jj = torch.randint(0, f, (q,), generator=gen, device=dev)
    jj[: q // 3] = ii[: q // 3]                       # ii == jj
    return bits, masks, ii.to(torch.int32), jj.to(torch.int32)


# Q of 1, 7 and 529 (F = 23's grid); K of 1, 17, 512 and 513; P of 48
# (byte staging, a zero-filled tail), 256 (one pass) and 1024 (two passes)
@pytest.mark.parametrize("p", [48, 256, 1024])
@pytest.mark.parametrize("k", [1, 17, 512, 513])
@pytest.mark.parametrize("q", [1, 7, 529])
def test_hamming_pairs_kernel_exact(dev, q, k, p):
    if q * k * k * p > 529 * 512 * 512 * 256:
        q = 64                      # the largest sizes at 64 pairs
    bits, masks, ii, jj = _pairs_inputs(dev, 23, k, p, q, seed=q + k + p)
    before = hamming.hamming_distance_matrix_pairs.launches
    got = hamming.hamming_distance_matrix_pairs(bits, masks, ii, jj)
    torch.cuda.synchronize()
    assert hamming.hamming_distance_matrix_pairs.launches == before + 1
    assert torch.equal(got, hamming.hamming_distance_matrix_pairs_plain(
        bits, masks, ii, jj))


def test_hamming_pairs_kernel_index_outside_the_frames(dev):
    bits, masks, ii, jj = _pairs_inputs(dev, 5, 40, 256, 6, seed=3)
    ii[2], jj[4] = 5, -1
    got = hamming.hamming_distance_matrix_pairs(bits, masks, ii, jj)
    torch.cuda.synchronize()
    assert (got[2] == 2 ** 31 - 1).all() and (got[4] == 2 ** 31 - 1).all()
    keep = torch.tensor([0, 1, 3, 5], device=dev)
    assert torch.equal(got[keep], hamming.hamming_distance_matrix_pairs_plain(
        bits, masks, ii[keep], jj[keep]))


def test_pairwise_match_counts_chunked_on_the_card(dev, monkeypatch):
    """F = 23 frames of 512 keypoints in chunks of 100 pairs: six launches,
    the counts equal the plain path's."""
    from photogrammetry_tpu_torch.sfm import loop_closure

    bits, masks, _, _ = _pairs_inputs(dev, 23, 512, 256, 1, seed=9)
    bits[12:] = bits[:11].flip(0)     # out and back: frame j == 22 - j
    masks[12:] = masks[:11].flip(0)
    monkeypatch.setattr(loop_closure, "PAIR_BUDGET_BYTES",
                        100 * 512 * 512 * 4)
    pairwise_match_counts = loop_closure.pairwise_match_counts
    before = hamming.hamming_distance_matrix_pairs.launches
    got = pairwise_match_counts(bits, masks, 80)
    torch.cuda.synchronize()
    assert hamming.hamming_distance_matrix_pairs.launches == before + 6
    ref = pairwise_match_counts(bits, masks, 80, plain=True)
    assert torch.equal(got, ref)
    fold = torch.arange(23, device=dev)
    assert torch.equal(got[fold, 22 - fold], got[fold, fold])


@pytest.mark.parametrize("chunk", [5, 16])
def test_precompute_matching_on_the_card(dev, chunk):
    """The 12-frame pan's 21 frame pairs: one launch of the batched entry
    a chunk, every field equal to the plain run's under one seed."""
    from photogrammetry_tpu_torch.sfm.frontend import (
        make_pairs, precompute_frontend, precompute_matching,
    )
    from photogrammetry_tpu_torch.sfm.incremental import SfmConfig
    from photogrammetry_tpu_torch.synth.star_scene import (
        StarSceneConfig, generate_sequence,
    )

    cfg = SfmConfig()
    frames = torch.tensor(generate_sequence(StarSceneConfig(
        num_frames=12, image_size=(240, 320), focal=260.0,
        supersample=2))["frames"], dtype=torch.float32, device=dev)
    feats = precompute_frontend(frames, make_pairs(cfg.frontend, device=dev),
                                cfg.frontend)

    def run(plain):
        return precompute_matching(
            feats, cfg.frontend, torch.Generator(device=dev).manual_seed(3),
            12, cfg.ransac_threshold, cfg.ransac_samples // 2, chunk=chunk,
            plain=plain)

    before = hamming.hamming_distance_matrix_pairs.launches
    got = run(False)
    assert hamming.hamming_distance_matrix_pairs.launches == \
        before + -(-21 // chunk)
    for a, b in zip(got, run(True)):
        assert torch.equal(a, b)
    assert int(got.num1[1:].min()) > 40


def _revisit_scene(dev):
    """The 5-frame pan and a sixth frame revisiting frame 2 (0.02 off), on
    the card: (features, rs, ts, K, frontend config) for close_loops."""
    from photogrammetry_tpu_torch.sfm.frontend import (
        FrontendConfig, frame_features, make_pairs, precompute_frontend,
    )
    from photogrammetry_tpu_torch.synth.star_scene import (
        StarSceneConfig, generate_sequence, render_frame,
    )

    scene = generate_sequence(StarSceneConfig(num_frames=5, supersample=2))
    cfg, k = scene["config"], scene["k"]
    cx = scene["centers"][2][0] + 0.02          # a revisit of frame 2
    yaw = np.arctan2(cx, cfg.depth)
    r = np.array([[np.cos(yaw), 0, np.sin(yaw)], [0, 1, 0],
                  [-np.sin(yaw), 0, np.cos(yaw)]])
    frames = np.concatenate([scene["frames"], render_frame(
        cfg, r, -r @ np.array([cx, 0.0, 0.0]), k)[None]])
    rs = torch.tensor(np.concatenate([scene["rs"], r[None]]),
                      dtype=torch.float32, device=dev)
    ts = torch.tensor(np.concatenate([scene["ts"],
                                      (-r @ [cx, 0.0, 0.0])[None]]),
                      dtype=torch.float32, device=dev)
    fc = FrontendConfig(detection_threshold=20.0, max_keypoints=256,
                        suppression_radius=4.0, hamming_threshold=80)
    stacked = precompute_frontend(torch.tensor(frames, dtype=torch.float32,
                                               device=dev),
                                  make_pairs(fc, device=dev), fc)
    feats = [frame_features(stacked, t) for t in range(len(frames))]
    return feats, rs, ts, torch.tensor(k, device=dev), fc


@pytest.mark.parametrize("mode", ["rotation", "revisit", "revisit_sim3",
                                  "essential"])
def test_close_loops_every_mode_on_the_card(dev, mode):
    """close_loops on the card in each mode, through the kernels and
    through their plain versions under the same draws: the same counts,
    edges and support, poses within 1e-5; the batched Hamming launched
    once (one chunk).  And on CPU copies of the same inputs (the path the
    CPU tests hold to the JAX package): the same counts, and outside
    'essential' mode (whose draws a CPU generator makes differently) the
    same edges and support, poses within 1e-4."""
    from photogrammetry_tpu_torch.sfm.loop_closure import close_loops

    feats, rs, ts, kmat, fc = _revisit_scene(dev)
    out = []
    for plain in (False, True):
        gen = torch.Generator(device=dev).manual_seed(7)
        before = hamming.hamming_distance_matrix_pairs.launches
        out.append(close_loops(feats, rs, ts, kmat, fc, generator=gen,
                               min_gap=3, min_matches=18, mode=mode,
                               plain=plain))
        launched = hamming.hamming_distance_matrix_pairs.launches - before
        assert launched == (0 if plain else 1)
    (rs_k, ts_k, info_k), (rs_p, ts_p, info_p) = out
    assert np.array_equal(info_k["counts"], info_p["counts"])
    assert info_k["loop_edges"] == info_p["loop_edges"]
    assert info_k.get("inliers") == info_p.get("inliers")
    assert (2, 5) in info_k["loop_edges"] or mode == "essential"
    for a, b in ((rs_k, rs_p), (ts_k, ts_p)):
        a, b = torch.as_tensor(a), torch.as_tensor(b)
        assert torch.isfinite(a).all()
        assert float((a - b).abs().max()) < 1e-5
    feats_cpu = [type(f)(points=type(f.points)(*(x.cpu() for x in f.points)),
                         bits=f.bits.cpu(), xy=f.xy.cpu()) for f in feats]
    rs_c, ts_c, info_c = close_loops(
        feats_cpu, rs.cpu(), ts.cpu(), kmat.cpu(), fc,
        generator=torch.Generator().manual_seed(7), min_gap=3,
        min_matches=18, mode=mode)
    assert np.array_equal(info_k["counts"], info_c["counts"])
    if mode != "essential":
        assert info_k["loop_edges"] == info_c["loop_edges"]
        assert info_k.get("inliers") == info_c.get("inliers")
        for a, b in ((rs_k, rs_c), (ts_k, ts_c)):
            a, b = torch.as_tensor(a).cpu(), torch.as_tensor(b)
            assert float((a - b).abs().max()) < 1e-4


def _fast_case(dev, name):
    rng = np.random.default_rng(len(name))
    if name == "constant":
        return torch.full((2, 40, 64), 77.0, device=dev), 10.0
    if name == "isolated_peak":     # one pixel whose whole ring is outside
        img = torch.zeros((1, 31, 45), device=dev)
        img[0, 15, 20] = 255.0
        return img, 50.0
    if name == "band_edges":        # ring values exactly at c +- thr
        img = rng.integers(0, 8, (3, 64, 96)) * 12.5
        return torch.tensor(img, dtype=torch.float32, device=dev), 25.0
    shapes = {"tiny_1x1": (1, 1, 1), "tiny_5x6": (2, 5, 6),
              "tiny_6x7": (1, 6, 7), "tiny_7x7": (1, 7, 7),
              "w_not_4": (2, 45, 70), "w_odd": (1, 37, 33),
              "b13": (13, 40, 64), "frame": (1, 1080, 1920)}
    img = rng.integers(0, 256, shapes[name]).astype(np.float32)
    img[..., ::7, :] = 255.0        # saturated rows: equal-valued runs
    return torch.tensor(img, device=dev), 30.0


@pytest.mark.parametrize("name", ["constant", "isolated_peak", "band_edges",
                                  "tiny_1x1", "tiny_5x6", "tiny_6x7",
                                  "tiny_7x7", "w_not_4", "w_odd", "b13",
                                  "frame"])
def test_fast_kernel_shapes(dev, name):
    imgs, thr = _fast_case(dev, name)
    before = fast_stencil.fast_score_map_batch.launches
    got = fast_stencil.fast_score_map_batch(imgs, thr)
    torch.cuda.synchronize()
    assert fast_stencil.fast_score_map_batch.launches == before + 1
    ref = fast_stencil.fast_score_map_plain(imgs, thr)
    assert torch.equal(got, ref)
    if name == "isolated_peak":
        assert got[0, 15, 20] == 16 and int((got > 0).sum()) == 1
    if name == "constant":
        assert not got.any()


def test_fast_kernel_thresholds_on_the_band_edges(dev):
    img = (torch.arange(64 * 96, device=dev).reshape(1, 64, 96) * 7 % 8
           * 12.5).to(torch.float32)
    for thr in (12.5, 25.0, 37.3, 37.5):
        got = fast_stencil.fast_score_map_batch(img, thr)
        assert torch.equal(got, fast_stencil.fast_score_map_plain(img, thr))


def _schur_args(dev, f, t, seed=3):
    rng = np.random.default_rng(seed)
    return [torch.tensor(rng.normal(size=shape), dtype=torch.float32,
                         device=dev)
            for shape in ((f, t, 6, 3), (f, t, 6, 3), (t, 3))]


def _assert_schur_within_bound(got, args):
    s_ref, c_ref = schur.schur_products_plain(*args)
    s_bound, c_bound = schur.error_bound(*args)
    assert ((got[0].double() - s_ref.double()).abs() <= s_bound).all()
    assert ((got[1].double() - c_ref.double()).abs() <= c_bound).all()


def test_schur_kernel_within_bound(dev):
    f, t = 5, 700   # ragged: F is not a multiple of the camera tile
    args = _schur_args(dev, f, t)
    before = schur.schur_products.launches
    s, c = schur.schur_products(*args)
    torch.cuda.synchronize()
    assert schur.schur_products.launches == before + 1
    _assert_schur_within_bound((s, c), args)
    # a fixed summation order: the same bits twice
    s2, c2 = schur.schur_products(*args)
    assert torch.equal(s, s2) and torch.equal(c, c2)


# one camera, a ragged camera tile with odd T (camera rows 8-byte aligned
# only), one landmark (fewer than any split), no landmark, a ragged last
# tile, the two main shapes and the submap path's global BA
@pytest.mark.parametrize("f,t", [(1, 1024), (17, 701), (12, 1), (3, 0),
                                 (6, 2000), (12, 1024), (16, 4096),
                                 (23, 4096)])
def test_schur_kernel_shapes(dev, f, t):
    args = _schur_args(dev, f, t, seed=f + t)
    got = schur.schur_products(*args)
    again = schur.schur_products(*args)
    torch.cuda.synchronize()
    assert got[0].shape == (f, f, 6, 6) and got[1].shape == (f, 6)
    _assert_schur_within_bound(got, args)
    assert all(torch.equal(a, b) for a, b in zip(got, again))


@pytest.mark.parametrize("slabs", [1, 3, 22, 10 ** 6])
def test_schur_kernel_any_split(dev, slabs):
    args = _schur_args(dev, 7, 701)
    got = schur.schur_products(*args, slabs=slabs)
    torch.cuda.synchronize()
    _assert_schur_within_bound(got, args)


def test_schur_kernel_offset_operands_and_side_stream(dev):
    args = _schur_args(dev, 17, 701)
    ref = schur.schur_products(*args)
    # the same values one float into a larger allocation: rows that are
    # 4-byte aligned only take the kernel's narrow copies, same sums
    shifted = []
    for x in args:
        buf = torch.empty(x.numel() + 1, dtype=x.dtype, device=dev)
        buf[1:].view(x.shape).copy_(x)
        shifted.append(buf[1:].view(x.shape))
    got = schur.schur_products(*shifted)
    side = torch.cuda.Stream(dev)
    side.wait_stream(torch.cuda.current_stream(dev))
    with torch.cuda.stream(side):
        on_side = schur.schur_products(*args)
    torch.cuda.synchronize()
    for a, b, c in zip(ref, got, on_side):
        assert torch.equal(a, b) and torch.equal(a, c)


@pytest.mark.parametrize("dtype", [torch.float32, torch.uint8])
@pytest.mark.parametrize("b,c", [(1, 1), (3, 1), (1, 3), (2, 4), (5, 2),
                                 (3, 5)])
def test_remap_kernel_exact(dev, dtype, b, c):
    rng = np.random.default_rng(4)
    hs, ws = 97, 131                       # ragged against the 32x8 block
    imgs = torch.tensor(rng.uniform(0, 255, (b, hs, ws, c)),
                        device=dev).to(dtype)
    radial = generate_distortion_map(hs, ws, [1.2e-3, 1.6e-6, 0, 0, 0],
                                     device=dev)
    wild = torch.tensor(np.stack([rng.uniform(-4, hs + 4, (hs + 9, ws + 14)),
                                  rng.uniform(-4, ws + 4, (hs + 9, ws + 14))],
                                 -1), dtype=torch.float32, device=dev)
    wild[:, ws // 2:, 1] = wild[:, ws // 2:, 1].flip(1)     # and folded
    wild[::7, ::5] = 1e9                    # far outside, and non-finite
    wild[1::7, ::5] = -1e9
    wild[2::7, ::5, 0] = float("nan")
    wild[3::7, ::5, 1] = float("inf")
    wild[5, :, 1] = ws - 0.5                # half of the last column
    smaller = wild[3:60, 5:90].contiguous()
    # an odd number of output pixels: the frames of a uint8 stack start at
    # every byte alignment; frame_chunk 2 leaves a last chunk of one frame
    # when B is odd
    for dmap, chunk in ((radial, None), (wild, None), (smaller, 2)):
        before = remap.remap_bilinear.launches
        got = remap.remap_bilinear(imgs, dmap, frame_chunk=chunk)
        torch.cuda.synchronize()
        assert remap.remap_bilinear.launches == before + 1
        ref = remap.remap_bilinear_plain(imgs, dmap)
        assert got.dtype == dtype and got.shape == ref.shape
        assert torch.equal(got, ref)
        assert torch.isfinite(got.float()).all()


def test_remap_kernel_unaligned_map_and_images(dev):
    rng = np.random.default_rng(5)
    hs, ws = 33, 47
    buf = torch.tensor(rng.integers(0, 256, 2 * hs * ws * 3 + 1),
                       dtype=torch.uint8, device=dev)
    imgs = buf[1:].view(2, hs, ws, 3)           # starts at an odd byte
    mbuf = torch.tensor(rng.uniform(-2, 50, 40 * 50 * 2 + 1),
                        dtype=torch.float32, device=dev)
    dmap = mbuf[1:].view(40, 50, 2)             # 4-byte aligned only
    got = remap.remap_bilinear(imgs, dmap)
    torch.cuda.synchronize()
    assert torch.equal(got, remap.remap_bilinear_plain(imgs, dmap))


def test_remap_wrapper_refuses_what_the_kernel_does_not_take(dev):
    imgs = torch.zeros((1, 8, 8, 1), device=dev)
    dmap = torch.zeros((8, 8, 2), device=dev)
    with pytest.raises(ValueError, match="float32 and uint8"):
        remap.remap_bilinear(imgs.to(torch.float16), dmap)
    with pytest.raises(ValueError, match="contiguous"):
        remap.remap_bilinear(imgs.expand(2, 8, 8, 1), dmap)
    with pytest.raises(ValueError, match="two devices"):
        remap.remap_bilinear(imgs, dmap.cpu())
    apply = make_distortion_applier(dmap, (8, 8), device=dev)
    assert apply(np.zeros((8, 8), np.uint8)).device.type == "cuda"


@pytest.mark.parametrize("dtype", [torch.int16, torch.int32, torch.float64,
                                   torch.float16])
def test_applier_any_real_dtype(dev, dtype):
    rng = np.random.default_rng(6)
    h, w = 120, 160
    dmap = generate_distortion_map(h, w, [3e-4, 1e-7, 0, 0, 0], device=dev)
    imgs = torch.tensor(rng.uniform(0, 1000, (3, h, w)), device=dev).to(dtype)
    before = remap.remap_bilinear.launches
    got = make_distortion_applier(dmap, (h, w), device=dev)(imgs)
    torch.cuda.synchronize()
    assert remap.remap_bilinear.launches == before + 1
    assert got.dtype == dtype
    ref = make_distortion_applier(dmap, (h, w), device=dev, plain=True)(imgs)
    assert torch.equal(got, ref)


# ---------------------------------------- keyframes, submaps, pyramid


def _small_pan():
    """tests/test_keyframes.py's 12-frame 240x320 pan."""
    from photogrammetry_tpu_torch.synth.star_scene import (
        StarSceneConfig, generate_sequence,
    )

    return generate_sequence(StarSceneConfig(
        num_frames=12, image_size=(240, 320), focal=260.0, supersample=1))


def _same_features(a, b):
    return all(torch.equal(x, y) for x, y in
               zip([*a.points, a.bits, a.xy], [*b.points, b.bits, b.xy]))


@pytest.mark.parametrize("octaves", [1, 2])
def test_fast_and_brief_kernels_on_the_octaves(dev, octaves):
    """The pyramid's 540x960 and 270x480 octaves of two 1080p noise
    frames: FAST and BRIEF (512 keypoints a frame) bit-exact."""
    from photogrammetry_tpu_torch.ops.fast import extract_keypoints
    from photogrammetry_tpu_torch.sfm.frontend import _downsample2

    rng = np.random.default_rng(octaves)
    img = torch.tensor(rng.integers(0, 256, (2, 1080, 1920)),
                       dtype=torch.float32, device=dev)
    for _ in range(octaves):
        img = _downsample2(img)
    got = fast_stencil.fast_score_map_batch(img, 20.0)
    ref = fast_stencil.fast_score_map_plain(img, 20.0)
    assert torch.equal(got, ref) and int((ref > 0).sum()) > 0
    pts = [extract_keypoints(x, 512, order="score") for x in ref]
    coords = torch.stack([p.coords for p in pts])
    mask = torch.stack([p.mask for p in pts])
    pairs = torch.tensor(np.rint(rng.normal(0, 20, (256, 2, 2))),
                         dtype=torch.int32, device=dev)
    assert torch.equal(brief_pack.brief_bits(img, coords, pairs, mask),
                       brief_pack.brief_bits_plain(img, coords, pairs, mask))


def test_hamming_kernel_at_the_pyramid_shape(dev):
    """Two octaves of 512 keypoints merged: 1024 x 1024 at P = 256."""
    a, b = _bits(dev, 1024, 256, 41), _bits(dev, 1024, 256, 42)
    ma, mb = _masks(dev, 1024, 1024, 43)
    assert torch.equal(hamming.hamming_distance_matrix(a, b, ma, mb),
                       hamming.hamming_distance_matrix_plain(a, b, ma, mb))


@pytest.mark.parametrize("octaves", [2, 3])
def test_pyramid_frontend_kernel_vs_plain(dev, octaves):
    """precompute_frontend(octaves) with the kernels equals its plain run;
    FAST and BRIEF launch once an octave a chunk."""
    from photogrammetry_tpu_torch.sfm.frontend import (
        FrontendConfig, make_pairs, precompute_frontend,
    )

    frames = torch.tensor(_small_pan()["frames"], dtype=torch.float32,
                          device=dev)
    fc = FrontendConfig(detection_threshold=20.0, max_keypoints=256,
                        suppression_radius=4.0, hamming_threshold=80)
    pairs = make_pairs(fc, device=dev)
    before = (fast_stencil.fast_score_map_batch.launches,
              brief_pack.brief_bits.launches)
    got = precompute_frontend(frames, pairs, fc, chunk=8, octaves=octaves)
    torch.cuda.synchronize()
    assert fast_stencil.fast_score_map_batch.launches == \
        before[0] + 2 * octaves
    assert brief_pack.brief_bits.launches == before[1] + 2 * octaves
    ref = precompute_frontend(frames, pairs, fc, chunk=8, octaves=octaves,
                              plain=True)
    assert got.bits.shape[:2] == (12, octaves * 256)
    assert _same_features(got, ref)


def test_keyframes_kernel_vs_plain(dev):
    """select_keyframes with the kernels equals its plain run (list and
    features); run_keyframed_sfm poses every frame; on its map,
    localize_nonkeyframes takes the same path a frame with the kernels
    and plain, poses within 1e-4."""
    from photogrammetry_tpu_torch.sfm.incremental import SfmConfig
    from photogrammetry_tpu_torch.sfm.keyframes import (
        localize_nonkeyframes, run_keyframed_sfm, select_keyframes,
    )

    scene = _small_pan()
    frames, k = scene["frames"], scene["k"]
    cfg = SfmConfig(collect_diagnostics=False)
    kfs, feats = select_keyframes(frames, cfg, 20.0, device=dev)
    kfs_p, feats_p = select_keyframes(frames, cfg, 20.0, device=dev,
                                      plain=True)
    assert kfs == kfs_p and kfs[0] == 0 and kfs[-1] == 11
    assert all(_same_features(a, b) for a, b in zip(feats, feats_p))
    before = schur.schur_products.launches
    rs, ts, kfs_r, res, info = run_keyframed_sfm(frames, k, cfg,
                                                 min_disp_px=20.0,
                                                 device=dev)
    assert kfs_r == kfs and rs.shape == (12, 3, 3)
    assert np.isfinite(rs).all() and np.isfinite(ts).all()
    assert schur.schur_products.launches > before
    out = [localize_nonkeyframes(frames, kfs, feats, res, k, cfg,
                                 device=dev, plain=plain)
           for plain in (False, True)]
    assert [i.get("path") for i in out[0][2]] == \
        [i.get("path") for i in out[1][2]]
    assert np.abs(out[0][0] - out[1][0]).max() < 1e-4
    assert np.abs(out[0][1] - out[1][1]).max() < 1e-4


def test_submaps_kernel_vs_plain(dev):
    """run_submap_sfm on the card (spans (0, 8) and (5, 12), one refine
    round): a pose a frame, nothing dropped, the Schur kernel launched;
    refine_submaps_global with the kernels against plain on the run's own
    windows and poses, within 5% of the correction the plain refine
    makes (the share chip_smoke.py holds it to)."""
    from photogrammetry_tpu_torch.sfm.incremental import SfmConfig
    from photogrammetry_tpu_torch.sfm.submaps import (
        refine_submaps_global, run_submap_sfm,
    )

    scene = _small_pan()
    frames, k = scene["frames"], scene["k"]
    cfg = SfmConfig(collect_diagnostics=False)
    before = schur.schur_products.launches
    res = run_submap_sfm(frames, k, cfg, submap_frames=8, overlap=3,
                         restarts=1, global_refine_rounds=1, device=dev)
    assert res.spans == [(0, 8), (5, 12)] and res.dropped == 0
    assert res.rs.shape == (12, 3, 3) and np.isfinite(res.rs).all()
    assert schur.schur_products.launches > before
    out = [refine_submaps_global(res.rs, res.ts, res.submaps, res.spans, k,
                                 12, rounds=1, device=dev, plain=plain)
           for plain in (False, True)]
    correction = max(np.abs(out[1][0] - res.rs).max(),
                     np.abs(out[1][1] - res.ts).max())
    diff = max(np.abs(out[0][0] - out[1][0]).max(),
               np.abs(out[0][1] - out[1][1]).max())
    assert diff <= 0.05 * correction


@pytest.mark.parametrize("reduction,impl", [
    ("nms", "sequential"), ("nms", "parallel"), ("anms", "static"),
    ("cluster", "static"), ("none", "static")])
def test_frontend_variants_card_equals_cpu(dev, reduction, impl):
    """Every reduction on the card, with the kernels, gives the CPU's
    keypoints, bits and matches (the CPU path is held to the JAX package
    in tests/test_torch_frontend_variants.py)."""
    from photogrammetry_tpu_torch.sfm.frontend import (
        FrontendConfig, detect_and_describe, make_pairs, match_pair,
    )

    scene = _small_pan()
    cfg = FrontendConfig(max_keypoints=256, suppression_radius=4.0,
                         reduction=reduction, nms_impl=impl)
    out = {}
    for d in (dev, torch.device("cpu")):
        pairs = make_pairs(cfg, device=d)
        fs = [detect_and_describe(torch.tensor(
            scene["frames"][i], dtype=torch.float32, device=d), pairs, cfg)
            for i in (0, 2)]
        out[d.type] = (fs, match_pair(*fs, cfg))
    (gf, gm), (cf, cm) = out["cuda"], out["cpu"]
    for g, c in zip(gf, cf):
        for a, b in zip([*g.points, g.bits], [*c.points, c.bits]):
            assert torch.equal(a.cpu(), b)
    for a, b in zip(gm[2:], cm[2:]):          # idx2, dist, mask, num
        assert torch.equal(a.cpu(), b)


def test_cluster_and_matchers_card_equals_cpu(dev):
    """grid_cluster_keypoints (its early stop read back from the card),
    greedy and sorted matching and the motion filter, card against CPU."""
    from photogrammetry_tpu_torch.ops import cluster, match
    from photogrammetry_tpu_torch.utils.padding import PaddedPoints

    rng = np.random.default_rng(9)
    n = 900
    coords = np.stack([rng.integers(0, 240, n), rng.integers(0, 320, n)], -1)
    pts = PaddedPoints(torch.tensor(coords, dtype=torch.int32),
                       torch.ones(n), torch.ones(n, dtype=torch.bool),
                       torch.tensor(n, dtype=torch.int32))
    dist = torch.tensor(rng.integers(0, 12, (60, 50)), dtype=torch.int32)
    xy1 = torch.tensor(rng.integers(0, 1200, (200, 2)), dtype=torch.float32)
    xy2 = xy1 + torch.tensor(rng.integers(-60, 61, (200, 2)),
                             dtype=torch.float32)
    mask = torch.tensor(rng.random(200) < 0.9)
    calls = [
        lambda d: cluster.grid_cluster_keypoints(
            PaddedPoints(*(x.to(d) for x in pts)), 240, 320,
            chunk_capacity=128),
        lambda d: match.greedy_global_matches(dist.to(d), 70),
        lambda d: match.sorted_candidate_matches(dist.to(d)),
        lambda d: (match.motion_consistency_mask(
            xy1.to(d), xy2.to(d), mask.to(d)),),
    ]
    for call in calls:
        for a, b in zip(call(dev), call(torch.device("cpu"))):
            assert torch.equal(a.cpu(), b)


def test_distributed_ba_world_of_one_on_the_card(dev):
    """The sharded BA in a world of one NCCL rank: the Schur kernel once an
    LM iteration, and the result bit for bit ``bundle_adjust``'s (an
    all-reduce over one rank is a copy)."""
    import torch.distributed as dist

    from photogrammetry_tpu_torch.parallel import (
        distributed_bundle_adjust, make_mesh,
    )
    from photogrammetry_tpu_torch.sfm.ba import (
        BAProblem, BAState, bundle_adjust, project,
    )

    rng = np.random.default_rng(0)
    f, t = 6, 512
    k = torch.tensor([[300.0, 0, 128], [0, 300.0, 96], [0, 0, 1]],
                     device=dev)
    pts = torch.tensor(rng.uniform(-1, 1, (t, 3)) + [0, 0, 5],
                       dtype=torch.float32, device=dev)
    rs = torch.eye(3, device=dev).repeat(f, 1, 1)
    ts = torch.tensor(rng.normal(0, 0.05, (f, 3)), dtype=torch.float32,
                      device=dev)
    obs = project(rs, ts, pts, k)[0] + torch.tensor(
        rng.normal(0, 0.3, (f, t, 2)), dtype=torch.float32, device=dev)
    state = BAState(rs, ts, pts + torch.tensor(
        rng.normal(0, 0.03, (t, 3)), dtype=torch.float32, device=dev))
    prob = BAProblem(obs, torch.ones((f, t), dtype=torch.bool, device=dev),
                     k)
    mesh = make_mesh(device_type="cuda")
    try:
        before = schur.schur_products.launches
        got = distributed_bundle_adjust(state, prob, mesh, num_iterations=8)
        assert schur.schur_products.launches == before + 8
        ref = bundle_adjust(state, prob, num_iterations=8)
        for a, b in zip((*got.state, got.cost), (*ref.state, ref.cost)):
            assert torch.equal(a, b)
    finally:
        dist.destroy_process_group()


# ------------------------------ bundle adjustment as a cached CUDA graph


def _ba_1080(dev, seed, frames=12, tracks=1024):
    """A BA problem of the SfM path's shape on the 1080p star scene (focal
    1560, the 12-frame pan): the star's corners and a dot field drawn from
    ``seed`` in ``tracks`` slots, each seen over a run of frames with
    0.5 px noise (slots without a point never seen), the poses and points
    perturbed as the incremental loop hands them over."""
    from photogrammetry_tpu_torch.core.lie import se3_exp
    from photogrammetry_tpu_torch.sfm.ba import BAProblem, BAState, project
    from photogrammetry_tpu_torch.synth.star_scene import (
        StarSceneConfig, dot_points_3d, intrinsics, pan_trajectory,
        star_points_3d,
    )

    cfg = StarSceneConfig(image_size=(1080, 1920), focal=1560.0,
                          num_frames=frames, num_dots=1200, dot_seed=seed)
    pts = np.concatenate([star_points_3d(cfg), dot_points_3d(cfg)[0]])
    pts = pts[:tracks]
    rng = np.random.default_rng(seed)
    rs, ts, _ = pan_trajectory(cfg)
    t32 = dict(dtype=torch.float32, device=dev)
    k = torch.tensor(intrinsics(cfg), **t32)
    rs, ts = torch.tensor(rs, **t32), torch.tensor(ts, **t32)
    p = torch.zeros((tracks, 3), **t32)
    p[:len(pts)] = torch.tensor(pts, **t32)
    obs = project(rs, ts, p, k)[0] + torch.tensor(
        rng.normal(0, 0.5, (frames, tracks, 2)), **t32)
    first = rng.integers(0, frames - 1, tracks)
    last = first + rng.integers(2, frames + 1, tracks)
    f = np.arange(frames)[:, None]
    mask = (f >= first) & (f < last)
    mask[:, len(pts):] = False
    twist = torch.tensor(rng.normal(0, 0.01, (frames, 6)), **t32)
    twist[0] = 0
    dr, dt = se3_exp(twist)
    state = BAState(rs=dr @ rs, ts=ts + dt, points=p + torch.tensor(
        rng.normal(0, 0.05, (tracks, 3)), **t32))
    return state, BAProblem(obs=obs, mask=torch.tensor(mask, device=dev),
                            k=k)


# the three calls of a 12-frame SfM sequence: the bootstrap (frames 1-3
# free, 20 iterations), localize (frame 6 alone, motion only, 10) and the
# windowed and final BA (frames 1-8 free, 30)
_SFM_KEYS = {
    "bootstrap": (dict(num_iterations=20), lambda f: (f >= 1) & (f <= 3)),
    "localize": (dict(num_iterations=10, optimize_points=False),
                 lambda f: f == 6),
    "map": (dict(num_iterations=30), lambda f: (f >= 1) & (f <= 8)),
}


def _ba_case(dev, key, seed):
    kw, free = _SFM_KEYS[key]
    state, prob = _ba_1080(dev, seed)
    fixed = free(torch.arange(12, device=dev)).to(torch.float32)
    return state, prob, dict(kw, fixed_cameras=fixed)


def _eager(state, prob, kw):
    """The eager LM loop of ``bundle_adjust(state, prob, **kw)``:
    (state, cost, initial cost, accepted steps)."""
    from photogrammetry_tpu_torch.sfm import ba

    opts = dict(num_iterations=10, huber_delta=3.0, init_lambda=1e-3,
                optimize_points=True, use_pose_prior=False, prior_weight=0.0,
                plain=False)
    opts.update((k, v) for k, v in kw.items() if k in opts)
    return ba._lm_loop(state, prob, kw.get("fixed_cameras"), None, None,
                       tally=True, **opts)


def _same_ba(res, ref) -> bool:
    return (all(torch.equal(a, b) for a, b in zip(res.state, ref[0]))
            and torch.equal(res.cost, ref[1])
            and torch.equal(res.initial_cost, ref[2]))


@pytest.fixture
def ba_cache():
    """``sfm/ba.py``'s graph cache emptied around the test."""
    from photogrammetry_tpu_torch.sfm import ba

    torch.cuda.synchronize()
    ba._CACHE.graphs.clear()
    ba._CACHE.seen.clear()
    yield ba
    torch.cuda.synchronize()
    ba._CACHE.graphs.clear()
    ba._CACHE.seen.clear()


@pytest.mark.parametrize("key", sorted(_SFM_KEYS))
def test_ba_graph_replay_bit_identical(dev, ba_cache, key):
    """Each SfM key: the first call eager, the second captures and
    replays, the next replay; each replay of four problems of the key
    (seeds 0-3, in turn, one capture) gives that problem's eager bits in
    the state, the cost and the initial cost and counts its eager accepted
    steps.  A result stays as it was through the later replays: inputs are
    refreshed and outputs not aliased."""
    from photogrammetry_tpu_torch.utils import profiling

    ba = ba_cache
    cases = [_ba_case(dev, key, seed) for seed in range(4)]
    refs = [_eager(*c) for c in cases]
    assert all(int(r[3]) > 0 for r in refs)
    assert all(_same_ba(ba.bundle_adjust(cases[0][0], cases[0][1],
                                         **cases[0][2]), refs[0])
               for _ in range(2))
    assert len(ba._CACHE.graphs) == 1
    profiling.clear()
    with profiling.recording():
        got = [ba.bundle_adjust(st, pr, **kw) for st, pr, kw in cases]
    counters = profiling.read_counters()
    profiling.clear()
    for res, ref in zip(got, refs):
        assert _same_ba(res, ref)
    assert counters["ba.graph_replays"] == 4
    assert "ba.eager_solves" not in counters
    assert counters["ba.lm_accepted"] == sum(int(r[3]) for r in refs)
    assert not torch.equal(got[0].state.points, got[1].state.points)


def test_ba_graph_replay_syncs_nothing(dev, ba_cache):
    """A replay (copy-in, graph, copies out; recording on and off) under
    ``set_sync_debug_mode("error")``."""
    from photogrammetry_tpu_torch.utils import profiling

    st, pr, kw = _ba_case(dev, "map", 0)
    ref = _eager(st, pr, kw)
    for _ in range(2):
        ba_cache.bundle_adjust(st, pr, **kw)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        res = ba_cache.bundle_adjust(st, pr, **kw)
        with profiling.recording():
            again = ba_cache.bundle_adjust(st, pr, **kw)
    finally:
        torch.cuda.set_sync_debug_mode(0)
        profiling.clear()
    assert _same_ba(res, ref) and _same_ba(again, ref)


def test_ba_inside_a_capture_runs_eagerly(dev, ba_cache):
    """Inside a ``SegmentedGraph`` capture a BA whose key is cached is
    recorded into that capture, not replayed: the capture holds (one
    segment) and its replay gives the eager bits."""
    from photogrammetry_tpu_torch.utils.graphs import SegmentedGraph

    st, pr, kw = _ba_case(dev, "localize", 1)
    ref = _eager(st, pr, kw)
    for _ in range(2):
        ba_cache.bundle_adjust(st, pr, **kw)
    graph = SegmentedGraph(dev)
    out = graph.capture(lambda s, p: ba_cache.bundle_adjust(s, p, **kw),
                        st, pr)
    assert graph.segments == 1 and len(ba_cache._CACHE.graphs) == 1
    graph.replay()
    assert _same_ba(out, ref)


def test_ba_graph_cache_bounded(dev, ba_cache, monkeypatch):
    """A key that finds the cache full runs eagerly and evicts the least
    recently replayed capture; its next call captures."""
    monkeypatch.setattr(ba_cache._CACHE, "MAX_GRAPHS", 2)
    st, pr, kw = _ba_case(dev, "localize", 2)

    def cached():
        return [dict(key[2])["num_iterations"]
                for key in ba_cache._CACHE.graphs]

    def check(n, ref):
        res = ba_cache.bundle_adjust(st, pr, **dict(kw, num_iterations=n))
        assert _same_ba(res, ref)

    refs = {n: _eager(st, pr, dict(kw, num_iterations=n)) for n in (4, 5, 6)}
    for n in (4, 5):
        check(n, refs[n])
        check(n, refs[n])
    assert cached() == [4, 5]
    check(4, refs[4])               # a replay: 4 is now the newest
    check(6, refs[6])               # seen
    check(6, refs[6])               # the cache full: eager, 5 evicted
    assert cached() == [4]
    check(6, refs[6])               # captured
    assert cached() == [4, 6]
    check(6, refs[6])               # replayed


def test_staged_sfm_with_ba_graphs_equals_eager(dev, ba_cache, monkeypatch):
    """The staged SfM on the 8-frame pan: a first run (each key eager,
    then captured), a second (every BA a replay) and a run with no cache
    (every BA eager) give the same bits."""
    from photogrammetry_tpu_torch.sfm.incremental import (
        SfmConfig, run_incremental_sfm,
    )
    from photogrammetry_tpu_torch.utils import profiling

    scene = _pan8()
    cfg = SfmConfig(collect_diagnostics=False, ba_iterations=17)

    def run():
        return run_incremental_sfm(scene["frames"], scene["k"], cfg, seed=3,
                                   device=dev)

    first = run()
    with profiling.recording():
        second = run()
    counters = profiling.read_counters()
    profiling.clear()
    assert counters["ba.graph_replays"] > 0
    assert "ba.eager_solves" not in counters
    monkeypatch.setattr(ba_cache._CACHE, "MAX_GRAPHS", 0)
    ba_cache._CACHE.graphs.clear()
    eager = run()
    assert _same_run(first, eager) and _same_run(second, eager)


# ------------------------------ the pose graph's LM as a cached CUDA graph


def _pg_case(dev, n, e, seed, sim3):
    """A walk of ``n`` nodes out along x and back (the way back 0.05 off),
    its ``n - 1`` odometry edges and ``e - n + 1`` loop edges between
    nodes at least 5 apart, each measured with noise drawn from ``seed``
    (loop weight 4; Sim(3): loop scales 0.9-1.1), and the poses the
    odometry integrates to: (args of the cache's loop but the mask,
    graph, the optimiser)."""
    from photogrammetry_tpu_torch.core.lie import se3_exp, so3_exp
    from photogrammetry_tpu_torch.sfm import pose_graph as pg

    g = torch.Generator().manual_seed(seed)
    half = (n + 1) // 2
    x = torch.cat([torch.arange(half), torch.arange(n - half - 1, -1, -1)
                   - 1.0]).float() * 0.1
    centres = torch.stack([x, (torch.arange(n) >= half) * 0.05,
                           torch.zeros(n)], -1)
    rs = so3_exp(torch.randn(n, 3, generator=g) * 0.05)
    ts = -(rs @ centres[..., None])[..., 0]
    far = [(i, j) for i in range(n) for j in range(i + 5, n)]
    pick = torch.randperm(len(far), generator=g)[:e - n + 1]
    edges = torch.tensor([(i, i + 1) for i in range(n - 1)]
                         + [far[k] for k in pick.tolist()], dtype=torch.int32)
    ii, jj = edges[:, 0].long(), edges[:, 1].long()
    zr, zt = pg.relative_pose(rs[ii], ts[ii], rs[jj], ts[jj])
    dr, dt = se3_exp(torch.randn(e, 6, generator=g) * 0.02)
    zr, zt = dr @ zr, (dr @ zt[..., None])[..., 0] + dt
    r0, t0 = [rs[0]], [ts[0]]
    for k in range(n - 1):
        r0.append(zr[k] @ r0[-1])
        t0.append(zr[k] @ t0[-1] + zt[k])
    w = torch.where(torch.arange(e) < n - 1, 1.0, 4.0)
    put = dict(dtype=torch.float32, device=dev)
    rs0, ts0 = torch.stack(r0).to(**put), torch.stack(t0).to(**put)
    common = dict(edges=edges.to(dev), z_rs=zr.to(**put), z_ts=zt.to(**put),
                  weights=w.to(**put))
    if not sim3:
        return (rs0, ts0), pg.PoseGraph(**common), pg.optimize_pose_graph
    zs = torch.where(torch.arange(e) < n - 1, 1.0,
                     0.9 + 0.2 * torch.rand(e, generator=g))
    return ((rs0, ts0, ts0.new_zeros(n)),
            pg.PoseGraphSim3(z_ss=zs.to(**put), **common),
            pg.optimize_pose_graph_sim3)


def _pg_eager(state, graph, sim3, num_iterations=20):
    """The eager LM loop on the card, as ``optimize_pose_graph`` (``_sim3``)
    returns it: ((rs, ts, scales or None, cost, initial cost), accepted)."""
    from photogrammetry_tpu_torch.sfm import pose_graph as pg

    cache = pg._SIM3_GRAPHS if sim3 else pg._SE3_GRAPHS
    fn = pg._fixed(state[0].shape[0], None, state[1])
    st, cost, cost0, accepted = cache.loop(
        *state, graph, fn, num_iterations=num_iterations, init_lambda=1e-4,
        tally=True)
    if not sim3:
        return (st[0], st[1], None, cost, cost0), int(accepted)
    scales = torch.exp(st[2])
    return (st[0], st[1] / scales[:, None], scales, cost, cost0), \
        int(accepted)


def _same_pg(res, ref) -> bool:
    got = (res.rs, res.ts, getattr(res, "scales", None), res.cost,
           res.initial_cost)
    return all((a is None and b is None) or torch.equal(a, b)
               for a, b in zip(got, ref))


@pytest.fixture
def pg_cache():
    """``sfm/pose_graph.py``'s two graph caches emptied around the test."""
    from photogrammetry_tpu_torch.sfm import pose_graph as pg

    def empty():
        torch.cuda.synchronize()
        for cache in (pg._SE3_GRAPHS, pg._SIM3_GRAPHS):
            cache.graphs.clear()
            cache.seen.clear()

    empty()
    yield pg
    empty()


def _recorded(fn):
    """(fn(), the counters it recorded)."""
    from photogrammetry_tpu_torch.utils import profiling

    profiling.clear()
    with profiling.recording():
        out = fn()
    counters = profiling.read_counters()
    profiling.clear()
    return out, counters


@pytest.mark.parametrize("sim3", [False, True])
@pytest.mark.parametrize("n,e", [(23, 30), (40, 47)])
def test_pose_graph_replay_bit_identical(dev, pg_cache, n, e, sim3):
    """At outback23's shape (23 nodes, 30 edges) and another: the first
    call eager, the second captures and replays, the next replay; each
    replay of four graphs of the shape (seeds 0-3, one capture) gives that
    graph's eager bits in rs, ts, scales, cost and initial cost, and its
    accept tally equals the eager run's ``pose_graph.lm_accepted``.  A
    result stays as it was through the later replays."""
    cases = [_pg_case(dev, n, e, seed, sim3) for seed in range(4)]
    refs = [_pg_eager(state, graph, sim3) for state, graph, _ in cases]
    assert all(0 < acc < 20 for _, acc in refs)
    state, graph, optimize = cases[0]

    def run(case):
        return case[2](*case[0][:2], case[1], num_iterations=20)

    first, eager = _recorded(lambda: run(cases[0]))
    second, capture = _recorded(lambda: run(cases[0]))
    assert _same_pg(first, refs[0][0]) and _same_pg(second, refs[0][0])
    assert eager == {"pose_graph.eager_solves": 1,
                     "pose_graph.lm_accepted": refs[0][1],
                     "pose_graph.lm_iterations": 20}
    assert capture == {"pose_graph.graph_captures": 1,
                       "pose_graph.graph_replays": 1,
                       "pose_graph.lm_accepted": refs[0][1],
                       "pose_graph.lm_iterations": 20}
    cache = pg_cache._SIM3_GRAPHS if sim3 else pg_cache._SE3_GRAPHS
    assert len(cache.graphs) == 1
    got, counters = _recorded(lambda: [run(c) for c in cases])
    for res, (ref, _) in zip(got, refs):
        assert _same_pg(res, ref)
    assert counters == {"pose_graph.graph_replays": 4,
                        "pose_graph.lm_accepted": sum(a for _, a in refs),
                        "pose_graph.lm_iterations": 80}
    assert not torch.equal(got[0].ts, got[1].ts)


@pytest.mark.parametrize("sim3", [False, True])
def test_pose_graph_replay_syncs_nothing(dev, pg_cache, sim3):
    """A replay (copy-in, graph, copies out, the Sim(3) fold; recording on
    and off) under ``set_sync_debug_mode("error")``."""
    from photogrammetry_tpu_torch.utils import profiling

    state, graph, optimize = _pg_case(dev, 23, 30, 5, sim3)
    ref, _ = _pg_eager(state, graph, sim3)
    for _ in range(2):
        optimize(state[0], state[1], graph)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        res = optimize(state[0], state[1], graph)
        with profiling.recording():
            again = optimize(state[0], state[1], graph)
    finally:
        torch.cuda.set_sync_debug_mode(0)
        profiling.clear()
    assert _same_pg(res, ref) and _same_pg(again, ref)


@pytest.mark.parametrize("mode", ["rotation", "revisit_sim3"])
def test_close_loops_same_bits_with_and_without_the_graph_cache(
        dev, pg_cache, monkeypatch, mode):
    """close_loops on the card: its first call (the pose graph eager), its
    second (captured) and third (replayed) and a call with the cache
    emptied and held at size 0 (eager) give the same poses, costs and
    edges."""
    from photogrammetry_tpu_torch.sfm.loop_closure import close_loops

    feats, rs, ts, kmat, fc = _revisit_scene(dev)

    def run():
        gen = torch.Generator(device=dev).manual_seed(7)
        return close_loops(feats, rs, ts, kmat, fc, generator=gen,
                           min_gap=3, min_matches=18, mode=mode)

    runs, counters = _recorded(lambda: [run() for _ in range(3)])
    assert counters["pose_graph.eager_solves"] == 1
    assert counters["pose_graph.graph_captures"] == 1
    assert counters["pose_graph.graph_replays"] == 2
    for cache in (pg_cache._SE3_GRAPHS, pg_cache._SIM3_GRAPHS):
        monkeypatch.setattr(cache, "MAX_GRAPHS", 0)
        cache.graphs.clear()
    runs.append(run())
    (rs0, ts0, info0), *rest = runs
    assert info0["loop_edges"] and (2, 5) in info0["loop_edges"]
    for rs_k, ts_k, info in rest:
        assert torch.equal(torch.as_tensor(rs_k), torch.as_tensor(rs0))
        assert torch.equal(torch.as_tensor(ts_k), torch.as_tensor(ts0))
        assert info["loop_edges"] == info0["loop_edges"]
        assert (info["cost"], info["initial_cost"]) == \
            (info0["cost"], info0["initial_cost"])


# ------------------------------ the fused steady step as CUDA graphs


def _pan8():
    """tests/test_torch_sfm.py's 8-frame 480x640 pan."""
    from photogrammetry_tpu_torch.synth.star_scene import (
        StarSceneConfig, generate_sequence,
    )

    return generate_sequence(StarSceneConfig(num_frames=8, supersample=2))


def _same_run(a, b) -> bool:
    return (np.array_equal(a.rs, b.rs) and np.array_equal(a.ts, b.ts)
            and torch.equal(a.table.points, b.table.points)
            and a.costs == b.costs)


@pytest.mark.parametrize("pm", [False, True])
def test_fused_step_replay_bit_identical(dev, pm):
    """The captured step replayed over the 8-frame pan gives the eager
    staged run's bits: the first fused run (its first steady frame the
    warm-up, the rest replays), a second (the capture reused: every
    steady frame a replay) and ``run_incremental_sfm_fused`` (the same
    capture)."""
    from photogrammetry_tpu_torch.sfm.incremental import (
        SfmConfig, run_incremental_sfm, run_incremental_sfm_fused,
        steady_step,
    )

    scene = _pan8()
    frames, k = scene["frames"], scene["k"]
    cfg = SfmConfig(collect_diagnostics=False, precompute_matching=pm)
    staged = run_incremental_sfm(frames, k, cfg, seed=3, device=dev)
    fused = SfmConfig(collect_diagnostics=False, precompute_matching=pm,
                      fused_steady_steps=True)
    for _ in range(2):
        got = run_incremental_sfm(frames, k, fused, seed=3, device=dev)
        assert [i["pose_init"] for i in got.frame_info].count(
            "fused_step") == 4
        assert _same_run(staged, got)
    scan = run_incremental_sfm_fused(frames, k, cfg, seed=3, device=dev)
    assert _same_run(staged, scan)
    graph = steady_step(cfg, 8, dev).graph
    assert graph.segments == len(graph.cuts) + 1


@pytest.mark.parametrize("pm,segments", [(False, 22), (True, 6)])
def test_fused_step_syncs_only_at_its_cuts(dev, monkeypatch, pm, segments):
    """The step under ``set_sync_debug_mode("error")``: its warm-up, its
    capture and its replays raise on any synchronisation other than the
    eigh / svd cuts.  22 segments a frame without precompute_matching (21
    cuts: two epipolar gates of four 8-point solves, an eigh and an svd
    each; two DLT PnP solves, an eigh and an svd each; the n-view
    triangulation's eigh), 6 with it (no gates in the step)."""
    from photogrammetry_tpu_torch.sfm import incremental as inc

    call = inc._SteadyStep.__call__

    def strict(self, *args):
        torch.cuda.set_sync_debug_mode("error")
        try:
            return call(self, *args)
        finally:
            torch.cuda.set_sync_debug_mode(0)

    monkeypatch.setattr(inc._SteadyStep, "__call__", strict)
    scene = _pan8()
    # a configuration of its own: a fresh capture
    cfg = inc.SfmConfig(collect_diagnostics=False, fused_steady_steps=True,
                        precompute_matching=pm, ba_iterations=12)
    res = inc.run_incremental_sfm(scene["frames"], scene["k"], cfg, seed=3,
                                  device=dev)
    assert np.isfinite(res.rs).all()
    graph = inc.steady_step(cfg, 8, dev).graph
    assert graph.segments == segments == len(graph.cuts) + 1


def test_staged_sfm_same_bits_in_a_second_process(dev):
    """The staged SfM on the 8-frame pan gives the same bits in a second,
    spawned process on the card as in this one."""
    import multiprocessing as mp

    from photogrammetry_tpu_torch.sfm.incremental import (
        SfmConfig, run_incremental_sfm,
    )

    scene = _pan8()
    cfg = SfmConfig(collect_diagnostics=False)
    res = run_incremental_sfm(scene["frames"], scene["k"], cfg, seed=3,
                              device=dev)
    with mp.get_context("spawn").Pool(1) as pool:
        rs, ts, points, costs = pool.apply(
            _staged_run_numpy, (scene["frames"], scene["k"], 3))
    assert np.array_equal(res.rs, rs) and np.array_equal(res.ts, ts)
    assert np.array_equal(res.table.points.cpu().numpy(), points)
    assert res.costs == costs


def _staged_run_numpy(frames, k, seed):
    """A staged run on the card, in numpy (for a spawned process)."""
    from photogrammetry_tpu_torch.sfm.incremental import (
        SfmConfig, run_incremental_sfm,
    )

    res = run_incremental_sfm(frames, k, SfmConfig(collect_diagnostics=False),
                              seed=seed, device="cuda")
    return res.rs, res.ts, res.table.points.cpu().numpy(), res.costs


def test_fused_capture_failure_raises(dev, monkeypatch):
    """A capture that fails raises out of the run: here a host read
    planted in the step's prune stage, which the eager bootstrap frame and
    warm-up take and a capture cannot.  Nothing falls back to the staged
    loop, and the step stays uncaptured."""
    from photogrammetry_tpu_torch.sfm import incremental as inc

    prune = inc._prune_observations

    def reads(table, *args):
        float(table.points.sum())
        return prune(table, *args)

    monkeypatch.setattr(inc, "_prune_observations", reads)
    scene = _pan8()
    cfg = inc.SfmConfig(collect_diagnostics=False, fused_steady_steps=True,
                        ba_iterations=11)
    with pytest.raises(RuntimeError):
        inc.run_incremental_sfm(scene["frames"], scene["k"], cfg, seed=3,
                                device=dev)
    assert inc.steady_step(cfg, 8, dev).graph is None


def test_graph_replay_counts_its_launches(dev):
    """A capture, which runs nothing, leaves the kernels' ``.launches`` as
    they were; each replay adds what the capture recorded (here one Schur
    and one Hamming launch), as an eager call would."""
    from photogrammetry_tpu_torch.utils.graphs import (
        SegmentedGraph, sync_point,
    )

    args = (*_schur_args(dev, 5, 700), _bits(dev, 64, 256, 1),
            _bits(dev, 48, 256, 2), *_masks(dev, 64, 48, 3))

    def fn(w_hinv, w_cp, b_p, b1, b2, m1, m2):
        s_off, corr = schur.schur_products(w_hinv, w_cp, b_p)
        g = s_off[0, 0] @ s_off[0, 0].T + torch.eye(6, device=dev)
        vals = sync_point(torch.linalg.eigvalsh, g)
        return (s_off, corr, vals * 2.0,
                hamming.hamming_distance_matrix(b1, b2, m1, m2))

    eager = fn(*args)           # builds the kernels
    counters = (schur.schur_products, hamming.hamming_distance_matrix)
    before = [c.launches for c in counters]
    graph = SegmentedGraph(dev)
    out = graph.capture(fn, *args)
    assert [c.launches for c in counters] == before
    assert graph.segments == 2 and len(graph.cuts) == 1
    for n in (1, 2):
        graph.replay()
        assert [c.launches for c in counters] == [b + n for b in before]
    torch.cuda.synchronize()
    for a, b in zip(out, eager):
        assert torch.equal(a, b)


def test_fused_run_counts_the_staged_launches(dev):
    """The fused run's wrapper counters read the staged run's Schur and
    Hamming launches, replays included (the 8-frame pan, a fresh capture
    and the capture reused)."""
    from photogrammetry_tpu_torch.sfm.incremental import (
        SfmConfig, run_incremental_sfm,
    )

    scene = _pan8()
    counters = (schur.schur_products, hamming.hamming_distance_matrix)

    def launches(cfg):
        before = [c.launches for c in counters]
        run_incremental_sfm(scene["frames"], scene["k"], cfg, seed=3,
                            device=dev)
        return [c.launches - b for c, b in zip(counters, before)]

    cfg = SfmConfig(collect_diagnostics=False, ba_iterations=13)
    staged = launches(cfg)
    assert min(staged) > 0
    fused = SfmConfig(collect_diagnostics=False, ba_iterations=13,
                      fused_steady_steps=True)
    assert launches(fused) == staged == launches(fused)
