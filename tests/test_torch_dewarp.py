"""Port parity: the cubic solver, the distortion maps, the remap (plain
version and applier) and the map cache against the JAX package on the CPU.

Tolerances, each beside the difference measured on this CPU (torch 2.13,
jax 0.9):

* cubic roots: 2e-5 on well-separated cases (measured 3.0e-7); on 256
  random coefficient triples 1e-4 absolute (measured 1.5e-5: near-double
  roots amplify the last bit of ``acos``/``cbrt``, and torch has no
  ``cbrt``);
* distortion maps at 240x320: 1e-3 px, tightened from the 2e-2 px the JAX
  package holds against its float64 loop (measured: 4.9e-4 px at the
  reference coefficients, where the monic cubic has b = 3000, c = 1e7 and
  last-bit differences in ``acos``/``cos`` are amplified in the root;
  3.1e-5 px at the pure-k1 model and for the synthetic map; 6.1e-5 px for
  the Brown map; ``quantize=True`` equal except where a coordinate lies
  within that distance of an integer);
* ``apply_distortion_map`` on the identical map: ``nearest`` bit-exact;
  ``bilinear`` float32 within 4e-7 relative (measured 2.3e-7, 2 ulp: XLA's
  CPU code contracts the weighted sum into FMAs and torch does not), and
  integer images equal except at rounding ties moved by those 2 ulp, where
  they are 1 apart (measured 0-3 pixels of 2745 per map);
* against the Pallas two-pass kernel in interpret mode: that kernel's own
  tolerances (exact to 5e-3 on axis-aligned maps; mean < 2, max < 30 grey
  levels on a radial map: its cross-term error).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_threads import _one_thread  # noqa: F401
from photogrammetry_tpu.core import cubic as jcubic
from photogrammetry_tpu.kernels.remap import (
    apply_remap_pallas, build_remap_plan,
)
from photogrammetry_tpu.ops import dewarp as jdewarp
from photogrammetry_tpu.store.cache import DistortionMapCache as JaxMapCache
from photogrammetry_tpu_torch.convert import distortion_map_from_jax
from photogrammetry_tpu_torch.core import cubic
from photogrammetry_tpu_torch.kernels import remap
from photogrammetry_tpu_torch.ops import dewarp
from photogrammetry_tpu_torch.store.cache import DistortionMapCache

REF_COEFFS = [3e-4, 1e-7, 0.0, 0.0, 0.0]
K1_ONLY = [1e-5, 0.0, 0.0, 0.0, 0.0]
MAP_TOL_PX = 1e-3


def _t(x):
    return torch.tensor(np.asarray(x))


# ------------------------------------------------------------------ cubic
@pytest.mark.parametrize("bcd,num", [((-6.0, 11.0, -6.0), 3),
                                     ((0.0, 1.0, 1.0), 1)])
def test_cubic_cases_match_jax(bcd, num):
    roots, n = cubic.solve_cubic_real(*bcd)
    j_roots, j_n = jcubic.solve_cubic_real(*bcd)
    assert int(n) == int(j_n) == num
    assert roots.dtype == torch.float32 and n.dtype == torch.int32
    np.testing.assert_allclose(np.sort(roots.numpy()),
                               np.sort(np.asarray(j_roots)), rtol=2e-5,
                               atol=2e-5)
    np.testing.assert_allclose(float(cubic.middle_real_root(*bcd)),
                               float(jcubic.middle_real_root(*bcd)),
                               rtol=2e-5, atol=2e-5)


def test_cubic_random_coefficients_match_jax():
    rng = np.random.default_rng(8)
    b, c, d = (rng.uniform(-5, 5, 256).astype(np.float32) for _ in range(3))
    got = cubic.middle_real_root(_t(b), _t(c), _t(d)).numpy()
    ref = np.asarray(jcubic.middle_real_root(b, c, d))
    _, n = cubic.solve_cubic_real(_t(b), _t(c), _t(d))
    _, j_n = jcubic.solve_cubic_real(b, c, d)
    np.testing.assert_array_equal(n.numpy(), np.asarray(j_n))
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-4)
    # and both solve the cubic
    res = ((got.astype(np.float64) + b) * got + c) * got + d
    assert np.abs(res).max() < 5e-3


def test_cubic_broadcasts():
    got = cubic.middle_real_root(_t(np.float32([[-6.0], [0.0]])),
                                 _t(np.float32([11.0, 1.0])), -6.0)
    assert got.shape == (2, 2)


# ------------------------------------------------------------------- maps
def test_undistorted_radius_matches_jax():
    rds = np.linspace(0.0, 1200.0, 97).astype(np.float32)
    for coeffs in (REF_COEFFS, K1_ONLY, [2e-4, 1e-7, 1e-5, 0.0, 1e-12]):
        c = np.asarray(coeffs, np.float32)
        got = dewarp.solve_undistorted_radius(_t(rds), _t(c)).numpy()
        ref = np.asarray(jdewarp.solve_undistorted_radius(rds, c))
        np.testing.assert_allclose(got, ref, rtol=1e-5, atol=MAP_TOL_PX)
    r0 = np.linspace(0.0, 300.0, 64).astype(np.float32)
    kb = np.float32([4e-7, -2e-13, 0.0, 0.0, 0.0])
    np.testing.assert_allclose(
        dewarp.solve_distorted_radius_brown(_t(r0), _t(kb)).numpy(),
        np.asarray(jdewarp.solve_distorted_radius_brown(r0, kb)),
        rtol=1e-6, atol=1e-4)


@pytest.mark.parametrize("coeffs", [REF_COEFFS, K1_ONLY])
@pytest.mark.parametrize("name", ["generate_distortion_map",
                                  "generate_distortion_map_brown",
                                  "generate_synthetic_distortion_map"])
def test_distortion_maps_match_jax(name, coeffs):
    h, w = 240, 320
    if name.endswith("brown"):
        coeffs = ([4e-7, -2e-13, 0.0, 0.0, 0.0] if coeffs is REF_COEFFS
                  else [1e-6, 0.0, 0.0, 0.0, 0.0])
    got = getattr(dewarp, name)(h, w, coeffs, device="cpu")
    ref = np.asarray(getattr(jdewarp, name)(h, w, coeffs))
    assert got.shape == (h, w, 2) and got.dtype == torch.float32
    assert np.abs(ref - np.mgrid[0:h, 0:w].transpose(1, 2, 0)).max() > 0.1
    np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=MAP_TOL_PX)


@pytest.mark.parametrize("coeffs", [REF_COEFFS, K1_ONLY])
def test_quantized_map_matches_jax(coeffs):
    """Truncated coordinates are equal except where the sub-pixel value
    lies within the map tolerance of an integer (then they are 1 apart)."""
    h, w = 240, 320
    got = dewarp.generate_distortion_map(h, w, coeffs, quantize=True,
                                         device="cpu").numpy()
    ref = np.asarray(jdewarp.generate_distortion_map(h, w, coeffs,
                                                     quantize=True))
    sub = np.asarray(jdewarp.generate_distortion_map(h, w, coeffs))
    np.testing.assert_array_equal(got, np.trunc(got))
    differ = got != ref
    assert np.abs(got - ref).max() <= 1.0
    assert (np.abs(sub - np.rint(sub))[differ] <= MAP_TOL_PX).all()
    assert differ.mean() < 1e-3


# ------------------------------------------------------------------ remap
def _maps(rng, h, w):
    """Maps that exercise every branch of the remap: name -> (H', W', 2)."""
    rows, cols = np.mgrid[0:h, 0:w].astype(np.float32)
    radial = np.asarray(jdewarp.generate_distortion_map(
        h, w, (1.2e-3, 1.6e-6, 0, 0, 0)))
    big_r, big_c = np.mgrid[0:h + 9, 0:w + 14].astype(np.float32)
    folded = radial.copy()
    folded[..., 1] = np.abs(cols - w / 2.0) * 1.7 + 0.3
    far = radial.copy()
    far[::7, ::5] = 1e9
    far[1::7, ::5] = -1e9
    far[2::7, ::5, 0] = 3e38
    half = np.stack([rows, cols + (w - 0.5) - (w - 1)], -1)  # col W-0.5 last
    return {
        "radial": radial,
        "shifted": np.stack([rows * 0.8 + 5.3, cols * 0.9 - 3.25], -1),
        "larger_than_source": np.stack([big_r * 0.9 - 2.5,
                                        big_c * 0.95 - 4.25], -1),
        "folded": folded,
        "far_outside": far,
        "all_outside": np.full((h, w, 2), 100.0 + max(h, w), np.float32),
        "half_tap": half.astype(np.float32),
        "random": np.stack([rng.uniform(-3, h + 3, (h, w)),
                            rng.uniform(-3, w + 3, (h, w))],
                           -1).astype(np.float32),
    }


@pytest.mark.parametrize("mode", ["bilinear", "nearest"])
@pytest.mark.parametrize("kind", ["u8_gray", "u8_rgb", "f32_gray",
                                  "f32_rgb", "i32_gray"])
def test_apply_distortion_map_exact_on_identical_map(kind, mode):
    rng = np.random.default_rng(11)
    h, w = 45, 61
    shape = (h, w, 3) if kind.endswith("rgb") else (h, w)
    if kind.startswith("u8"):
        img = rng.integers(0, 256, shape).astype(np.uint8)
    elif kind.startswith("i32"):
        img = rng.integers(0, 1000, shape).astype(np.int32)
    else:
        img = rng.uniform(0, 255, shape).astype(np.float32)
    for name, dmap in _maps(rng, h, w).items():
        ref = np.asarray(jdewarp.apply_distortion_map(
            jnp.asarray(img), jnp.asarray(dmap), mode=mode))
        dmap_t = distortion_map_from_jax(dmap, device="cpu")
        got = dewarp.apply_distortion_map(_t(img), dmap_t, mode=mode)
        assert got.dtype == _t(img).dtype and got.shape == ref.shape, name
        got = got.numpy()
        if mode == "nearest":
            np.testing.assert_array_equal(got, ref, err_msg=name)
        elif img.dtype == np.float32:
            # XLA's CPU code contracts the weighted sum into FMAs, torch
            # does not: measured 2.3e-7 relative (2 ulp), never more
            np.testing.assert_allclose(got, ref, rtol=4e-7, atol=0,
                                       err_msg=name)
        else:
            # equal, except where those 2 ulp carry the float sum across
            # a rounding tie: then 1 apart (measured: 0 to 3 pixels a map)
            sums = dewarp.apply_distortion_map(_t(img).float(), dmap_t)
            differ = got != ref
            assert np.abs(got.astype(np.int64) - ref).max() <= 1, name
            frac = sums.numpy()[differ] % 1.0
            assert (np.abs(frac - 0.5) < 1e-3).all(), name
            assert differ.mean() < 2e-3, name


def test_half_tap_and_out_of_bounds():
    """Taps are tested one by one: a sample at column W-0.5 keeps half of
    the last column's value; a sample past every border is 0."""
    img = np.full((4, 6), 200.0, np.float32)
    rows, cols = np.mgrid[0:4, 0:6].astype(np.float32)
    dmap = np.stack([rows, np.full_like(cols, 5.5)], -1)
    out = dewarp.apply_distortion_map(_t(img), _t(dmap))
    assert (out == 100.0).all()
    dmap[..., 1] = -0.25
    assert (dewarp.apply_distortion_map(_t(img), _t(dmap)) == 150.0).all()
    out = dewarp.apply_distortion_map(_t(img), torch.full((4, 6, 2), 100.0))
    assert (out == 0).all()
    out = dewarp.apply_distortion_map(
        _t(np.float32([[0.0, 10.0], [20.0, 30.0]])),
        torch.tensor([[[0.5, 0.5]]]))
    assert float(out[0, 0]) == 15.0
    with pytest.raises(ValueError, match="mode"):
        dewarp.apply_distortion_map(_t(img), _t(dmap), mode="cubic")


def test_non_finite_map_entries():
    """A NaN or infinite map entry: the JAX function casts NaN to an index
    (0 on this CPU, so the taps land on pixel (0, 0) with NaN weights) and
    returns NaN for a float image and an unspecified integer for uint8.
    The port defines it: a non-finite entry samples nothing and gives 0,
    for every dtype, in the plain version and in the kernel alike.  Finite
    entries far outside (+-1e9, 3e38) give 0 in both packages."""
    rng = np.random.default_rng(12)
    img = rng.uniform(1, 255, (9, 11)).astype(np.float32)
    rows, cols = np.mgrid[0:9, 0:11].astype(np.float32)
    dmap = np.stack([rows, cols], -1)
    dmap[2, 3] = np.nan
    dmap[4, 5, 0] = np.inf
    dmap[6, 7, 1] = -np.inf
    dmap[1, 1] = 1e9
    dmap[1, 2] = -1e9
    bad = [(2, 3), (4, 5), (6, 7), (1, 1), (1, 2)]
    ref = np.asarray(jdewarp.apply_distortion_map(jnp.asarray(img),
                                                  jnp.asarray(dmap)))
    assert np.isnan(ref[2, 3]) and ref[1, 1] == 0 and ref[1, 2] == 0
    for im in (img, img.astype(np.uint8)):
        for mode in ("bilinear", "nearest"):
            out = dewarp.apply_distortion_map(_t(im), _t(dmap),
                                              mode=mode).numpy()
            keep = np.ones((9, 11), bool)
            for rc in bad:
                assert out[rc] == 0
                keep[rc] = False
            np.testing.assert_array_equal(out[keep], im[keep])


def test_remap_against_pallas_kernel_interpret():
    """The port's exact remap beside the two-pass TPU kernel, run as the
    JAX package's tests run it on the CPU."""
    rng = np.random.default_rng(40)
    h, w = 96, 192
    img = rng.integers(0, 255, (h, w)).astype(np.float32)
    rows = np.arange(h)[:, None] * np.ones((1, w))
    cols = np.arange(w)[None, :] * np.ones((h, 1))
    for sr, sc in [(rows + 2.5, cols - 3.25),
                   (rows * 0.8 + 5.3, cols * 0.9 + 2.0)]:
        dmap = np.stack([sr, sc], axis=-1).astype(np.float32)
        plan = build_remap_plan(dmap, (h, w), tile=(32, 128))
        ref = np.asarray(apply_remap_pallas(jnp.asarray(img), plan,
                                            interpret=True))
        got = dewarp.apply_distortion_map(_t(img), _t(dmap)).numpy()
        np.testing.assert_allclose(got, ref, atol=5e-3)   # axis-aligned

    h, w = 135, 240
    img = rng.integers(0, 255, (h, w)).astype(np.float32)
    dmap = np.asarray(jdewarp.generate_distortion_map(
        h, w, (1.2e-3, 1.6e-6, 0, 0, 0)))
    plan = build_remap_plan(dmap, (h, w), tile=(32, 128))
    ref = np.asarray(apply_remap_pallas(jnp.asarray(img), plan,
                                        interpret=True))
    err = np.abs(dewarp.apply_distortion_map(_t(img), _t(dmap)).numpy()
                 - ref)
    assert err.mean() < 2.0 and err.max() < 30.0          # cross-term


def test_wrapper_runs_plain_on_cpu_and_checks_inputs():
    rng = np.random.default_rng(13)
    imgs = _t(rng.integers(0, 256, (2, 20, 30, 3)).astype(np.uint8))
    dmap = _t(np.stack([rng.uniform(-2, 22, (25, 33)),
                        rng.uniform(-2, 32, (25, 33))], -1)
              .astype(np.float32))
    before = remap.remap_bilinear.launches
    out = remap.remap_bilinear(imgs, dmap)
    assert remap.remap_bilinear.launches == before   # no kernel on the CPU
    assert out.shape == (2, 25, 33, 3) and out.dtype == torch.uint8
    assert torch.equal(out, dewarp.remap_plain(imgs, dmap))
    for b in range(2):
        assert torch.equal(out[b],
                           dewarp.apply_distortion_map(imgs[b], dmap))
    # on the CPU any real dtype goes to the plain version
    assert torch.equal(remap.remap_bilinear(imgs.to(torch.int32), dmap),
                       dewarp.remap_plain(imgs.to(torch.int32), dmap))
    with pytest.raises(ValueError, match="float32 map"):
        remap.remap_bilinear(imgs, dmap.double())
    with pytest.raises(ValueError, match="want B, H, W, C"):
        remap.remap_bilinear(imgs[0], dmap)
    assert remap.SOURCE.endswith("csrc/remap.cu")
    assert remap.REPLACES.startswith("photogrammetry_tpu/kernels/remap.py")


def test_applier_equals_plain_and_stacks():
    rng = np.random.default_rng(14)
    h, w = 40, 56
    dmap = dewarp.generate_distortion_map(h, w, REF_COEFFS, device="cpu")
    gray = rng.uniform(0, 255, (3, h, w)).astype(np.float32)
    rgb = rng.integers(0, 256, (3, h, w, 3)).astype(np.uint8)
    for kwargs in ({}, {"plain": True}):
        apply = dewarp.make_distortion_applier(dmap.numpy(), (h, w),
                                               device="cpu", **kwargs)
        for stack in (gray, rgb):
            out = apply(stack)                       # numpy in, tensor out
            assert out.shape == stack.shape
            for i in range(3):
                one = apply(_t(stack[i]))
                assert torch.equal(one, out[i])
                assert torch.equal(one, dewarp.apply_distortion_map(
                    _t(stack[i]), dmap))
    with pytest.raises(ValueError, match="not .H, W."):
        apply(np.zeros((h + 1, w + 1), np.float32))
    with pytest.raises(ValueError):
        dewarp.make_distortion_applier(np.zeros((h, w)), (h, w),
                                       device="cpu")


@pytest.mark.parametrize("dtype", ["int16", "int32", "float64", "float16"])
def test_applier_takes_any_real_dtype(dtype):
    """The applier on images neither float32 nor uint8: through the f32
    remap and back, bit-identical to ``apply_distortion_map``; against the
    JAX applier the module's tolerances (2 ulp of f32, integers 1 apart at
    rounding ties moved by them; float16 one half-precision ulp where the
    f32 sum sits on a float16 rounding boundary; JAX without x64 computes
    a float64 image in float32)."""
    rng = np.random.default_rng(15)
    h, w = 40, 56
    if dtype.startswith("int"):
        img = rng.integers(-1000, 1000, (2, h, w)).astype(dtype)
    else:
        img = rng.uniform(0, 255, (2, h, w)).astype(dtype)
    dmap = dewarp.generate_distortion_map(h, w, REF_COEFFS, device="cpu")
    apply = dewarp.make_distortion_applier(dmap.numpy(), (h, w),
                                           device="cpu")
    got = apply(img)
    assert got.dtype == _t(img).dtype and got.shape == img.shape
    japply = jdewarp.make_distortion_applier(dmap.numpy(), (h, w),
                                             use_pallas=False)
    for i in range(2):
        assert torch.equal(got[i], dewarp.apply_distortion_map(_t(img[i]),
                                                               dmap))
        ref = np.asarray(japply(jnp.asarray(img[i]))).astype(np.float64)
        one = got[i].numpy().astype(np.float64)
        if dtype.startswith("int"):
            differ = one != ref
            assert np.abs(one - ref).max() <= 1
            sums = dewarp.apply_distortion_map(_t(img[i]).float(), dmap)
            assert (np.abs(sums.numpy()[differ] % 1.0 - 0.5) < 1e-3).all()
            assert differ.mean() < 2e-3
        elif dtype == "float16":
            differ = one != ref
            np.testing.assert_allclose(one, ref, rtol=2.0 ** -10, atol=0)
            assert differ.mean() < 2e-3
        else:
            np.testing.assert_allclose(one, ref, rtol=4e-7, atol=0)


def test_synthesize_then_dewarp_round_trip():
    """Distort a smooth frame the way the camera would, dewarp it, and
    compare the interior with the clean frame (two bilinear resamplings of
    a smooth image: measured max 0.105 grey levels, mean 0.024)."""
    h, w = 240, 320
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    clean = (127 + 60 * np.sin(xx / 17.0) * np.cos(yy / 23.0)
             + 40 * np.sin((xx + yy) / 31.0)).astype(np.float32)
    coeffs = [3e-4, 1e-7, 0, 0, 0]
    synth = dewarp.generate_synthetic_distortion_map(h, w, coeffs,
                                                     device="cpu")
    dmap = dewarp.generate_distortion_map(h, w, coeffs, device="cpu")
    captured = dewarp.apply_distortion_map(_t(clean), synth)
    assert float((captured - _t(clean)).abs().max()) > 20   # really warped
    back = dewarp.apply_distortion_map(captured, dmap).numpy()
    err = np.abs(back - clean)[20:-20, 20:-20]
    assert err.max() < 0.5 and err.mean() < 0.1


def test_map_cache_is_shared_between_packages(tmp_path):
    h, w = 48, 64
    theirs = JaxMapCache(str(tmp_path / "jax"))
    ours = DistortionMapCache(str(tmp_path / "jax"))
    written = theirs.get_or_generate(h, w, REF_COEFFS)
    read = ours.get_or_generate(h, w, REF_COEFFS, device="cpu")
    np.testing.assert_array_equal(read, written)     # read, not regenerated

    ours = DistortionMapCache(str(tmp_path / "torch"))
    written = ours.get_or_generate(h, w, K1_ONLY, device="cpu")
    assert written.dtype == np.float32 and written.shape == (h, w, 2)
    names = [p.name for p in (tmp_path / "torch").iterdir()]
    assert names == ["dim_64x48_coeff_1e-05_0.0_0.0_0.0_0.0.npz"]
    read = JaxMapCache(str(tmp_path / "torch")).get_or_generate(h, w, K1_ONLY)
    np.testing.assert_array_equal(read, written)
    np.testing.assert_allclose(
        written, np.asarray(jdewarp.generate_distortion_map(h, w, K1_ONLY)),
        rtol=0, atol=MAP_TOL_PX)
    again = ours.get_or_generate(h, w, K1_ONLY, refresh=True, device="cpu")
    np.testing.assert_array_equal(again, written)


def test_distortion_map_from_jax_checks():
    dmap = np.asarray(jdewarp.generate_distortion_map(12, 16, REF_COEFFS))
    got = distortion_map_from_jax(dmap, device="cpu")
    assert got.dtype == torch.float32 and got.is_contiguous()
    np.testing.assert_array_equal(got.numpy(), dmap)
    view = np.asarray(dmap)[:, ::2]                  # not contiguous
    assert distortion_map_from_jax(view, device="cpu").is_contiguous()
    with pytest.raises(TypeError):
        distortion_map_from_jax(dmap.astype(np.float64), device="cpu")
    with pytest.raises(ValueError):
        distortion_map_from_jax(dmap[..., 0], device="cpu")
    assert jax.default_backend() == "cpu"
