"""Port parity: ops/calibrate.py and the calibrate_dewarp CLI against the
JAX package on the CPU, on identical numpy inputs.

Tolerances, each beside the difference measured on this CPU (torch 2.13,
jax 0.9), in pixels at 480x640 unless said otherwise:

* ``undistort_points`` 1e-4 (measured 0: closed form); ``distort_points``
  5e-4 (measured 6.1e-5: the cubic root differs in its last bits and two
  Newton steps polish both); the Brown pair 5e-4 (measured <= 6.1e-5);
* ``line_residuals`` 5e-4 (measured 6.3e-5: sums over 64 points in another
  order, ``atan2``/``sin``/``cos`` of two libraries);
* d distort_points / d coeffs against ``jax.jacfwd``: 1e-5 of the largest
  entry of each coefficient's column (measured 6.2e-8);
* ``sobel_magnitude`` within 1 ulp (2e-7 relative: the two ``sqrt``);
  ``extract_edge_points`` indices equal on grids and planted lines, where
  thousands of magnitudes tie (ties to the lower index in both);
* ``hough_from_points``: peak bins (theta exactly, as multiples of pi/180),
  votes equal, rho within 1e-4 (XLA folds the bin -> rho scaling into
  other constants); ``assign_points_to_lines`` indices and masks equal;
* ``calibrate_distortion`` on identical grouped points: k1 within 1e-4 and
  k2 within 1e-3 relative of the JAX fit (measured 1.9e-6, 1.2e-5), and
  both within the 1e-3 of tests/test_calibrate.py of the true [3e-4, 1e-7].
"""
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_threads import _one_thread  # noqa: F401
from photogrammetry_tpu.ops import calibrate as jcal
from photogrammetry_tpu.ops import dewarp as jdewarp
from photogrammetry_tpu_torch.cli import calibrate_dewarp
from photogrammetry_tpu_torch.ops import calibrate as cal
from photogrammetry_tpu_torch.ops import dewarp

TRUE = np.float32([3e-4, 1e-7, 0.0, 0.0, 0.0])
BROWN_TRUE = np.float32([4e-7, -2e-13, 0.0, 0.0, 0.0])
H, W = 480, 640
CENTER = np.float32([H / 2.0, W / 2.0])


def _t(x):
    return torch.tensor(np.asarray(x))


def synthetic_lines(num_lines=10, pts_per_line=64, seed=0):
    """The line fixture of tests/test_calibrate.py: (L, P, 2) float32."""
    rng = np.random.default_rng(seed)
    groups = []
    for _ in range(num_lines):
        p0 = rng.uniform([0, 0], [H, W])
        d = rng.normal(size=2)
        d /= np.linalg.norm(d)
        t = np.linspace(-300, 300, pts_per_line)
        groups.append(p0[None, :] + t[:, None] * d[None, :])
    return np.stack(groups).astype(np.float32)


def grid_image(h, w, pitch):
    yy, xx = np.meshgrid(np.arange(h), np.arange(w), indexing="ij")
    return ((xx % pitch < 3) | (yy % pitch < 3)).astype(np.float32) * 255.0


@pytest.mark.parametrize("name,coeffs,tol", [
    ("undistort_points", TRUE, 1e-4), ("distort_points", TRUE, 5e-4),
    ("undistort_points_brown", BROWN_TRUE, 5e-4),
    ("distort_points_brown", BROWN_TRUE, 5e-4)])
def test_point_models_match_jax(name, coeffs, tol):
    pts = synthetic_lines()
    ref = np.asarray(getattr(jcal, name)(jnp.asarray(pts),
                                         jnp.asarray(coeffs),
                                         jnp.asarray(CENTER)))
    got = getattr(cal, name)(_t(pts), _t(coeffs), _t(CENTER))
    assert got.dtype == torch.float32 and got.shape == pts.shape
    assert np.abs(ref - pts).max() > 1.0          # the model moves points
    np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=tol)
    # lists and numpy arrays are taken as coefficients and center too
    again = getattr(cal, name)(_t(pts), list(map(float, coeffs)), CENTER)
    assert torch.equal(again, got)


def test_distort_undistort_round_trip():
    pts = synthetic_lines()
    dist = cal.distort_points(_t(pts), TRUE, CENTER)
    assert float((dist - _t(pts)).norm(dim=-1).max()) > 5.0
    back = cal.undistort_points(dist, TRUE, CENTER)
    np.testing.assert_allclose(back.numpy(), pts, atol=2e-2)
    dist = cal.distort_points_brown(_t(pts), BROWN_TRUE, CENTER)
    back = cal.undistort_points_brown(dist, BROWN_TRUE, CENTER)
    np.testing.assert_allclose(back.numpy(), pts, atol=5e-2)


def test_distort_points_gradient_matches_jax():
    pts = synthetic_lines()[:3, ::8]
    ref = np.asarray(jax.jacfwd(lambda k: jcal.distort_points(
        jnp.asarray(pts), k, jnp.asarray(CENTER)))(jnp.asarray(TRUE)))
    got = torch.func.jacrev(lambda k: cal.distort_points(
        _t(pts), k, _t(CENTER)))(_t(TRUE)).numpy()
    assert got.shape == ref.shape == (*pts.shape, 5)
    assert np.isfinite(got).all()
    scale = np.abs(ref).max(axis=(0, 1, 2))
    assert (scale > 0).all()
    assert (np.abs(got - ref).max(axis=(0, 1, 2)) <= 1e-5 * scale).all()
    # reverse mode through autograd agrees with the functional transform
    k = _t(TRUE).requires_grad_()
    cal.distort_points(_t(pts), k, _t(CENTER))[0, 0, 0].backward()
    np.testing.assert_allclose(k.grad.numpy(), got[0, 0, 0], rtol=1e-5)


def test_line_residuals_match_jax():
    rng = np.random.default_rng(1)
    pts = synthetic_lines()
    mask = rng.random(pts.shape[:2]) > 0.2
    dist = np.asarray(jcal.distort_points(jnp.asarray(pts),
                                          jnp.asarray(TRUE),
                                          jnp.asarray(CENTER)))
    ref = np.asarray(jcal.line_residuals(jnp.asarray(dist),
                                         jnp.asarray(mask)))
    got = cal.line_residuals(_t(dist), _t(mask)).numpy()
    assert np.abs(ref).max() > 1.0                  # curved lines
    np.testing.assert_allclose(got, ref, rtol=0, atol=5e-4)
    assert (got[~mask] == 0).all()
    straight = cal.line_residuals(_t(pts), torch.ones(pts.shape[:2],
                                                      dtype=torch.bool))
    assert float(straight.abs().max()) < 1e-2


@pytest.mark.parametrize("model", ["rational", "brown"])
def test_calibrate_distortion_matches_jax(model):
    if model == "rational":
        pts = synthetic_lines()
        dist = np.asarray(jcal.distort_points(
            jnp.asarray(pts), jnp.asarray(TRUE), jnp.asarray(CENTER)))
        true = TRUE
    else:
        ts = np.linspace(-220.0, 220.0, 64)
        rows = []
        for c in np.linspace(-220.0, 220.0, 8):
            rows.append(np.stack([np.full(64, c), ts], -1))
            rows.append(np.stack([ts, np.full(64, c)], -1))
        pts = (np.stack(rows) + CENTER).astype(np.float32)
        dist = np.asarray(jcal.distort_points_brown(
            jnp.asarray(pts), jnp.asarray(BROWN_TRUE), jnp.asarray(CENTER)))
        true = BROWN_TRUE
    mask = np.ones(dist.shape[:2], bool)
    ref = jcal.calibrate_distortion(jnp.asarray(dist), jnp.asarray(mask),
                                    jnp.asarray(CENTER), num_iterations=40,
                                    model=model)
    got = cal.calibrate_distortion(_t(dist), _t(mask), _t(CENTER),
                                   num_iterations=40, model=model)
    np.testing.assert_allclose(float(got.initial_cost),
                               float(ref.initial_cost), rtol=1e-4)
    assert float(got.cost) < 1e-2 * float(got.initial_cost)
    if model == "rational":
        np.testing.assert_allclose(got.coeffs[:2].numpy(), [3e-4, 1e-7],
                                   rtol=1e-3)
        np.testing.assert_allclose(np.asarray(ref.coeffs[:2]), [3e-4, 1e-7],
                                   rtol=1e-3)
        np.testing.assert_allclose(got.coeffs[0], float(ref.coeffs[0]),
                                   rtol=1e-4)
        np.testing.assert_allclose(got.coeffs[1], float(ref.coeffs[1]),
                                   rtol=1e-3)
        assert float(got.cost) < 1e-3 * float(got.initial_cost)
    else:
        # the even-power fit is ill-conditioned past k1 (the JAX package's
        # own test holds k1 to 20% of the truth)
        assert float(got.coeffs[0]) == pytest.approx(float(true[0]),
                                                     rel=0.2)
        assert float(got.coeffs[0]) == pytest.approx(float(ref.coeffs[0]),
                                                     rel=0.05)
    assert (got.coeffs[3:] == 0).all()


def test_calibrate_param_mask_and_holes():
    pts = synthetic_lines()
    mask = np.ones(pts.shape[:2], bool)
    mask[:, ::3] = False
    dist = cal.distort_points(_t(pts), TRUE, CENTER)
    res = cal.calibrate_distortion(dist, _t(mask), CENTER,
                                   num_iterations=40,
                                   param_mask=[1.0, 0.0, 0.0, 0.0, 0.0])
    assert float(res.coeffs[1]) == 0.0
    assert abs(float(res.coeffs[0]) - 3e-4) < 1e-4
    with pytest.raises(ValueError, match="model"):
        cal.calibrate_distortion(dist, _t(mask), CENTER, model="fisheye")


def test_sobel_and_edge_points_match_jax():
    rng = np.random.default_rng(2)
    img = rng.integers(0, 256, (60, 80)).astype(np.float32)
    # gx^2 + gy^2 is exact on integer images; the two sqrt differ by 1 ulp
    # on 0.6% of the pixels (measured 1.2e-7 relative)
    np.testing.assert_allclose(
        cal.sobel_magnitude(_t(img)).numpy(),
        np.asarray(jcal.sobel_magnitude(jnp.asarray(img))), rtol=2e-7)
    # a grid: thousands of tied magnitudes, ties to the lower index
    image = grid_image(120, 160, 24)
    pts, val = cal.extract_edge_points(_t(image), num_points=1024)
    j_pts, j_val = jcal.extract_edge_points(jnp.asarray(image),
                                            num_points=1024)
    np.testing.assert_array_equal(pts.numpy(), np.asarray(j_pts))
    np.testing.assert_allclose(val.numpy(), np.asarray(j_val), rtol=2e-7)
    assert len(np.unique(val.numpy())) < 10 and float(val.min()) > 0


def test_hough_and_assignment_match_jax():
    img = np.zeros((H, W), np.float32)
    img[100, :] = 255.0   # theta 0, rho 100 - 240
    img[:, 500] = 255.0   # theta pi/2, rho 500 - 320
    img[np.arange(400), np.arange(400) + 50] = 255.0    # a diagonal
    pts, val = cal.extract_edge_points(_t(img), num_points=2048)
    j_pts, j_val = jcal.extract_edge_points(jnp.asarray(img),
                                            num_points=2048)
    extent = float(np.hypot(H / 2, W / 2))
    lines = cal.hough_from_points(pts, val, _t(CENTER), extent, num_lines=4)
    j_lines = jcal.hough_from_points(j_pts, j_val, jnp.asarray(CENTER),
                                     extent, num_lines=4)
    tbin = np.rint(lines.theta.numpy() / (np.pi / 180)).astype(int)
    j_tbin = np.rint(np.asarray(j_lines.theta) / (np.pi / 180)).astype(int)
    np.testing.assert_array_equal(tbin, j_tbin)
    np.testing.assert_array_equal(lines.votes.numpy(),
                                  np.asarray(j_lines.votes))
    np.testing.assert_allclose(lines.theta.numpy(),
                               np.asarray(j_lines.theta), rtol=1e-6)
    np.testing.assert_allclose(lines.rho.numpy(), np.asarray(j_lines.rho),
                               rtol=0, atol=1e-4)
    got = sorted(zip(lines.theta.tolist(), lines.rho.tolist()))
    assert abs(got[0][0]) < 0.05 and abs(got[0][1] - (100 - 240)) < 4

    ti, mask = cal.assign_points_to_lines(pts, val, lines, _t(CENTER),
                                          tol=3.0)
    j_ti, j_mask = jcal.assign_points_to_lines(j_pts, j_val, j_lines,
                                               jnp.asarray(CENTER), tol=3.0)
    np.testing.assert_array_equal(mask.numpy(), np.asarray(j_mask))
    np.testing.assert_array_equal(ti.numpy(), np.asarray(j_ti))
    assert (mask.sum(1)[:3] > 100).all()

    # votes outside |rho| <= extent are dropped, not clamped into a bin
    far = _t(np.float32([[H / 2 + 5 * extent, W / 2]] * 7))
    none = cal.hough_from_points(far, torch.ones(7), _t(CENTER), extent,
                                 num_lines=1)
    assert float(none.votes[0]) <= 7 * 2    # only the thetas near pi/2


def test_calibrate_from_image_recovers_model():
    """The whole image path on the distorted 480x640 grid of
    tests/test_calibrate.py (at 240x320 the grid's few edge points leave
    the grouping, and with it the fit, to marginal points in both
    packages): the port's radial mapping within the 4 px of that test of
    the truth (measured 2.54 px, JAX 2.54 px) and within 0.1 px of the JAX
    fit on the same image (measured 0.003 px)."""
    dmap = jdewarp.generate_synthetic_distortion_map(H, W, TRUE)
    distorted = np.asarray(jdewarp.apply_distortion_map(
        jnp.asarray(grid_image(H, W, 96)), dmap))
    kwargs = dict(num_lines=10, tol=6.0, rounds=3, num_iterations=40)
    res = cal.calibrate_from_image(_t(distorted), **kwargs)
    ref = jcal.calibrate_from_image(jnp.asarray(distorted), **kwargs)
    assert res.model == "rational"
    assert 1e-4 < float(res.coeffs[0]) < 6e-4
    r = np.linspace(0.0, np.hypot(H / 2, W / 2), 256)

    def fwd(k):
        k = np.asarray(k, np.float64)
        return r * (1 + k[0] * r + k[1] * r ** 2)

    assert np.abs(fwd(res.coeffs.numpy()) - fwd(TRUE)).max() < 4.0
    assert np.abs(fwd(res.coeffs.numpy())
                  - fwd(np.asarray(ref.coeffs))).max() < 0.1
    np.testing.assert_allclose(float(res.cost), float(ref.cost), rtol=1e-3)


def test_calibrate_dewarp_cli(tmp_path, capsys):
    from PIL import Image

    h, w = 240, 320
    true = [6e-4, 4e-7, 0.0, 0.0, 0.0]
    synth = dewarp.generate_synthetic_distortion_map(h, w, true,
                                                     device="cpu")
    distorted = dewarp.apply_distortion_map(_t(grid_image(h, w, 48)), synth)
    img = tmp_path / "grid.png"
    Image.fromarray(distorted.numpy().astype(np.uint8)).save(img)
    coeffs_file = tmp_path / "coeffs.json"
    out = tmp_path / "dewarped.png"
    stats = tmp_path / "stats.json"
    rc = calibrate_dewarp.main(
        [str(img), "--device", "cpu", "--rounds", "2", "--iterations", "25",
         "--tol", "4", "--num-lines", "10", "--save-coefficients",
         str(coeffs_file), "--dewarp-output", str(out), "--stats",
         str(stats)])
    assert rc == 0
    report = json.loads(capsys.readouterr().out.splitlines()[0])
    fitted = json.loads(coeffs_file.read_text())["coefficients"]
    assert report["coefficients"] == fitted and report["model"] == "rational"
    assert report["final_cost"] < report["initial_cost"]
    assert 2e-4 < fitted[0] < 1.2e-3
    assert np.asarray(Image.open(out)).shape == (h, w)
    assert json.loads(stats.read_text())[0]["tool"] == "calibrate_dewarp"
    with pytest.raises(SystemExit):
        other = tmp_path / "other.png"
        Image.fromarray(np.zeros((10, 12), np.uint8)).save(other)
        calibrate_dewarp.main([str(img), str(other), "--device", "cpu"])
