"""Port parity: kernels/schur.py and sfm/ba.py.

The Schur products' plain version (the port's CPU path) is held against
the JAX Pallas kernel in interpret mode and against the JAX einsums,
within the worst-case f32 bound of a 3T-term sum in any order
(``schur.error_bound``, the bound ``chip_smoke.py`` holds the CUDA kernel
to).  Residuals, Jacobians, one Schur solve and whole bundle adjustments
(full, motion-only, pose-prior) run on the noisy star-scene map of
tests/test_ba.py's ``make_problem`` in both packages: the same cost within
1e-4 relative, poses within 1e-4 and landmarks within 1e-4 relative (f32
einsum and LU orders differ).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_threads import _one_thread  # noqa: F401
from photogrammetry_tpu.kernels.schur import schur_products_pallas
from photogrammetry_tpu.sfm import ba as jba
from photogrammetry_tpu_torch.convert import state_from_jax
from photogrammetry_tpu_torch.kernels import schur
from photogrammetry_tpu_torch.sfm import ba
from photogrammetry_tpu_torch.utils import graphs
from test_ba import make_problem

POSE_ATOL = 1e-4
COST_RTOL = 1e-4


def _schur_inputs(f, t, seed):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(f, t, 6, 3)).astype(np.float32),
            rng.normal(size=(f, t, 6, 3)).astype(np.float32),
            rng.normal(size=(t, 3)).astype(np.float32))


def _within_bound(got, ref, bound):
    err = np.abs(np.asarray(got, np.float64) - np.asarray(ref, np.float64))
    assert (err <= bound).all(), float((err / np.maximum(bound, 1e-30))
                                       .max())


@pytest.mark.parametrize("f,t", [(5, 700), (12, 1024)])
def test_schur_plain_within_bound_of_jax(f, t):
    w_hinv, w_cp, b_p = _schur_inputs(f, t, f)
    args = [torch.tensor(x) for x in (w_hinv, w_cp, b_p)]
    s, c = schur.schur_products_plain(*args)
    sb, cb = (x.numpy() for x in schur.error_bound(*args))
    js, jc = schur_products_pallas(jnp.asarray(w_hinv), jnp.asarray(w_cp),
                                   jnp.asarray(b_p), interpret=True)
    ref_s = jnp.einsum("ftik,gtjk->fgij", w_hinv, w_cp)
    ref_c = jnp.einsum("ftik,tk->fi", w_hinv, b_p)
    for ref in (js, ref_s):
        _within_bound(s.numpy(), ref, sb)
    for ref in (jc, ref_c):
        _within_bound(c.numpy(), ref, cb)
    # the wrapper takes the plain version for CPU tensors
    s2, c2 = schur.schur_products(*args)
    assert torch.equal(s2, s) and torch.equal(c2, c)
    assert s.shape == (f, f, 6, 6) and c.shape == (f, 6)


def test_schur_wrapper_checks_shapes():
    w_hinv, w_cp, b_p = (torch.tensor(x) for x in _schur_inputs(3, 10, 0))
    with pytest.raises(ValueError, match="pair"):
        schur.schur_products(w_hinv, w_cp[:, :9], b_p)


@pytest.fixture(scope="module")
def problem():
    state, prob, *_ = make_problem()
    return state, prob


def _port(problem):
    state, prob = problem
    return (state_from_jax(state, device="cpu"),
            state_from_jax(prob, device="cpu"))


def test_residuals_and_jacobians_match_jax(problem):
    st, pr = _port(problem)
    got = ba.residuals_and_jacobians(st, pr)
    ref = jba.residuals_and_jacobians(*problem)
    for g, r in zip(got[:3], ref[:3]):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=1e-4,
                                   atol=1e-3)
    np.testing.assert_allclose(float(got[3]), float(ref[3]), rtol=COST_RTOL)
    assert int(got[4]) == int(ref[4])


def test_schur_solve_matches_jax(problem):
    st, pr = _port(problem)
    f = st.rs.shape[0]
    fixed = np.ones(f, np.float32)
    fixed[0] = 0
    r, jc, jp, _, _ = jba.residuals_and_jacobians(*problem)
    ref_c, ref_p = jba.schur_solve(r, jc, jp, jnp.float32(1e-3),
                                   jnp.asarray(fixed))
    args = [torch.tensor(np.asarray(x)) for x in (r, jc, jp)]
    got_c, got_p = ba.schur_solve(*args, torch.tensor(1e-3),
                                  torch.tensor(fixed))
    np.testing.assert_allclose(got_c.numpy(), np.asarray(ref_c), rtol=1e-3,
                               atol=POSE_ATOL)
    np.testing.assert_allclose(got_p.numpy(), np.asarray(ref_p), rtol=1e-3,
                               atol=POSE_ATOL)
    assert np.abs(np.asarray(ref_c)).max() > 1e-3   # a real step
    assert not got_c[0].any()                        # gauge camera frozen


def _compare_ba(problem, **kw):
    st, pr = _port(problem)
    jkw = {k: (jnp.asarray(v.numpy()) if isinstance(v, torch.Tensor) else v)
           for k, v in kw.items()}
    got = ba.bundle_adjust(st, pr, **kw)
    ref = jba.bundle_adjust(*problem, **jkw)
    np.testing.assert_allclose(float(got.initial_cost),
                               float(ref.initial_cost), rtol=COST_RTOL)
    np.testing.assert_allclose(float(got.cost), float(ref.cost),
                               rtol=COST_RTOL)
    for name in ("rs", "ts"):
        np.testing.assert_allclose(getattr(got.state, name).numpy(),
                                   np.asarray(getattr(ref.state, name)),
                                   rtol=0, atol=POSE_ATOL, err_msg=name)
    # landmarks at depth 5-9 sit along the weak monocular-scale direction:
    # 1e-4 relative
    np.testing.assert_allclose(got.state.points.numpy(),
                               np.asarray(ref.state.points), rtol=1e-4,
                               atol=1e-4)
    assert float(got.cost) < float(got.initial_cost)
    return got


def test_bundle_adjust_matches_jax(problem):
    got = _compare_ba(problem, num_iterations=15)
    # plain=True is the same arithmetic on the CPU
    st, pr = _port(problem)
    again = ba.bundle_adjust(st, pr, num_iterations=15, plain=True)
    assert torch.equal(again.state.rs, got.state.rs)


def test_motion_only_bundle_adjust_matches_jax(problem):
    fixed = torch.zeros(problem[0].rs.shape[0])
    fixed[3] = 1.0
    got = _compare_ba(problem, num_iterations=10, fixed_cameras=fixed,
                      optimize_points=False)
    st, _ = _port(problem)
    assert torch.equal(got.state.points, st.points)
    keep = torch.arange(st.rs.shape[0]) != 3
    assert torch.equal(got.state.rs[keep], st.rs[keep])


def test_pose_prior_bundle_adjust_matches_jax(problem):
    _, _, rs_gt, ts_gt, *_ = make_problem()
    _compare_ba(problem, num_iterations=10, use_pose_prior=True,
                prior_rs=torch.tensor(rs_gt, dtype=torch.float32),
                prior_ts=torch.tensor(ts_gt, dtype=torch.float32),
                prior_weight=3.0)


# ------------------------------ the CUDA-graph cache, seen from the CPU


def test_bundle_adjust_on_the_cpu_never_captures(problem):
    """CPU tensors take the eager loop on every call: nothing is seen,
    captured or replayed, the new counters stay absent, and the result is
    the loop's own, the same bits on a repeated call."""
    from photogrammetry_tpu_torch.utils import profiling

    st, pr = _port(problem)
    seen, cached = dict(ba._CACHE.seen), dict(ba._CACHE.graphs)
    profiling.clear()
    with profiling.recording():
        got = [ba.bundle_adjust(st, pr, num_iterations=6) for _ in range(3)]
    counters = profiling.read_counters()
    profiling.clear()
    assert (ba._CACHE.seen, ba._CACHE.graphs) == (seen, cached)
    assert counters["ba.lm_iterations"] == 18
    assert not {"ba.graph_replays", "ba.graph_captures",
                "ba.eager_solves"} & set(counters)
    ref, cost, cost0, accepted = ba._lm_loop(
        st, pr, None, None, None, num_iterations=6, huber_delta=3.0,
        init_lambda=1e-3, optimize_points=True, use_pose_prior=False,
        prior_weight=0.0, plain=False, tally=True)
    assert counters["ba.lm_accepted"] == 3 * int(accepted) > 0
    for res in got:
        assert all(torch.equal(a, b) for a, b in zip(res.state, ref))
        assert torch.equal(res.cost, cost)
        assert torch.equal(res.initial_cost, cost0)
        assert res.iterations == 6


def _small_problem(f=4, t=60, device="cpu", dtype=torch.float32):
    z = torch.zeros((), dtype=dtype, device=device)
    state = ba.BAState(rs=z.new_zeros(f, 3, 3), ts=z.new_zeros(f, 3),
                       points=z.new_zeros(t, 3))
    prob = ba.BAProblem(obs=z.new_zeros(f, t, 2),
                        mask=torch.zeros(f, t, dtype=torch.bool,
                                         device=device),
                        k=z.new_zeros(3, 3))
    return state, prob


def _key(monkeypatch, state, prob, **kw):
    """The cache key that ``bundle_adjust(state, prob, **kw)`` computes
    (the solve itself stubbed out)."""
    keys = []

    def solve(args, opts):
        keys.append(graphs.loop_key(args, opts))
        return args[0], args[1].k[0, 0], args[1].k[0, 0]

    monkeypatch.setattr(ba, "_solve", solve)
    ba.bundle_adjust(state, prob, **kw)
    return keys[0]


_BASE = dict(num_iterations=20, fixed_cameras=torch.ones(4))
_CHANGES = {
    "device": ({}, dict(device="meta")),
    "dtype": ({}, dict(dtype=torch.float64)),
    "frames": ({}, dict(f=5)),
    "tracks": ({}, dict(t=61)),
    "num_iterations": (dict(num_iterations=21), {}),
    "huber_delta": (dict(huber_delta=2.0), {}),
    "init_lambda": (dict(init_lambda=1e-2), {}),
    "optimize_points": (dict(optimize_points=False), {}),
    "use_pose_prior": (dict(use_pose_prior=True), {}),
    "prior_weight": (dict(prior_weight=1.0), {}),
    "plain": (dict(plain=True), {}),
    "fixed_cameras": (dict(fixed_cameras=None), {}),
    "prior_rs": (dict(prior_rs=torch.zeros(4, 3, 3)), {}),
    "prior_ts": (dict(prior_ts=torch.zeros(4, 3)), {}),
}


@pytest.mark.parametrize("name", sorted(_CHANGES))
def test_graph_key_separates_what_the_capture_bakes_in(monkeypatch, name):
    """Each argument that the captured loop bakes in, changed alone, gives
    another key; the same call gives the same key, and a number given as
    an int the same key as the float it is."""
    kw, shape = _CHANGES[name]
    base = _key(monkeypatch, *_small_problem(), **_BASE)
    assert _key(monkeypatch, *_small_problem(), **_BASE) == base
    assert _key(monkeypatch, *_small_problem(), **_BASE,
                huber_delta=3) == base
    changed = dict(_BASE, **kw)
    if "f" in shape:
        changed["fixed_cameras"] = torch.ones(shape["f"])
    if "device" in shape:
        changed["fixed_cameras"] = torch.ones(4, device="meta")
    if "dtype" in shape:
        changed["fixed_cameras"] = torch.ones(4, dtype=torch.float64)
    assert _key(monkeypatch, *_small_problem(**shape), **changed) != base
