"""Port parity: the SE(3) and Sim(3) pose-graph optimisers.

The graphs are built by tests/test_pose_graph.py's own helpers in JAX and
carried across with ``convert.state_from_jax``.  Tolerances: residuals and
Jacobians (forward-mode autodiff in both packages) within 1e-5 abs; the
optimised poses within 1e-4 abs and the costs within 1e-4 relative (1e-7
abs near zero), f32 LM runs of 5-30 iterations; and the JAX tests' own
assertions (cost reduction, ATE against drift, gauge, scale recovery)
repeated on the port.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_threads import _one_thread  # noqa: F401
from photogrammetry_tpu.sfm import loop_closure as jlc
from photogrammetry_tpu.sfm import pose_graph as jpg
from photogrammetry_tpu_torch.convert import state_from_jax
from photogrammetry_tpu_torch.sfm import loop_closure as lc
from photogrammetry_tpu_torch.sfm import pose_graph as pg
from photogrammetry_tpu_torch.sfm.metrics import absolute_trajectory_error
from test_pose_graph import build_graph, centers, circle_trajectory

JAC_TOL = dict(rtol=0, atol=1e-5)
# JAX's per-edge terms, compiled once (un-jitted they dispatch op by op)
JAX_SE3_TERMS = jax.jit(jpg._edge_terms)
JAX_SIM3_TERMS = jax.jit(jpg._sim3_edge_terms)
POSE_TOL = dict(rtol=0, atol=1e-4)


def _t(x):
    return torch.tensor(np.asarray(x))


def _ate(rs, ts, gt):
    return float(absolute_trajectory_error(
        torch.tensor(centers(rs, ts), dtype=torch.float64),
        torch.tensor(gt, dtype=torch.float64)))


def _drifted_chain(g, rs_gt, ts_gt):
    """Integrate the noisy odometry chain (classic drifted odometry)."""
    rs0, ts0 = [rs_gt[0]], [ts_gt[0]]
    for e in range(len(rs_gt) - 1):
        zr, zt = np.asarray(g.z_rs[e]), np.asarray(g.z_ts[e])
        rs0.append(zr @ rs0[-1])
        ts0.append(zr @ ts0[-1] + zt)
    return (np.stack(rs0).astype(np.float32),
            np.stack(ts0).astype(np.float32))


def _sim3_drift_problem(n=40, gamma=1.015):
    """tests/test_pose_graph.py::test_sim3_recovers_scale_drift's circle
    with compounding scale drift and one revisit edge of measured scale."""
    theta = np.linspace(0.0, 2 * np.pi, n)
    centers_gt = np.stack([2 * np.cos(theta), 2 * np.sin(theta),
                           np.zeros(n)], -1).astype(np.float32)
    rs_gt = np.zeros((n, 3, 3), np.float32)
    for t in range(n):
        c, s = np.cos(theta[t]), np.sin(theta[t])
        rs_gt[t] = np.array([[c, s, 0], [-s, c, 0], [0, 0, 1]], np.float32)
    steps = np.diff(centers_gt, axis=0)
    drift = steps * (gamma ** np.arange(1, n))[:, None]
    centers_d = np.concatenate([centers_gt[:1],
                                centers_gt[0] + np.cumsum(drift, 0)])
    ts_d = np.einsum("nij,nj->ni", rs_gt, -centers_d).astype(np.float32)
    rs, ts = jnp.asarray(rs_gt), jnp.asarray(ts_d)
    edges = [(t, t + 1) for t in range(n - 1)] + [(0, n - 1)]
    zr, zt, zs, w = [], [], [], []
    for i, j in edges[:-1]:
        r, t = jpg.relative_pose(rs[i], ts[i], rs[j], ts[j])
        zr.append(r), zt.append(t), zs.append(1.0), w.append(1.0)
    zr.append(jnp.asarray(rs_gt[n - 1] @ rs_gt[0].T))
    zt.append(jnp.zeros(3)), zs.append(float(gamma ** (n - 1)))
    w.append(50.0)
    g3 = jpg.PoseGraph(edges=jnp.asarray(edges, jnp.int32),
                       z_rs=jnp.stack(zr), z_ts=jnp.stack(zt),
                       weights=jnp.asarray(w, jnp.float32))
    g7 = jpg.PoseGraphSim3(edges=g3.edges, z_rs=g3.z_rs, z_ts=g3.z_ts,
                           z_ss=jnp.asarray(zs, jnp.float32),
                           weights=g3.weights)
    return rs_gt, ts_d, centers_gt, g3, g7


@pytest.mark.parametrize("noise", [0.0, 0.05, 0.3])
def test_se3_residuals_and_jacobians_match_jax(noise):
    rs, ts = circle_trajectory(n=12)
    g = build_graph(rs, ts, noise=noise, seed=2)
    ref = JAX_SE3_TERMS(jnp.asarray(rs), jnp.asarray(ts), g)
    got = pg._edge_terms(_t(rs), _t(ts), state_from_jax(g, device="cpu"))
    for a, b in zip(got, ref):
        assert a.dtype == torch.float32 and torch.isfinite(a).all()
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **JAC_TOL)


@pytest.mark.parametrize("noise", [0.0, 0.05])
def test_sim3_residuals_and_jacobians_match_jax(noise):
    rs, ts = circle_trajectory(n=10)
    g = build_graph(rs, ts, noise=noise, seed=5)
    zs = np.random.default_rng(5).uniform(0.8, 1.25, len(g.edges))
    g7 = jpg.PoseGraphSim3(edges=g.edges, z_rs=g.z_rs, z_ts=g.z_ts,
                           z_ss=jnp.asarray(zs, jnp.float32),
                           weights=g.weights)
    gs = np.random.default_rng(6).normal(0, 0.2, 10).astype(np.float32)
    ref = JAX_SIM3_TERMS(jnp.asarray(rs), jnp.asarray(ts), jnp.asarray(gs),
                         g7)
    got = pg._sim3_edge_terms(_t(rs), _t(ts), _t(gs),
                              state_from_jax(g7, device="cpu"))
    for a, b in zip(got, ref):
        assert a.shape == b.shape and torch.isfinite(a).all()
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **JAC_TOL)


def test_residual_zero_at_ground_truth():
    rs, ts = circle_trajectory()
    g = state_from_jax(build_graph(rs, ts, noise=0.0), device="cpu")
    ii, jj = g.edges[:, 0].long(), g.edges[:, 1].long()
    r = pg._edge_residual(_t(rs)[ii], _t(ts)[ii], _t(rs)[jj], _t(ts)[jj],
                          g.z_rs, g.z_ts)
    assert float(r.abs().max()) < 1e-5


def test_pose_graph_closes_loop_like_jax():
    rs_gt, ts_gt = circle_trajectory(n=20)
    g = build_graph(rs_gt, ts_gt, noise=0.05)
    rs0, ts0 = _drifted_chain(g, rs_gt, ts_gt)
    ref = jpg.optimize_pose_graph(jnp.asarray(rs0), jnp.asarray(ts0), g,
                                  num_iterations=25)
    got = pg.optimize_pose_graph(_t(rs0), _t(ts0),
                                 state_from_jax(g, device="cpu"),
                                 num_iterations=25)
    np.testing.assert_allclose(got.rs.numpy(), np.asarray(ref.rs), **POSE_TOL)
    np.testing.assert_allclose(got.ts.numpy(), np.asarray(ref.ts), **POSE_TOL)
    np.testing.assert_allclose(float(got.cost), float(ref.cost), rtol=1e-4)
    np.testing.assert_allclose(float(got.initial_cost),
                               float(ref.initial_cost), rtol=1e-4)
    # tests/test_pose_graph.py::test_pose_graph_closes_loop on the port
    gt = centers(rs_gt, ts_gt)
    assert float(got.cost) < 0.1 * float(got.initial_cost)
    assert _ate(got.rs, got.ts, gt) < 0.5 * _ate(rs0, ts0, gt)


def test_gauge_node_fixed_and_perfect_graph_stays_put():
    rs_gt, ts_gt = circle_trajectory(n=6)
    g = build_graph(rs_gt, ts_gt, noise=0.05)
    ref = jpg.optimize_pose_graph(jnp.asarray(rs_gt), jnp.asarray(ts_gt), g,
                                  num_iterations=5)
    got = pg.optimize_pose_graph(_t(rs_gt), _t(ts_gt),
                                 state_from_jax(g, device="cpu"),
                                 num_iterations=5)
    np.testing.assert_allclose(got.rs[0].numpy(), rs_gt[0], atol=1e-6)
    np.testing.assert_allclose(got.ts[0].numpy(), ts_gt[0], atol=1e-6)
    np.testing.assert_allclose(got.ts.numpy(), np.asarray(ref.ts), **POSE_TOL)
    rs_gt, ts_gt = circle_trajectory(n=8)
    g = state_from_jax(build_graph(rs_gt, ts_gt, noise=0.0), device="cpu")
    res = pg.optimize_pose_graph(_t(rs_gt), _t(ts_gt), g, num_iterations=5)
    assert float(res.cost) < 1e-8
    np.testing.assert_allclose(res.rs.numpy(), rs_gt, atol=1e-4)


def test_fixed_nodes_freeze_more_than_the_gauge():
    rs_gt, ts_gt = circle_trajectory(n=8)
    g = build_graph(rs_gt, ts_gt, noise=0.05, seed=3)
    fixed = np.ones(8, np.float32)
    fixed[[0, 4]] = 0.0
    ref = jpg.optimize_pose_graph(jnp.asarray(rs_gt), jnp.asarray(ts_gt), g,
                                  num_iterations=8,
                                  fixed_nodes=jnp.asarray(fixed))
    got = pg.optimize_pose_graph(_t(rs_gt), _t(ts_gt),
                                 state_from_jax(g, device="cpu"),
                                 num_iterations=8, fixed_nodes=_t(fixed))
    np.testing.assert_array_equal(got.rs[4].numpy(), rs_gt[4])
    np.testing.assert_allclose(got.rs.numpy(), np.asarray(ref.rs), **POSE_TOL)
    np.testing.assert_allclose(got.ts.numpy(), np.asarray(ref.ts), **POSE_TOL)


def test_sim3_recovers_scale_drift_like_jax():
    rs, ts, gt, g3, g7 = _sim3_drift_problem()
    ref3 = jpg.optimize_pose_graph(jnp.asarray(rs), jnp.asarray(ts), g3,
                                   num_iterations=30)
    ref7 = jpg.optimize_pose_graph_sim3(jnp.asarray(rs), jnp.asarray(ts), g7,
                                        num_iterations=30)
    got3 = pg.optimize_pose_graph(_t(rs), _t(ts),
                                  state_from_jax(g3, device="cpu"),
                                  num_iterations=30)
    got7 = pg.optimize_pose_graph_sim3(_t(rs), _t(ts),
                                       state_from_jax(g7, device="cpu"),
                                       num_iterations=30)
    for got, ref in ((got3, ref3), (got7, ref7)):
        np.testing.assert_allclose(got.rs.numpy(), np.asarray(ref.rs),
                                   **POSE_TOL)
        np.testing.assert_allclose(got.ts.numpy(), np.asarray(ref.ts),
                                   **POSE_TOL)
        np.testing.assert_allclose(float(got.cost), float(ref.cost),
                                   rtol=1e-4, atol=1e-7)
    np.testing.assert_allclose(got7.scales.numpy(), np.asarray(ref7.scales),
                               rtol=1e-4)
    # the JAX test's assertions on the port
    ate_drift = _ate(rs, ts, gt)
    ate_se3 = _ate(got3.rs, got3.ts, gt)
    ate_sim3 = _ate(got7.rs, got7.ts, gt)
    assert ate_sim3 < 0.02 * ate_drift, (ate_drift, ate_se3, ate_sim3)
    assert ate_sim3 < 0.1 * ate_se3, (ate_drift, ate_se3, ate_sim3)
    np.testing.assert_allclose(float(got7.scales[-1]), 1.015 ** 39,
                               rtol=0.05)


def test_build_pose_graph_matches_jax():
    rng = np.random.default_rng(0)
    rs, ts = circle_trajectory(n=5)
    ts = ts + rng.normal(0, 0.1, ts.shape).astype(np.float32)
    zr, zt = jpg.relative_pose(jnp.asarray(rs[0]), jnp.asarray(ts[0]),
                               jnp.asarray(rs[3]), jnp.asarray(ts[3]))
    ref = jlc.build_pose_graph(rs, ts, [(0, 3)], [(zr, zt)], loop_weight=2.0)
    got = lc.build_pose_graph(rs, ts, [(0, 3)],
                              [(np.asarray(zr), np.asarray(zt))],
                              loop_weight=2.0, device="cpu")
    assert got.edges.shape == (5, 2) and float(got.weights[-1]) == 2.0
    for a, b in zip(got, ref):
        assert a.dtype == torch.from_numpy(np.asarray(b).copy()).dtype
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0,
                                   atol=1e-6)
    # odometry edges reproduce the trajectory exactly (zero residual)
    res = pg.optimize_pose_graph(_t(rs), _t(ts), got, num_iterations=3)
    assert float(res.initial_cost) < 1e-8


def test_state_from_jax_carries_graphs():
    rs, ts, _, g3, g7 = _sim3_drift_problem(n=6)
    for g, cls in ((g3, pg.PoseGraph), (g7, pg.PoseGraphSim3)):
        got = state_from_jax(g, device="cpu")
        assert isinstance(got, cls)
        for a, b in zip(got, g):
            assert a.dtype == torch.from_numpy(np.asarray(b).copy()).dtype
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))


# ------------------------------ the CUDA-graph caches, seen from the CPU


class _Stop(Exception):
    pass


def _key(monkeypatch, sim3=False, n=6, e=7, device="cpu",
         dtype=torch.float32, edge_dtype=torch.int32, strided=False, **kw):
    """(cache, key) of the solve that ``optimize_pose_graph`` (``_sim3``)
    asks for on zero graphs of ``n`` nodes and ``e`` edges (the solve
    itself stubbed out); ``strided`` hands ``ts`` over transposed."""
    from photogrammetry_tpu_torch.utils import graphs

    keys = []

    def solve(cache, args, opts):
        keys.append((cache, graphs.loop_key(args, opts)))
        raise _Stop

    monkeypatch.setattr(graphs.LoopCache, "solve", solve)
    z = torch.zeros((), dtype=dtype, device=device)
    rs = z.new_zeros(n, 3, 3)
    ts = z.new_zeros(3, n).T if strided else z.new_zeros(n, 3)
    common = dict(edges=torch.zeros(e, 2, dtype=edge_dtype, device=device),
                  z_rs=z.new_zeros(e, 3, 3), z_ts=z.new_zeros(e, 3),
                  weights=z.new_ones(e))
    with pytest.raises(_Stop):
        if sim3:
            pg.optimize_pose_graph_sim3(
                rs, ts, pg.PoseGraphSim3(z_ss=z.new_ones(e), **common), **kw)
        else:
            pg.optimize_pose_graph(rs, ts, pg.PoseGraph(**common), **kw)
    return keys[0]


_PG_CHANGES = {
    "device": dict(device="meta"),
    "dtype": dict(dtype=torch.float64),
    "nodes": dict(n=7),
    "edges": dict(e=8),
    "edge_dtype": dict(edge_dtype=torch.int64),
    "strides": dict(strided=True),
    "num_iterations": dict(num_iterations=21),
    "init_lambda": dict(init_lambda=1e-3),
}


@pytest.mark.parametrize("sim3", [False, True])
@pytest.mark.parametrize("name", sorted(_PG_CHANGES))
def test_pose_graph_key_separates_what_the_capture_bakes_in(monkeypatch,
                                                           name, sim3):
    """Each input layout and option that the captured loop bakes in,
    changed alone, gives another key; the same call gives the same key,
    and so does the free-node mask given as the default it is (its values
    are copied in, not baked in).  SE(3) and Sim(3) keep separate caches."""
    base = _key(monkeypatch, sim3, num_iterations=20)
    cache = base[0]
    assert cache is (pg._SIM3_GRAPHS if sim3 else pg._SE3_GRAPHS)
    assert _key(monkeypatch, sim3, num_iterations=20) == base
    mask = torch.ones(6)
    mask[0] = 0.0
    assert _key(monkeypatch, sim3, num_iterations=20,
                fixed_nodes=mask) == base
    changed = dict(dict(num_iterations=20), **_PG_CHANGES[name])
    got = _key(monkeypatch, sim3, **changed)
    assert got[0] is cache and got[1] != base[1]


def _loop_problem(sim3):
    """The Sim(3) drift circle at 12 nodes (its SE(3) or Sim(3) graph) as
    the port's tensors: (rs, ts, graph)."""
    rs, ts, _, g3, g7 = _sim3_drift_problem(n=12)
    return _t(rs), _t(ts), state_from_jax(g7 if sim3 else g3, device="cpu")


@pytest.mark.parametrize("sim3", [False, True])
def test_pose_graph_on_the_cpu_never_captures(sim3):
    """CPU tensors take the eager loop on every call: nothing is seen,
    captured or replayed, the graph counters stay absent, and the result
    is the loop's own, the same bits on a repeated call."""
    from photogrammetry_tpu_torch.utils import profiling

    rs, ts, graph = _loop_problem(sim3)
    cache = pg._SIM3_GRAPHS if sim3 else pg._SE3_GRAPHS
    optimize = pg.optimize_pose_graph_sim3 if sim3 else pg.optimize_pose_graph
    seen, cached = dict(cache.seen), dict(cache.graphs)
    profiling.clear()
    with profiling.recording():
        got = [optimize(rs, ts, graph, num_iterations=6) for _ in range(3)]
    counters = profiling.read_counters()
    profiling.clear()
    assert (cache.seen, cache.graphs) == (seen, cached)
    assert counters["pose_graph.lm_iterations"] == 18
    assert not {"pose_graph.graph_replays", "pose_graph.graph_captures",
                "pose_graph.eager_solves"} & set(counters)
    fn = pg._fixed(12, None, ts)
    state = (rs, ts, ts.new_zeros(12)) if sim3 else (rs, ts)
    ref, cost, cost0, accepted = cache.loop(
        *state, graph, fn, num_iterations=6, init_lambda=1e-4, tally=True)
    assert counters["pose_graph.lm_accepted"] == 3 * int(accepted) > 0
    for res in got:
        assert torch.equal(res.rs, ref[0])
        if sim3:
            assert torch.equal(res.scales, torch.exp(ref[2]))
            assert torch.equal(res.ts, ref[1] / res.scales[:, None])
        else:
            assert torch.equal(res.ts, ref[1])
        assert torch.equal(res.cost, cost)
        assert torch.equal(res.initial_cost, cost0)


def _closure_form(rs, ts, graph, sim3, num_iterations, fixed_nodes):
    """The LM as ``optimize_pose_graph`` (``_sim3``) ran it before its loop
    became a function of tensors: closures over the graph, the loop
    written out.  (rs, ts, scales or None, cost, initial cost, accepted)."""
    n = rs.shape[0]
    fn = pg._fixed(n, fixed_nodes, ts)
    ii = graph.edges[:, 0].long()
    jj = graph.edges[:, 1].long()
    w = graph.weights
    dim = 7 if sim3 else 6

    def cost_of(state):
        if sim3:
            rs, ts, gs = state
            r = pg._sim3_edge_residual(rs[ii], ts[ii], gs[ii], rs[jj],
                                       ts[jj], gs[jj], graph.z_rs,
                                       graph.z_ts, graph.z_ss)
        else:
            rs, ts = state
            r = pg._edge_residual(rs[ii], ts[ii], rs[jj], ts[jj], graph.z_rs,
                                  graph.z_ts)
        return 0.5 * (w[:, None] * r * r).sum()

    def step(state, lam):
        terms = (pg._sim3_edge_terms(*state, graph) if sim3
                 else pg._edge_terms(*state, graph))
        delta = pg._lm_step(*terms, ii, jj, w, fn, lam, dim)
        dr, dt = pg.se3_exp(delta[:, :6])
        out = (dr @ state[0], pg._mv(dr, state[1]) + dt)
        return out + (state[2] + delta[:, 6],) if sim3 else out

    state = (rs, ts, ts.new_zeros(n)) if sim3 else (rs, ts)
    cost0 = cost_of(state)
    cost = cost0
    lam = torch.full_like(cost0, 1e-4)
    accepted = 0
    for _ in range(num_iterations):
        prop = step(state, lam)
        new_cost = cost_of(prop)
        accept = new_cost < cost
        accepted += int(accept)
        state = tuple(torch.where(accept, p, s) for p, s in zip(prop, state))
        cost = torch.where(accept, new_cost, cost)
        lam = torch.where(accept, torch.clamp(lam * 0.5, min=1e-10),
                          torch.clamp(lam * 4.0, max=1e8))
    if not sim3:
        return state[0], state[1], None, cost, cost0, accepted
    scales = torch.exp(state[2])
    return (state[0], state[1] / scales[:, None], scales, cost, cost0,
            accepted)


@pytest.mark.parametrize("fixed", [False, True])
@pytest.mark.parametrize("sim3", [False, True])
def test_pose_graph_same_bits_as_the_closure_form(sim3, fixed):
    """``optimize_pose_graph`` / ``_sim3`` on the CPU give the bits of the
    loop as it was written before it became a function of tensors, and
    count the same accepted steps and iterations."""
    from photogrammetry_tpu_torch.utils import profiling

    rs, ts, graph = _loop_problem(sim3)
    fixed_nodes = None
    if fixed:
        fixed_nodes = torch.ones(12)
        fixed_nodes[[0, 5]] = 0.0
    want = _closure_form(rs, ts, graph, sim3, 15, fixed_nodes)
    optimize = pg.optimize_pose_graph_sim3 if sim3 else pg.optimize_pose_graph
    profiling.clear()
    with profiling.recording():
        got = optimize(rs, ts, graph, num_iterations=15,
                       fixed_nodes=fixed_nodes)
    counters = profiling.read_counters()
    profiling.clear()
    assert torch.equal(got.rs, want[0]) and torch.equal(got.ts, want[1])
    if sim3:
        assert torch.equal(got.scales, want[2])
    assert torch.equal(got.cost, want[3])
    assert torch.equal(got.initial_cost, want[4])
    assert counters == {"pose_graph.lm_accepted": want[5],
                        "pose_graph.lm_iterations": 15}
    assert 0 < want[5] < 15
