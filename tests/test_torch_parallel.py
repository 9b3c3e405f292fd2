"""Port parity: the distributed layer (``parallel/``) on gloo worlds.

The port's ranks run in spawned processes (``_torch_dist_ranks``: torch
and the port only); the JAX references run here on the conftest's
virtual 8-device CPU mesh.  Tolerances, as tests/test_distributed.py
holds JAX's sharded BA to its single-device one: costs within 1e-4
relative, poses within 1e-3 absolute (f32 all-reduces and psums sum in
other orders, and 15 LM iterations carry that on).  Every rank's result
is bit-identical to rank 0's.  The pose graphs: dense and CG against
JAX's on a 4-device mesh within the same tolerances; padded edges inert
and CG against dense as tests/test_dist_pose_graph.py holds JAX's.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_dist_ranks import (
    ba_rank, initialize_rank, pod_mesh_rank, pose_graph_rank,
)
from _torch_threads import _one_thread  # noqa: F401
from photogrammetry_tpu.parallel.dist_ba import (
    distributed_bundle_adjust as jax_dist_ba,
)
from photogrammetry_tpu.parallel.dist_pose_graph import (
    distributed_optimize_pose_graph as jax_dist_pg, pad_graph as jax_pad,
)
from photogrammetry_tpu.parallel.mesh import make_mesh as jax_mesh
from photogrammetry_tpu_torch.parallel.mesh import free_port
from photogrammetry_tpu_torch.parallel.multihost import (
    initialize, run_world,
)
from photogrammetry_tpu_torch.sfm.ba import BAProblem, BAState, bundle_adjust
from test_ba import make_problem
from test_distributed import pad_tracks
from test_pose_graph import build_graph, circle_trajectory

COST_RTOL = 1e-4
POSE_TOL = dict(rtol=0, atol=1e-3)
ITERATIONS = 15
WORLD_TIMEOUT = 240.0
JAX_MESH_DEVICES = 4
# JAX's edge-sharded LM, compiled once per configuration (eager it
# dispatches op by op: ~100 s a call)
JAX_PG = jax.jit(jax_dist_pg, static_argnames=(
    "mesh", "num_iterations", "solver", "cg_iterations"))


@pytest.fixture(scope="module")
def ba_problem():
    """tests/test_ba.py's problem, its 137 landmarks padded to 140 (a
    multiple of 2 and 4), as numpy."""
    state, prob, *_ = make_problem()
    state, prob = pad_tracks(state, prob, 4)
    return tuple(np.asarray(x) for x in (state.rs, state.ts, state.points,
                                         prob.obs, prob.mask, prob.k))


@pytest.fixture(scope="module")
def ba_worlds(ba_problem):
    """The port's sharded BA on gloo worlds of 2 and 4: each rank's
    results."""
    return {n: run_world(ba_rank, n, (ba_problem, ITERATIONS),
                         timeout=WORLD_TIMEOUT, threads=1)
            for n in (2, 4)}


@pytest.fixture(scope="module")
def ba_jax(ba_problem):
    """JAX's distributed_bundle_adjust on a 4-device virtual mesh."""
    rs, ts, points, obs, mask, k = (jnp.asarray(x) for x in ba_problem)
    from photogrammetry_tpu.sfm.ba import BAProblem as JP, BAState as JS

    res = jax_dist_ba(JS(rs=rs, ts=ts, points=points),
                      JP(obs=obs, mask=mask, k=k),
                      jax_mesh(devices=jax.devices()[:JAX_MESH_DEVICES]),
                      num_iterations=ITERATIONS)
    return dict(rs=np.asarray(res.state.rs), ts=np.asarray(res.state.ts),
                cost=float(res.cost), initial_cost=float(res.initial_cost))


@pytest.fixture(scope="module")
def ba_single(ba_problem):
    """The port's single-process bundle_adjust (plain Schur products)."""
    rs, ts, points, obs, mask, k = (torch.tensor(x) for x in ba_problem)
    res = bundle_adjust(BAState(rs=rs, ts=ts, points=points),
                        BAProblem(obs=obs, mask=mask, k=k),
                        num_iterations=ITERATIONS, plain=True)
    return dict(rs=res.state.rs.numpy(), ts=res.state.ts.numpy(),
                cost=float(res.cost), initial_cost=float(res.initial_cost))


def _assert_close(got, ref):
    assert float(got["cost"]) == pytest.approx(ref["cost"], rel=COST_RTOL)
    assert float(got["initial_cost"]) == pytest.approx(ref["initial_cost"],
                                                       rel=COST_RTOL)
    np.testing.assert_allclose(got["rs"], ref["rs"], **POSE_TOL)
    np.testing.assert_allclose(got["ts"], ref["ts"], **POSE_TOL)


@pytest.mark.parametrize("world", [2, 4])
def test_distributed_ba_matches_jax_distributed(ba_worlds, ba_jax, world):
    got = ba_worlds[world][0]["global"]
    _assert_close(got, ba_jax)
    assert float(got["cost"]) < 0.1 * float(got["initial_cost"])


@pytest.mark.parametrize("world", [2, 4])
def test_distributed_ba_matches_single_process(ba_worlds, ba_single, world):
    _assert_close(ba_worlds[world][0]["global"], ba_single)


@pytest.mark.parametrize("world", [2, 4])
def test_distributed_ba_ranks_bit_identical(ba_worlds, world):
    ranks = ba_worlds[world]
    assert len(ranks) == world
    for out in ranks[1:]:
        for key in ("global", "sharded"):
            for name, val in ranks[0][key].items():
                np.testing.assert_array_equal(out[key][name], val,
                                              err_msg=f"{key} {name}")


@pytest.mark.parametrize("world", [2, 4])
def test_shard_problem_input_equals_global_input(ba_worlds, ba_problem,
                                                 world):
    out = ba_worlds[world][0]
    for name, val in out["global"].items():
        np.testing.assert_array_equal(out["sharded"][name], val,
                                      err_msg=name)
    assert out["global"]["points"].shape == ba_problem[2].shape


@pytest.mark.parametrize("world", [2, 4])
def test_distributed_ba_refuses_uneven_landmarks(ba_worlds, world):
    msg = ba_worlds[world][0]["refused"]
    assert msg is not None and "139 landmarks" in msg


def _graph_np(g):
    return (np.asarray(g.edges, np.int32), np.asarray(g.z_rs, np.float32),
            np.asarray(g.z_ts, np.float32), np.asarray(g.weights, np.float32))


# (nodes, noise, LM iterations, solver, CG iterations): the JAX tests'
# graphs (tests/test_dist_pose_graph.py)
PG_CASES = {"dense14": (14, 0.05, 15, "dense", 100),
            "cg14": (14, 0.05, 15, "cg", 120),
            "cg256": (256, 0.04, 10, "cg", 60)}


@pytest.fixture(scope="module")
def pose_graphs():
    """Each case's circle trajectory and noisy graph (JAX's builders), the
    JAX result on a 4-device mesh and the port's on a gloo world of 4;
    the dense case once more with the edges padded a second time (to 32)
    and at solver 'auto'."""
    mesh = jax_mesh(devices=jax.devices()[:JAX_MESH_DEVICES])
    cases, ref = [], {}
    for name, (n, noise, iters, solver, cg_iters) in PG_CASES.items():
        rs, ts = circle_trajectory(n=n)
        g = build_graph(rs, ts, noise=noise)
        kwargs = dict(num_iterations=iters, solver=solver,
                      cg_iterations=cg_iters)
        res = JAX_PG(jnp.asarray(rs), jnp.asarray(ts),
                     jax_pad(g, JAX_MESH_DEVICES), mesh=mesh, **kwargs)
        ref[name] = dict(rs=np.asarray(res.rs), ts=np.asarray(res.ts),
                         cost=float(res.cost),
                         initial_cost=float(res.initial_cost))
        cases.append((np.asarray(rs, np.float32), np.asarray(ts, np.float32),
                      _graph_np(g), (JAX_MESH_DEVICES,), kwargs))
    dense = cases[0]
    cases.append(dense[:3] + ((JAX_MESH_DEVICES, 32), dense[4]))
    cases.append(dense[:4] + ({**dense[4], "solver": "auto"},))
    got = run_world(pose_graph_rank, JAX_MESH_DEVICES, (cases,),
                    timeout=WORLD_TIMEOUT, threads=1)
    return ref, got


@pytest.mark.parametrize("case", list(PG_CASES))
def test_distributed_pose_graph_matches_jax(pose_graphs, case):
    ref, got = pose_graphs
    _assert_close(got[0][list(PG_CASES).index(case)], ref[case])


def test_distributed_pose_graph_ranks_bit_identical(pose_graphs):
    _, got = pose_graphs
    for out in got[1:]:
        for a, b in zip(got[0], out):
            for name, val in a.items():
                np.testing.assert_array_equal(b[name], val, err_msg=name)


def test_padded_edges_are_inert(pose_graphs):
    _, got = pose_graphs
    once, twice = got[0][0], got[0][3]
    assert (once["edges"], twice["edges"]) == (16, 32)
    assert float(twice["cost"]) == pytest.approx(float(once["cost"]),
                                                 rel=1e-4)


def test_cg_matches_dense_and_auto_is_dense_at_14(pose_graphs):
    _, got = pose_graphs
    dense, cg, auto = got[0][0], got[0][1], got[0][4]
    assert float(cg["cost"]) == pytest.approx(float(dense["cost"]), rel=5e-3)
    np.testing.assert_allclose(cg["rs"], dense["rs"], rtol=0, atol=5e-3)
    for name, val in dense.items():
        np.testing.assert_array_equal(auto[name], val, err_msg=name)


def test_cg_scales_to_256_nodes(pose_graphs):
    _, got = pose_graphs
    res = got[0][2]
    assert res["rs"].shape == (256, 3, 3)
    assert float(res["cost"]) < 0.05 * float(res["initial_cost"])


def test_pod_mesh_two_hosts_of_two_ranks(monkeypatch):
    monkeypatch.setenv("LOCAL_WORLD_SIZE", "2")     # the ranks inherit it
    got = run_world(pod_mesh_rank, 4, timeout=WORLD_TIMEOUT, threads=1)
    assert {(shape, names) for shape, names, _ in got} == \
        {((2, 2), ("submaps", "tracks"))}
    assert [coord for _, _, coord in got] == [(0, 0), (0, 1), (1, 0),
                                              (1, 1)]


def test_initialize_joins_a_world_at_an_address():
    import torch.multiprocessing as mp

    address = f"127.0.0.1:{free_port()}"
    ctx = mp.start_processes(initialize_rank, args=(address, 2), nprocs=2,
                             join=False, start_method="spawn")
    deadline = WORLD_TIMEOUT / 0.5
    while not ctx.join(timeout=0.5):
        deadline -= 1
        assert deadline > 0, "initialize: the world did not finish"


def test_initialize_does_nothing_for_a_single_process(monkeypatch):
    import torch.distributed as dist

    monkeypatch.delenv("PHOTOGRAMMETRY_COORDINATOR", raising=False)
    initialize()
    assert not dist.is_initialized()
