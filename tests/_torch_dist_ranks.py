"""Rank functions of the port's distributed tests.

``parallel.multihost.run_world`` runs them in spawned processes, which
import this module by name: it imports torch, numpy and the port only (no
JAX, no test module).  Inputs and results pass as numpy arrays.
"""
import torch


def _ba_result(res) -> dict:
    return dict(rs=res.state.rs.numpy(), ts=res.state.ts.numpy(),
                points=res.state.points.numpy(), cost=res.cost.numpy(),
                initial_cost=res.initial_cost.numpy())


def ba_rank(rank, arrays, iterations):
    """``distributed_bundle_adjust`` on the global problem and on
    ``shard_problem``'s DTensors; and the refusal of a landmark count that
    does not split over the ranks."""
    from photogrammetry_tpu_torch.parallel import (
        distributed_bundle_adjust, make_mesh, shard_problem,
    )
    from photogrammetry_tpu_torch.sfm.ba import BAProblem, BAState

    mesh = make_mesh(device_type="cpu")
    rs, ts, points, obs, mask, k = (torch.from_numpy(a) for a in arrays)
    state = BAState(rs=rs, ts=ts, points=points)
    prob = BAProblem(obs=obs, mask=mask, k=k)
    out = {"global": _ba_result(distributed_bundle_adjust(
        state, prob, mesh, num_iterations=iterations))}
    out["sharded"] = _ba_result(distributed_bundle_adjust(
        *shard_problem(state, prob, mesh), mesh, num_iterations=iterations))
    try:
        distributed_bundle_adjust(
            state._replace(points=points[:-1]),
            prob._replace(obs=obs[:, :-1], mask=mask[:, :-1]), mesh)
        out["refused"] = None
    except ValueError as err:
        out["refused"] = str(err)
    return out


def pose_graph_rank(rank, cases):
    """``distributed_optimize_pose_graph`` on each (rs, ts, graph arrays,
    pad multiples, keyword arguments) case; the graph padded by the port's
    ``pad_graph`` at each multiple in turn."""
    from photogrammetry_tpu_torch.parallel.dist_pose_graph import (
        distributed_optimize_pose_graph, pad_graph,
    )
    from photogrammetry_tpu_torch.parallel.mesh import make_mesh
    from photogrammetry_tpu_torch.sfm.pose_graph import PoseGraph

    mesh = make_mesh(device_type="cpu")
    out = []
    for rs, ts, graph, pads, kwargs in cases:
        g = PoseGraph(*(torch.from_numpy(a) for a in graph))
        for multiple in pads:
            g = pad_graph(g, multiple)
        res = distributed_optimize_pose_graph(
            torch.from_numpy(rs), torch.from_numpy(ts), g, mesh, **kwargs)
        out.append(dict(rs=res.rs.numpy(), ts=res.ts.numpy(),
                        cost=res.cost.numpy(),
                        initial_cost=res.initial_cost.numpy(),
                        edges=int(g.edges.shape[0])))
    return out


def pod_mesh_rank(rank):
    """``make_pod_mesh`` on this rank: its shape, axis names and this
    rank's coordinate."""
    from photogrammetry_tpu_torch.parallel.multihost import make_pod_mesh

    mesh = make_pod_mesh(device_type="cpu")
    return tuple(mesh.shape), tuple(mesh.mesh_dim_names), \
        tuple(mesh.get_coordinate())


def initialize_rank(rank, address, world):
    """``multihost.initialize`` at ``address`` as process ``rank`` of
    ``world``, then one all-reduce over the world (rank + 1 from each)."""
    import torch.distributed as dist

    from photogrammetry_tpu_torch.parallel.multihost import initialize

    torch.set_num_threads(1)
    initialize(address, world, rank, backend="gloo")
    try:
        x = torch.tensor([rank + 1.0])
        dist.all_reduce(x)
        if float(x) != world * (world + 1) / 2:
            raise AssertionError(f"all_reduce gave {float(x)}")
    finally:
        dist.destroy_process_group()
