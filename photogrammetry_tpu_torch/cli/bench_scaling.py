"""Scaling efficiency of the distributed BA: iterations/s at 1..N ranks
(port of photogrammetry_tpu/cli/bench_scaling.py).

    python -m photogrammetry_tpu_torch.cli.bench_scaling [--devices 1 2 4 8]
        [--strong | --overhead] [--force-cpu] [--stats PATH]

Efficiency is measured the standard way, as in the JAX package:

  weak scaling   (default): tracks = tracks_per_device * n; efficiency =
                 iters/s(n) / iters/s(1) (ideal: flat, per-rank work
                 constant, only the all-reduce of the reduced camera
                 system grows)
  strong scaling (--strong): fixed total tracks split n ways; efficiency =
                 n-rank speedup / n
  overhead       (--overhead): fixed total tracks; the n-rank sharded run
                 against the same problem at the first size:
                 overhead_ratio = t_1 / t_n, ideal 1.0.  CPU ranks share
                 the host's cores, so this is the meaningful mode there.

Each mesh size is one world of n spawned ranks: one rank a card over NCCL
(sizes above the card count are skipped), or with ``--force-cpu`` n gloo
processes of one torch thread each.  Rank 0's time is the result.
Appends one JSON record per mesh size to a stats log
(``utils/profiling.append_stats``).
"""
from __future__ import annotations

import argparse
import json
import socket
import sys
import time


def _parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--devices", type=int, nargs="+", default=[1, 2, 4, 8],
                   help="mesh sizes to benchmark")
    p.add_argument("--frames", type=int, default=16)
    p.add_argument("--tracks-per-device", type=int, default=2048)
    p.add_argument("--iterations", type=int, default=10,
                   help="LM iterations per timed call")
    p.add_argument("--repeats", type=int, default=5)
    p.add_argument("--strong", action="store_true",
                   help="strong scaling: fixed total tracks split n ways")
    p.add_argument("--overhead", action="store_true",
                   help="sharding-overhead mode: fixed total tracks, "
                   "n-rank time vs 1-rank time for the same problem")
    p.add_argument("--force-cpu", action="store_true",
                   help="run the ranks as gloo processes on the CPU "
                   "(default: one rank a CUDA card)")
    p.add_argument("--stats", default="data/bench/scaling_stats.json",
                   help="append-only JSON stats log")
    return p.parse_args(argv)


def build_problem(rng, f: int, t: int):
    """bench_all.py's BA problem as numpy (rs, ts, points, obs, K), drawn
    in the JAX CLI's order."""
    import numpy as np
    import torch

    from photogrammetry_tpu_torch.sfm.ba import project

    k = np.array([[520.0, 0, 320], [0, 520.0, 240], [0, 0, 1]], np.float32)
    pts = (rng.uniform(-2, 2, (t, 3)) + [0, 0, 6]).astype(np.float32)
    rs = np.tile(np.eye(3, dtype=np.float32)[None], (f, 1, 1))
    ts = rng.normal(0, 0.1, (f, 3)).astype(np.float32)
    obs = project(*(torch.from_numpy(x) for x in (rs, ts, pts, k)))[0]
    obs = obs.numpy() + rng.normal(0, 0.5, obs.shape).astype(np.float32)
    points = pts + rng.normal(0, 0.05, (t, 3)).astype(np.float32)
    return rs, ts, points, obs, k


def _time_rank(rank, problem, device_type, iterations, repeats):
    """One rank: the sharded BA, a warm-up and ``repeats`` timed calls;
    seconds per call."""
    import torch

    from photogrammetry_tpu_torch.parallel import (
        distributed_bundle_adjust, make_mesh,
    )
    from photogrammetry_tpu_torch.parallel.mesh import mesh_device
    from photogrammetry_tpu_torch.sfm.ba import BAProblem, BAState

    mesh = make_mesh(device_type=device_type)
    dev = mesh_device(mesh)
    rs, ts, points, obs, k = (torch.as_tensor(x, device=dev)
                              for x in problem)
    state = BAState(rs=rs, ts=ts, points=points)
    prob = BAProblem(obs=obs, mask=torch.ones(obs.shape[:2], dtype=torch.bool,
                                              device=dev), k=k)

    def run():
        res = distributed_bundle_adjust(state, prob, mesh,
                                        num_iterations=iterations)
        res.state.points.cpu()          # waits for the device
        return res

    run()                               # warm-up (kernel build, caches)
    start = time.perf_counter()
    for _ in range(repeats):
        run()
    return (time.perf_counter() - start) / repeats


def main(argv=None) -> int:
    args = _parse_args(argv)
    import numpy as np
    import torch

    from photogrammetry_tpu_torch import resolve_device
    from photogrammetry_tpu_torch.parallel.mesh import default_backend
    from photogrammetry_tpu_torch.parallel.multihost import run_world
    from photogrammetry_tpu_torch.utils.profiling import append_stats

    device_type = "cpu" if args.force_cpu else resolve_device("cuda").type
    if device_type == "cuda":
        available = torch.cuda.device_count()
        platform = torch.cuda.get_device_name(0)
    else:
        available = max(args.devices)
        platform = "cpu"
    sizes = [n for n in args.devices if n <= available]
    skipped = [n for n in args.devices if n > available]
    if skipped:
        print(f"# skipping mesh sizes {skipped}: only {available} "
              f"devices available", file=sys.stderr)

    total_tracks_strong = args.tracks_per_device * max(sizes)
    rng = np.random.default_rng(0)
    f = args.frames
    results = []
    base_ips = None
    for n in sizes:
        t = (total_tracks_strong if (args.strong or args.overhead)
             else args.tracks_per_device * n)
        problem = build_problem(rng, f, t)
        secs = run_world(
            _time_rank, n, (problem, device_type, args.iterations,
                            args.repeats),
            backend=default_backend(device_type), timeout=None,
            threads=1 if device_type == "cpu" else None)[0]
        ips = args.iterations / secs
        if base_ips is None:
            base_ips = ips
        if args.strong:
            eff = (ips / base_ips) / (n / sizes[0])
        else:   # weak: per-rank work constant; overhead: t_1 / t_n
            eff = ips / base_ips
        rec = {
            "metric": "ba_iters_per_s",
            "mesh_devices": n,
            "frames": f,
            "tracks": t,
            "mode": ("overhead" if args.overhead
                     else "strong" if args.strong else "weak"),
            "value": round(ips, 3),
            "unit": "iters/s",
            "scaling_efficiency": round(eff, 3),
            "platform": platform,
            "hostname": socket.gethostname(),
            "timestamp": time.strftime("%Y-%m-%dT%H:%M:%S"),
        }
        results.append(rec)
        print(json.dumps(rec))

    if args.stats:
        for rec in results:
            append_stats(args.stats, rec)
    return 0


if __name__ == "__main__":
    sys.exit(main())
