"""Multi-process worlds: initialisation, the pod mesh, and local worlds of
spawned ranks (port of photogrammetry_tpu/parallel/multihost.py).

On a cluster, call ``initialize()`` once per process before any collective;
the mesh axes are laid out so that the per-iteration BA all-reduce
("tracks") stays within a host while only submap/pose-graph exchange
crosses hosts ("submaps").  ``run_world`` starts a world of ranks on this
machine in spawned processes, the way ``run_sfm --mesh``,
``bench_scaling`` and the tests run one.
"""
from __future__ import annotations

import os
import time

import torch
import torch.distributed as dist

from photogrammetry_tpu_torch.parallel.mesh import (
    free_port, init_world, make_mesh,
)

ENV_COORDINATOR = "PHOTOGRAMMETRY_COORDINATOR"


def initialize(coordinator_address: str | None = None,
               num_processes: int | None = None,
               process_id: int | None = None,
               backend: str | None = None) -> None:
    """``init_process_group`` at ``tcp://<coordinator_address>`` (host:port)
    with the environment's fallback (``PHOTOGRAMMETRY_COORDINATOR``).

    Does nothing when the process is the only one (neither an address nor
    a process count is known).  ``backend`` None: gloo for CPU tensors and
    NCCL for CUDA tensors.
    """
    coordinator_address = coordinator_address or os.environ.get(
        ENV_COORDINATOR)
    if coordinator_address is None and num_processes is None:
        return  # single-process
    dist.init_process_group(
        backend, init_method=f"tcp://{coordinator_address}",
        world_size=-1 if num_processes is None else num_processes,
        rank=-1 if process_id is None else process_id)


def make_pod_mesh(device_type: str = "cuda"):
    """2-D (hosts, ranks per host) mesh: ("submaps", "tracks").  The ranks
    of one host (``LOCAL_WORLD_SIZE``, default all of them) form the
    "tracks" axis, so the per-iteration Schur all-reduce never leaves a
    host; the "submaps" axis spans hosts.  A process outside any world
    gets a world of one, as ``make_mesh`` gives it."""
    world = (dist.get_world_size() if dist.is_initialized()
             else int(os.environ.get("WORLD_SIZE", 1)))
    per_host = int(os.environ.get("LOCAL_WORLD_SIZE", world))
    if per_host <= 0 or world % per_host:
        raise ValueError(f"make_pod_mesh: {world} ranks do not split into "
                         f"hosts of {per_host}")
    return make_mesh((world // per_host, per_host), ("submaps", "tracks"),
                     device_type=device_type)


def _rank_main(rank, fn, world_size, init_method, backend, threads, args,
               results):
    if threads:
        torch.set_num_threads(threads)
    init_world(backend, world_size, rank, init_method)
    try:
        out = fn(rank, *args)
        results.put((rank, out))
    finally:
        dist.destroy_process_group()


def run_world(fn, world_size: int, args: tuple = (), backend: str = "gloo",
              timeout: float | None = 600.0,
              threads: int | None = None) -> list:
    """Run ``fn(rank, *args)`` in ``world_size`` spawned processes that form
    one process group (``backend``, a store on a free local port); returns
    the ranks' results in rank order.  ``fn`` and what it returns must
    pickle; the ranks start with this process's environment.  ``threads``
    sets each rank's torch threads (CPU ranks: one, so that the ranks do
    not each start a thread per core).  A rank that raises ends the
    world and re-raises here; so does ``timeout`` (seconds; None waits for
    as long as the ranks run)."""
    import torch.multiprocessing as mp

    ctx = mp.get_context("spawn")
    results = ctx.SimpleQueue()
    init_method = f"tcp://127.0.0.1:{free_port()}"
    procs = mp.start_processes(
        _rank_main, args=(fn, world_size, init_method, backend, threads,
                          tuple(args), results),
        nprocs=world_size, join=False, start_method="spawn")
    out = {}
    deadline = None if timeout is None else time.monotonic() + timeout
    try:
        # drain the queue while waiting: a rank blocks on a full pipe
        while True:
            while not results.empty():
                rank, val = results.get()
                out[rank] = val
            if procs.join(timeout=0.05):
                break
            if deadline is not None and time.monotonic() > deadline:
                raise TimeoutError(f"run_world: {world_size} ranks still "
                                   f"running after {timeout} s")
        while not results.empty():
            rank, val = results.get()
            out[rank] = val
    finally:
        for p in procs.processes:
            if p.is_alive():
                p.terminate()
                p.join(10)
    return [out[r] for r in range(world_size)]
