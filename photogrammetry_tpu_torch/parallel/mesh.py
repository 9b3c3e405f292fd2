"""Device meshes over the ranks of a ``torch.distributed`` process group
(port of photogrammetry_tpu/parallel/mesh.py).

One rank is one process.  Axis convention, as in the JAX package:

  "tracks" — landmark/track sharding (the data-parallel axis of BA: each
             rank owns a shard of landmarks and the reduced camera system
             is assembled by one all-reduce)
  "frames" — keyframe sharding

The backend follows the device: NCCL on ``cuda`` with one rank per card
(rank r on ``cuda:r``, or ``LOCAL_RANK`` under a launcher), gloo on
``cpu``.  An explicit ``backend="gloo"`` lets a caller place several ranks
on one card; gloo's CUDA support covers ``all_reduce`` and ``broadcast``
only, which is all the port's collectives use.
"""
from __future__ import annotations

import os
import socket

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh
from torch.distributed.tensor import Replicate, Shard


def default_backend(device_type: str) -> str:
    return "nccl" if device_type == "cuda" else "gloo"


def free_port() -> int:
    """A TCP port on 127.0.0.1 that is free at the time of the call."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def init_world(backend: str, world_size: int = 1, rank: int = 0,
               init_method: str | None = None) -> None:
    """``init_process_group`` for this process: under a launcher
    (``WORLD_SIZE`` set) from the environment, else a world of
    ``world_size`` at ``init_method`` (default: a world of one on a free
    local port; a world of one still needs a store)."""
    if "WORLD_SIZE" in os.environ and init_method is None:
        dist.init_process_group(backend)
        return
    if init_method is None:
        if world_size != 1:
            raise ValueError("init_world: a world of more than one rank "
                             "needs the address of its store")
        init_method = f"tcp://127.0.0.1:{free_port()}"
    dist.init_process_group(backend, init_method=init_method,
                            world_size=world_size, rank=rank)


def make_mesh(shape=None, axis_names=("tracks",), device_type: str = "cuda",
              backend: str | None = None) -> DeviceMesh:
    """A mesh over the ranks of the process group (initialised first if it
    is not: from the environment under a launcher, else a world of one);
    default: a 1-D mesh over all of them.  On ``cuda`` the rank's card
    becomes the current device; NCCL refuses a world larger than the
    number of cards."""
    if device_type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("make_mesh: CUDA device requested but "
                           "torch.cuda.is_available() is False; pass "
                           "device_type='cpu'")
    if not dist.is_initialized():
        init_world(backend or default_backend(device_type))
    world = dist.get_world_size()
    if device_type == "cuda":
        count = torch.cuda.device_count()
        if "nccl" in dist.get_backend() and world > count:
            raise ValueError(f"make_mesh: NCCL needs one card a rank: "
                             f"world of {world}, {count} cards")
        local = int(os.environ.get("LOCAL_RANK", dist.get_rank()))
        torch.cuda.set_device(local % count)
    if shape is None:
        shape = (world,) + (1,) * (len(axis_names) - 1)
    return init_device_mesh(device_type, tuple(shape),
                            mesh_dim_names=tuple(axis_names))


def mesh_device(mesh: DeviceMesh) -> torch.device:
    """The device this rank's tensors live on for ``mesh``."""
    if mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(mesh.device_type)


def track_sharding(mesh: DeviceMesh, rank_sharded_dim: int, ndim: int,
                   axis: str = "tracks") -> list:
    """DTensor placements that shard dimension ``rank_sharded_dim`` of an
    ``ndim``-dimensional tensor over ``axis`` and replicate it over the
    mesh's other axes (the JAX package's ``NamedSharding``)."""
    if not 0 <= rank_sharded_dim < ndim:
        raise ValueError(f"track_sharding: dimension {rank_sharded_dim} of "
                         f"a {ndim}-d tensor")
    return [Shard(rank_sharded_dim) if name == axis else Replicate()
            for name in mesh.mesh_dim_names]
