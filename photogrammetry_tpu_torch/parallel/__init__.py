"""Distributed BA and pose graph over ``torch.distributed`` (port of
photogrammetry_tpu/parallel/)."""
from photogrammetry_tpu_torch.parallel.mesh import make_mesh, track_sharding
from photogrammetry_tpu_torch.parallel.dist_ba import (
    distributed_bundle_adjust, shard_problem,
)

__all__ = ["make_mesh", "track_sharding", "distributed_bundle_adjust",
           "shard_problem"]
