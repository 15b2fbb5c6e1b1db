"""Device meshes and distributed execution (twin of ``sara_tpu/parallel``).

Device meshes over ``torch.distributed`` (NCCL on the card, gloo on the
CPU), sharded bundle adjustment (points or observations partitioned, the
camera system reduced with all-reduces) and data-parallel batched
matching.
"""

from sara_tpu_torch.parallel.mesh import make_mesh, local_device_count
from sara_tpu_torch.parallel.comm_model import BACommModel
from sara_tpu_torch.parallel.dist_ba import (
    shard_ba_problem, distributed_bundle_adjust)
from sara_tpu_torch.parallel.dist_frontend import batched_match_pairs
from sara_tpu_torch.parallel.multihost import (
    initialize_distributed, make_host_chip_mesh, multihost_bundle_adjust,
    process_local_slice, shard_ba_problem_2d)

__all__ = [
    "make_mesh", "local_device_count", "BACommModel",
    "shard_ba_problem", "distributed_bundle_adjust",
    "batched_match_pairs",
    "initialize_distributed", "make_host_chip_mesh",
    "multihost_bundle_adjust", "process_local_slice", "shard_ba_problem_2d",
]
