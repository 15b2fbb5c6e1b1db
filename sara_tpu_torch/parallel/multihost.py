"""Multi-host distributed runtime setup.

Twin of ``sara_tpu/parallel/multihost.py``, the multi-host layer for
BASELINE config 5 (N >= 2 hosts): starts ``torch.distributed``, builds a
(host, chip) ``DeviceMesh`` and shards the BA problem so that reductions
run over the chips of a host (NVLink) and then across hosts (the NIC). A
single process exercises the same code with a world of one; multi-rank
behaviour is held by gloo worlds on the CPU.
"""

from __future__ import annotations

import os

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

from sara_tpu_torch.parallel.dist_ba import _obs_shard
from sara_tpu_torch.parallel.mesh import TIMEOUT, _ensure_process_group


def initialize_distributed(coordinator_address: str | None = None,
                           num_processes: int | None = None,
                           process_id: int | None = None,
                           device=None) -> bool:
    """Start the process group (idempotent). Arguments default to
    torchrun's ``MASTER_ADDR``:``MASTER_PORT``, ``WORLD_SIZE`` and
    ``RANK``; one process is a no-op (returns False). NCCL on the card
    (``device`` None), gloo on the CPU. Returns True when it started a
    group of more than one process or one was running."""
    if dist.is_initialized():
        return True
    if coordinator_address is None and "MASTER_ADDR" in os.environ:
        coordinator_address = (f"{os.environ['MASTER_ADDR']}:"
                               f"{os.environ.get('MASTER_PORT', '29500')}")
    num_processes = num_processes or int(os.environ.get("WORLD_SIZE", "1"))
    if num_processes <= 1 or coordinator_address is None:
        return False
    process_id = process_id if process_id is not None else int(
        os.environ.get("RANK", "0"))
    cuda = device is None or torch.device(device).type == "cuda"
    dist.init_process_group("nccl" if cuda else "gloo",
                            init_method=f"tcp://{coordinator_address}",
                            world_size=num_processes, rank=process_id,
                            timeout=TIMEOUT)
    return True


def make_host_chip_mesh(host_axis: str = "host", chip_axis: str = "chip",
                        hosts: int | None = None,
                        n_devices: int | None = None,
                        device=None) -> DeviceMesh:
    """2-D (hosts, chips-per-host) mesh over every rank of the process
    group. ``hosts`` overrides the host-row count (default: the world size
    over torchrun's ``LOCAL_WORLD_SIZE``), so one host's ranks can stand in
    for several hosts; ``n_devices`` must equal the world size."""
    kind = _ensure_process_group(device)
    world = dist.get_world_size()
    if n_devices is not None and n_devices != world:
        raise ValueError(f"make_host_chip_mesh: {n_devices} devices asked "
                         f"for, but the process group has {world} ranks")
    n_host = hosts if hosts is not None else max(
        world // int(os.environ.get("LOCAL_WORLD_SIZE", world)), 1)
    if world % n_host:
        raise ValueError(f"{world} devices not divisible by "
                         f"{n_host} host rows")
    return init_device_mesh(kind, (n_host, world // n_host),
                            mesh_dim_names=(host_axis, chip_axis))


def _coords(mesh: DeviceMesh, host_axis: str, chip_axis: str):
    names = mesh.mesh_dim_names
    coord = mesh.get_coordinate()
    return (coord[names.index(host_axis)], coord[names.index(chip_axis)],
            mesh.size(names.index(host_axis)),
            mesh.size(names.index(chip_axis)))


def shard_ba_problem_2d(prob, mesh: DeviceMesh, host_axis: str = "host",
                        chip_axis: str = "chip"):
    """This rank's part of a BAProblem on a (host, chip) mesh: the
    observations split into hosts x chips contiguous shards (host-major,
    padded with masked rows); cameras, points and intrinsics replicated."""
    h, c, n_host, n_chip = _coords(mesh, host_axis, chip_axis)
    return _obs_shard(prob, n_host * n_chip, h * n_chip + c)


def multihost_bundle_adjust(prob, mesh: DeviceMesh, opts=None,
                            host_axis: str = "host",
                            chip_axis: str = "chip"):
    """Bundle adjustment over a (host, chip) mesh, the BASELINE config 5
    entry point: the numeric program of ``ba.core.bundle_adjust_cg`` on
    observation shards, each sum reduced over the chips of a host and then
    across hosts. Returns (problem, info), the same on every rank."""
    from sara_tpu_torch.ba.core import BAOptions, _lm_cg

    opts = opts or BAOptions()
    chips = mesh.get_group(chip_axis)
    hosts = mesh.get_group(host_axis)

    def allreduce(x):
        dist.all_reduce(x, group=chips)
        dist.all_reduce(x, group=hosts)
        return x

    out, info = _lm_cg(shard_ba_problem_2d(prob, mesh, host_axis, chip_axis),
                       opts, allreduce)
    return prob._replace(poses=out.poses, points=out.points,
                         intrinsics=out.intrinsics), info


def process_local_slice(n: int) -> slice:
    """Row range [start, stop) of a length-n global array owned by this
    process (contiguous block partitioning for per-host input pipelines)."""
    p = dist.get_rank() if dist.is_initialized() else 0
    np_ = dist.get_world_size() if dist.is_initialized() else 1
    per = -(-n // np_)
    return slice(p * per, min((p + 1) * per, n))
