"""Device meshes over ``torch.distributed``.

Twin of ``sara_tpu/parallel/mesh.py``: a 1-D ``DeviceMesh`` whose one
dimension is named by ``axis``. Axis conventions used across the package:

- ``"shard"``: the main data-parallel axis (points and observations in
  BA, image pairs in the matching frontend);
- ``"block"``: the keyframe blocks of the partitioned BA.

A mesh has one rank per device: NCCL on the card (one process per GPU),
gloo on the CPU. In one process with no process group, :func:`make_mesh`
starts a world of one, as a single-process JAX mesh needs no launcher.
"""

from __future__ import annotations

from datetime import timedelta

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

from sara_tpu_torch import resolve_device

# How long a collective or the group's start may wait on a missing rank.
TIMEOUT = timedelta(seconds=60)


def local_device_count() -> int:
    """CUDA devices visible to this process (0 without a card)."""
    return torch.cuda.device_count()


def _ensure_process_group(device=None) -> str:
    """Start a world of one (NCCL on the card, gloo on the CPU) when no
    process group exists. Returns the mesh's device type ("cuda" or
    "cpu"). Raises for a card mesh over a group without NCCL: its
    collectives would run through gloo on the host."""
    dev = resolve_device(device)
    if not dist.is_initialized():
        backend = "nccl" if dev.type == "cuda" else "gloo"
        if dev.type == "cuda" and dev.index is not None:
            torch.cuda.set_device(dev)
        dist.init_process_group(backend, store=dist.HashStore(), rank=0,
                                world_size=1, timeout=TIMEOUT)
    elif dev.type == "cuda" and "nccl" not in dist.get_backend():
        raise RuntimeError(f"a mesh on the card needs an NCCL process "
                           f"group, and this one's backend is "
                           f"{dist.get_backend()!r}")
    return dev.type


def make_mesh(n_devices: int | None = None, axis: str = "shard",
              device=None) -> DeviceMesh:
    """1-D mesh over the ranks of the default process group (default: all
    of them; ``n_devices`` must equal the world size), named ``axis``.
    ``device`` None means the card (NCCL); ``"cpu"`` gives a gloo mesh."""
    kind = _ensure_process_group(device)
    world = dist.get_world_size()
    if n_devices is not None and n_devices != world:
        raise ValueError(f"make_mesh: {n_devices} devices asked for, but "
                         f"the process group has {world} ranks")
    return init_device_mesh(kind, (world,), mesh_dim_names=(axis,))
