"""Data-parallel frontend: batched matching over image pairs on a mesh.

Twin of ``sara_tpu/parallel/dist_frontend.py``: batches of descriptor sets
are matched as one batched GEMM program (the matcher of the global-SfM
pair stage, ``matching/brute_force.py::_match_sets``), with the batch axis
split over the ranks of a mesh (pure data parallelism: each pair's GEMM
stays on its rank) and the results all-gathered.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from sara_tpu_torch.matching.brute_force import _match_sets


def _match_batch(da, ma, db, mb, ratio: float):
    """Batched mutual ratio-test matching.

    da: (B, N, D), ma: (B, N) masks; returns (j (B, N) int32, ok (B, N),
    d1 (B, N))."""
    j, ok, d1 = _match_sets(da, ma, db, mb, ratio)
    return j.to(torch.int32), ok, d1


def batched_match_pairs(desc_a, mask_a, desc_b, mask_b, mesh=None,
                        ratio: float = 0.8, axis: str = "shard"):
    """Match B descriptor-set pairs, the batch axis split over the ranks of
    ``mesh[axis]`` (every rank passes the whole batch and gets the whole
    result)."""
    if mesh is None:
        return _match_batch(desc_a, mask_a, desc_b, mask_b, ratio)
    group = mesh.get_group(axis)
    n = dist.get_world_size(group)
    rank = dist.get_rank(group)
    assert desc_a.shape[0] % n == 0, "batch must divide mesh size"
    per = desc_a.shape[0] // n
    sl = slice(rank * per, (rank + 1) * per)
    outs = _match_batch(desc_a[sl], mask_a[sl], desc_b[sl], mask_b[sl],
                        ratio)
    gathered = []
    for x in outs:
        parts = [torch.empty_like(x) for _ in range(n)]
        dist.all_gather(parts, x.contiguous(), group=group)
        gathered.append(torch.cat(parts))
    return tuple(gathered)
