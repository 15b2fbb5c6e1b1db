"""Distributed bundle adjustment over a ``torch.distributed`` device mesh.

Twin of ``sara_tpu/parallel/dist_ba.py``. Every rank calls these with the
same problem and gets the same result. Two paths:

1. **Dense-Schur point shards** (default when eligible,
   ``ba/dense_schur.py::dense_schur_bundle_adjust_sharded``): the
   point-major layout co-partitions points WITH their observations, so all
   per-point work is shard-local and the only communication is the
   all-reduce of the reduced camera system ((6C)^2 + 42 C + 6 C floats)
   plus the cost per LM iteration.

2. **CG over observation shards** (huge C, distortion, optimizable
   intrinsics): the matrix-free program of ``bundle_adjust_cg`` with each
   rank holding a contiguous shard of the observations and cameras, points
   and intrinsics replicated. Every sum over observations is all-reduced:
   the cost; U and bc (O(C)); V and bp (O(P)) once per LM iteration; and
   in every CG matvec the point-side sum W^T x (O(P), 3 P floats) and the
   camera-side sum W y (O(C)). The O(P) traffic is the price of replicated
   points (the reference's GSPMD gathers sharded points instead); the PCG
   dot products act on replicated camera vectors and need no
   communication. The numeric program is that of ``bundle_adjust_cg``;
   only where the sums are made differs.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from sara_tpu_torch.ba.core import BAOptions, BAProblem, _lm_cg


def _all_reduce_over(group):
    def allreduce(x):
        dist.all_reduce(x, group=group)
        return x

    return allreduce


def _obs_shard(prob: BAProblem, n: int, k: int) -> BAProblem:
    """Shard ``k`` of ``n`` of the observation axis (padded to a multiple
    of ``n`` with masked rows); cameras and points stay whole."""
    O = prob.obs_mask.shape[0]
    per = -(-O // n)
    sl = slice(min(k * per, O), min((k + 1) * per, O))
    pad = per - (sl.stop - sl.start)

    def take(a, fill=0):
        a = a[sl]
        return torch.cat([a, a.new_full((pad,) + a.shape[1:], fill)]) \
            if pad else a

    return prob._replace(cam_idx=take(prob.cam_idx),
                         pt_idx=take(prob.pt_idx), uv=take(prob.uv),
                         obs_mask=take(prob.obs_mask, False))


def shard_ba_problem(prob: BAProblem, mesh, axis: str = "shard"
                     ) -> BAProblem:
    """This rank's part of ``prob`` on ``mesh[axis]``: a contiguous shard of
    the observations (padded to a multiple of the mesh size with masked
    rows); cameras, points and intrinsics replicated."""
    group = mesh.get_group(axis)
    return _obs_shard(prob, dist.get_world_size(group),
                      dist.get_rank(group))


def distributed_bundle_adjust(prob: BAProblem, mesh,
                              opts: BAOptions = BAOptions(),
                              axis: str = "shard"):
    """Bundle adjustment over ``mesh[axis]`` (dense-Schur point shards when
    eligible, CG over observation shards otherwise; module docstring).
    Returns (problem, info), the same on every rank."""
    if prob.points.shape[0] == 0 or prob.uv.shape[0] == 0:
        from sara_tpu_torch.ba.core import _empty_info

        return prob, _empty_info(prob, opts)
    group = mesh.get_group(axis)
    eligible = (opts.solver in ("auto", "dense")
                and prob.intr_free is None and prob.intrinsics.shape[0] == 4
                and prob.poses.shape[0] <= opts.dense_max_cameras)
    if eligible:
        from sara_tpu_torch.ba.dense_schur import (
            dense_eligible, dense_schur_bundle_adjust_sharded, pack_pt_major)

        n = dist.get_world_size(group)
        Pn = int(prob.points.shape[0])
        chunk = min(opts.dense_chunk, max(64, -(-Pn // n)))
        ptm, stats = pack_pt_major(prob, chunk=chunk)
        if dense_eligible(stats, opts):
            poses, points, info = dense_schur_bundle_adjust_sharded(
                ptm, mesh, opts, stats["chunk"], axis)
            return prob._replace(poses=poses, points=points[:Pn]), info
    out, info = _lm_cg(shard_ba_problem(prob, mesh, axis), opts,
                       _all_reduce_over(group))
    return prob._replace(poses=out.poses, points=out.points,
                         intrinsics=out.intrinsics), info
