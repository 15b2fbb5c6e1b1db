"""Keyframe/map-block partitioned bundle adjustment (BASELINE config 5).

Twin of ``sara_tpu/ba/partitioned.py``. City-scale collections exceed a
single dense-Schur system (C > ~512). The structure:

- cameras are partitioned into contiguous KEYFRAME BLOCKS (temporal
  locality: consecutive views share structure);
- a block's sub-problem holds its cameras with ALL of their observations,
  and therefore every point those cameras see; each point is OWNED by the
  block holding most of its observations and enters other blocks as a
  frozen boundary copy that anchors them in the global frame;
- every block is a dense-Schur problem of one padded shape, so one
  ``torch.func.vmap`` of the LM loop (``ba/dense_schur.py::_lm_loop``)
  solves all blocks of a phase at once, each with its own lambda,
  accept/reject and cost; with a device mesh the blocks of a phase are
  split over the ranks with no communication inside the solve;
- a few outer SWEEPS re-exchange the block-owned updates (a host-side
  scatter), the only cross-block traffic: O(C * 6) floats per sweep plus
  the owned points.

Planning and packing are NumPy, line for line the reference's. The one
change: the reference solves each block as ONE point chunk; here the point
axis is cut into chunks whose one-hot working set (blocks x Q x Sp x Cb)
fits :data:`CHUNK_BYTES`, which at city scale (Cb ~ 1024, Sp = 512) would
otherwise take gigabytes per block. The sums are the same, taken in
another order; a problem that fits keeps one chunk per block.
"""

from __future__ import annotations

import time
from typing import NamedTuple

import numpy as np
import torch

from sara_tpu_torch.ba.core import BAOptions, BAProblem
from sara_tpu_torch.ba.dense_schur import (PtMajorBA, _bucket, _lm_loop,
                                           _on_host)
from sara_tpu_torch.utils.host import fetch, put

# Bytes the one-hot camera operands of one chunk may take over all blocks
# of a phase (the (B, Q, Sp, Cb) selector in bool, the working dtype and
# the accumulation dtype).
CHUNK_BYTES = 4 << 30


class BlockPlan(NamedTuple):
    """Host-side partition plan (numpy)."""

    n_blocks: int
    block_of_cam: np.ndarray       # (C,) owning block of each camera
    block_of_pt: np.ndarray        # (P,) owning block of each point
    cam_local: np.ndarray          # (B, Cb) global camera id per local slot
    cam_owned: np.ndarray          # (B, Cb) bool — valid (non-pad) slots
    pt_local: np.ndarray           # (B, Pb) global point id per local slot
    pt_valid: np.ndarray           # (B, Pb) bool — valid (non-pad) slots
    pt_owned: np.ndarray           # (B, Pb) bool — block updates this point


def plan_blocks(prob: BAProblem, n_blocks: int) -> BlockPlan:
    """Contiguous keyframe camera blocks; every block carries ALL points
    its cameras observe, owning those where it holds the most
    observations (ties toward the middle observing camera's block)."""
    prob = _on_host(prob)
    C = int(prob.poses.shape[0])
    P = int(prob.points.shape[0])
    cam_idx = np.asarray(prob.cam_idx)
    pt_idx = np.asarray(prob.pt_idx)
    mask = np.asarray(prob.obs_mask)
    block_of_cam = np.minimum(
        np.arange(C) * n_blocks // C, n_blocks - 1).astype(np.int64)

    votes = np.zeros((P, n_blocks), np.int64)
    np.add.at(votes, (pt_idx[mask], block_of_cam[cam_idx[mask]]), 1)
    order = np.argsort(pt_idx[mask], kind="stable")
    pts_s = pt_idx[mask][order]
    cams_s = cam_idx[mask][order]
    counts = np.bincount(pts_s, minlength=P)
    starts = np.zeros(P, np.int64)
    starts[1:] = np.cumsum(counts)[:-1]
    mid_block = np.full(P, -1, np.int64)
    seen = counts > 0
    mid_idx = starts[seen] + counts[seen] // 2
    mid_block[seen] = block_of_cam[cams_s[mid_idx]]
    best = votes.max(axis=1, initial=0)
    is_tied_mid = seen & (votes[np.arange(P),
                                np.clip(mid_block, 0, n_blocks - 1)] == best)
    block_of_pt = np.where(is_tied_mid, mid_block, np.argmax(votes, axis=1))
    block_of_pt[~seen] = -1   # unobserved points

    # Block observation set: its cameras' obs PLUS its owned points'
    # foreign obs. Every FREE variable (own cameras, owned points) then
    # sees all of its constraints, so a block solve with the rest frozen
    # is exact coordinate descent on the global objective.
    cam_lists, camown_lists, pt_lists, own_lists = [], [], [], []
    for b in range(n_blocks):
        own = np.nonzero(block_of_cam == b)[0]
        sel = mask & ((block_of_cam[cam_idx] == b)
                      | (block_of_pt[pt_idx] == b))
        cams_seen = np.unique(cam_idx[sel])
        boundary = cams_seen[block_of_cam[cams_seen] != b]
        cams = np.concatenate([own, boundary])
        cam_lists.append(cams)
        camown_lists.append(np.concatenate(
            [np.ones(len(own), bool), np.zeros(len(boundary), bool)]))
        pts = np.unique(pt_idx[sel])
        pt_lists.append(pts)
        own_lists.append(block_of_pt[pts] == b)

    Cb = _bucket(max(len(c) for c in cam_lists), 8)
    Pb = _bucket(max(max(len(p) for p in pt_lists), 1), 64)
    cam_local = np.zeros((n_blocks, Cb), np.int64)
    cam_owned = np.zeros((n_blocks, Cb), bool)
    pt_local = np.zeros((n_blocks, Pb), np.int64)
    pt_valid = np.zeros((n_blocks, Pb), bool)
    pt_owned = np.zeros((n_blocks, Pb), bool)
    for b in range(n_blocks):
        cam_local[b, :len(cam_lists[b])] = cam_lists[b]
        cam_owned[b, :len(cam_lists[b])] = camown_lists[b]
        pt_local[b, :len(pt_lists[b])] = pt_lists[b]
        pt_valid[b, :len(pt_lists[b])] = True
        pt_owned[b, :len(pt_lists[b])] = own_lists[b]
    return BlockPlan(n_blocks, block_of_cam, block_of_pt, cam_local,
                     cam_owned, pt_local, pt_valid, pt_owned)


def _pack_blocks(prob: BAProblem, plan: BlockPlan, blocks=None,
                 sp_min: int = 4):
    """Build the stacked (B, ...) point-major problems (host, numpy) for
    the given block subset (default: all), on the device of
    ``prob.intrinsics``. Returns (PtMajorBA, Sp)."""
    intrinsics = prob.intrinsics
    dev = intrinsics.device
    prob = _on_host(prob)
    if torch.is_tensor(prob.poses):
        prob = prob._replace(poses=fetch(prob.poses)[0])
    if blocks is not None:
        plan = plan._replace(
            cam_local=plan.cam_local[blocks],
            cam_owned=plan.cam_owned[blocks],
            pt_local=plan.pt_local[blocks],
            pt_valid=plan.pt_valid[blocks],
            pt_owned=plan.pt_owned[blocks],
            n_blocks=len(blocks))
        block_ids = list(blocks)
    else:
        block_ids = list(range(plan.n_blocks))
    B, Cb = plan.cam_local.shape
    Pb = plan.pt_local.shape[1]
    cam_idx = np.asarray(prob.cam_idx)
    pt_idx = np.asarray(prob.pt_idx)
    uv = np.asarray(prob.uv)
    mask = np.asarray(prob.obs_mask)
    pose_fixed = np.asarray(prob.pose_fixed)
    if pose_fixed.ndim == 1:
        pose_fixed = np.broadcast_to(pose_fixed[:, None],
                                     (pose_fixed.shape[0], 6))
    point_fixed = np.asarray(prob.point_fixed)

    # Global -> local camera slot per block.
    local_of_cam = np.full((B, int(prob.poses.shape[0])), -1, np.int64)
    for b in range(B):
        local_of_cam[b, plan.cam_local[b]] = np.arange(Cb)

    # Per-block observation lists (pt-major): the block's cameras' obs
    # plus its owned points' foreign obs (see plan_blocks).
    cam_blk = plan.block_of_cam[cam_idx]
    pt_blk = plan.block_of_pt[pt_idx]
    Sp = sp_min
    counts_all = np.zeros((B, Pb), np.int64)
    per_block = []
    for b in range(B):
        bid = block_ids[b]
        sel = np.nonzero(mask & ((cam_blk == bid) | (pt_blk == bid)))[0]
        pt_g = pt_idx[sel]
        # Global point id -> local row.
        local_of_pt = np.full(int(prob.points.shape[0]), -1, np.int64)
        local_of_pt[plan.pt_local[b][plan.pt_valid[b]]] = \
            np.arange(int(plan.pt_valid[b].sum()))
        rows = local_of_pt[pt_g]
        cams_l = local_of_cam[b, cam_idx[sel]]
        keep = (rows >= 0) & (cams_l >= 0)
        per_block.append((rows[keep], cams_l[keep], uv[sel][keep]))
        cnt = np.bincount(rows[keep], minlength=Pb)
        counts_all[b] = cnt
        Sp = max(Sp, int(cnt.max()) if len(cnt) else 1)
    Sp = _bucket(Sp, sp_min)

    cam_ps = np.zeros((B, Pb, Sp), np.int32)
    uv_ps = np.zeros((B, Pb, Sp, 2), uv.dtype)
    m_ps = np.zeros((B, Pb, Sp), bool)
    for b in range(B):
        rows, cams_l, uvb = per_block[b]
        order = np.argsort(rows, kind="stable")
        rows_s = rows[order]
        starts = np.zeros(Pb, np.int64)
        starts[1:] = np.cumsum(counts_all[b])[:-1]
        slot = np.arange(len(rows_s)) - starts[rows_s]
        cam_ps[b, rows_s, slot] = cams_l[order]
        uv_ps[b, rows_s, slot] = uvb[order]
        m_ps[b, rows_s, slot] = True

    poses = np.asarray(prob.poses)
    poses_b = poses[plan.cam_local]                            # (B, Cb, 6)
    points_b = np.asarray(prob.points)[plan.pt_local]          # (B, Pb, 3)
    # Free mask: frozen if globally fixed or a padding slot; boundary
    # POINT copies (not owned) are frozen anchors.
    free_b = (~pose_fixed)[plan.cam_local].astype(poses_b.dtype)
    free_b *= plan.cam_owned[..., None]
    ptfix_b = point_fixed[plan.pt_local] | ~plan.pt_owned

    ptm = PtMajorBA(
        poses=put(poses_b, dev),
        points=put(points_b, dev),
        intrinsics=intrinsics,
        cam_idx=put(cam_ps, dev),
        uv=put(uv_ps, dev),
        slot_mask=put(m_ps, dev),
        pose_free=put(free_b, dev),
        point_fixed=put(ptfix_b, dev),
    )
    return ptm, Sp


_BLOCK_AXES = PtMajorBA(poses=0, points=0, intrinsics=None, cam_idx=0, uv=0,
                        slot_mask=0, pose_free=0, point_fixed=0)


def _chunk_points(ptm_b: PtMajorBA) -> int:
    """Points per chunk Q: the whole padded block (the reference's one
    chunk) when the blocks' one-hot working set fits CHUNK_BYTES, else the
    largest power of two that does (Pb is 64 * 2^k, so Q divides it)."""
    B, Pb, Sp = ptm_b.cam_idx.shape
    Cb = ptm_b.poses.shape[1]
    dt = ptm_b.poses.dtype
    wd = torch.bfloat16 if dt == torch.float32 else dt
    per_point = B * Sp * Cb * (1 + torch.empty((), dtype=wd).element_size()
                               + torch.empty((), dtype=dt).element_size())
    Q = Pb
    while Q > 1 and Q * per_point > CHUNK_BYTES:
        Q //= 2
    return Q


def _solve_blocks(ptm_b: PtMajorBA, opts: BAOptions, Q: int):
    """All blocks of ``ptm_b`` in ONE program: ``torch.func.vmap`` of the
    dense-Schur LM loop over the leading block axis. Returns (poses
    (B, Cb, 6), points (B, Pb, 3), info with (B,) costs)."""

    def one(ptm):
        poses, points_t, info = _lm_loop((ptm,), opts, (Q,))
        return poses, points_t[0], info

    return torch.func.vmap(one, in_dims=(_BLOCK_AXES,))(ptm_b)


def _pad_blocks(ptm_b: PtMajorBA, n: int) -> PtMajorBA:
    """Pad the block axis to a multiple of ``n`` with inert blocks (every
    slot masked, every variable frozen)."""
    pad = (-ptm_b.poses.shape[0]) % n
    if not pad:
        return ptm_b

    def padb(a, fill=0):
        return torch.cat([a, a.new_full((pad,) + a.shape[1:], fill)])

    return ptm_b._replace(
        poses=padb(ptm_b.poses), points=padb(ptm_b.points),
        cam_idx=padb(ptm_b.cam_idx), uv=padb(ptm_b.uv),
        slot_mask=padb(ptm_b.slot_mask), pose_free=padb(ptm_b.pose_free),
        point_fixed=padb(ptm_b.point_fixed, True))


def _solve_on_mesh(ptm_b: PtMajorBA, opts: BAOptions, Q: int, mesh,
                   axis: str):
    """The phase's blocks split over the ranks of ``mesh[axis]`` (padded to
    a multiple of the world size with inert blocks); each rank solves its
    contiguous share, then the results are all-gathered."""
    import torch.distributed as dist

    group = mesh.get_group(axis)
    n = dist.get_world_size(group)
    rank = dist.get_rank(group)
    ptm_b = _pad_blocks(ptm_b, n)
    per = ptm_b.poses.shape[0] // n
    sl = slice(rank * per, (rank + 1) * per)
    mine = PtMajorBA(*(a if a is ptm_b.intrinsics else a[sl]
                       for a in ptm_b))
    poses, points, info = _solve_blocks(mine, opts, Q)
    costs = torch.stack([info["initial_cost"], info["final_cost"]])

    def gather(x, dim=0):
        parts = [torch.empty_like(x) for _ in range(n)]
        dist.all_gather(parts, x.contiguous(), group=group)
        return torch.cat(parts, dim=dim)

    poses, points = gather(poses), gather(points)
    costs = gather(costs, dim=1)                              # (2, B_pad)
    return poses, points, {"initial_cost": costs[0],
                           "final_cost": costs[1]}


def partitioned_bundle_adjust(prob: BAProblem, n_blocks: int,
                              opts: BAOptions = BAOptions(),
                              sweeps: int = 2, mesh=None,
                              block_axis: str = "block"):
    """Block-Jacobi partitioned BA. Returns (problem, info).

    Each sweep solves the blocks' dense-Schur sub-problems in two
    red/black phases (adjacent, structure-sharing blocks never update at
    once), each phase from one global snapshot and in one program,
    optionally split over the ranks of ``mesh[block_axis]`` (a
    ``torch.distributed`` DeviceMesh; every rank calls this with the same
    problem and gets the same result). The block-owned camera/point
    updates are then scattered back into the global state on the host.
    ``info``: the last phase's summed initial and final block costs, the
    sweep, Sp, the point chunk Q and the host seconds of each phase
    (packing, solve and scatter; each phase ends in one device-to-host
    transfer).
    """
    if prob.points.shape[0] == 0 or prob.uv.shape[0] == 0:
        z = prob.poses.new_zeros(())
        return prob, {"initial_cost": z, "final_cost": z, "sweep": 0}
    plan = plan_blocks(prob, n_blocks)
    dev = prob.poses.device
    cur = _on_host(prob)
    poses = fetch(prob.poses)[0]
    points = np.array(cur.points)
    info_out = {}
    phase_s = []
    phases = [[b for b in range(n_blocks) if b % 2 == 0],
              [b for b in range(n_blocks) if b % 2 == 1]]
    phases = [ph for ph in phases if ph]
    for sweep in range(sweeps):
        for phase in phases:
            t0 = time.perf_counter()
            ptm_b, Sp = _pack_blocks(cur._replace(poses=poses,
                                                  points=points),
                                     plan, phase)
            Q = _chunk_points(ptm_b)
            if mesh is None:
                poses_b, points_b, info = _solve_blocks(ptm_b, opts, Q)
            else:
                poses_b, points_b, info = _solve_on_mesh(
                    ptm_b, opts, Q, mesh, block_axis)
            # One transfer per phase; scatter the owned updates back (the
            # only cross-block exchange).
            poses_b, points_b, c0, c1 = fetch(
                poses_b[:len(phase)], points_b[:len(phase)],
                info["initial_cost"][:len(phase)],
                info["final_cost"][:len(phase)])
            poses = poses.copy()
            own = plan.cam_owned[phase]
            poses[plan.cam_local[phase][own]] = poses_b[own]
            pv = plan.pt_owned[phase]
            points = points.copy()
            points[plan.pt_local[phase][pv]] = points_b[pv]
            phase_s.append(time.perf_counter() - t0)
            info_out = {"sweep": sweep, "initial_cost": c0.sum(),
                        "final_cost": c1.sum(), "sp": Sp, "chunk": Q,
                        "phase_s": phase_s}
    out = prob._replace(poses=put(poses, dev), points=put(points, dev))
    return out, info_out
