"""Explicit dense Schur-complement bundle adjustment (DENSE_SCHUR).

Twin of ``sara_tpu/ba/dense_schur.py`` (reference: Ceres DENSE_SCHUR in
cpp/src/DO/Sara/SfM/BuildingBlocks/BundleAdjuster.cpp:184-226), with the
same layout, packing and precision choices:

- observations live in a POINT-MAJOR PADDED layout (P, Sp): all
  observations of a point occupy one row of Sp slots (validity-masked), so
  every point-side reduction (V blocks, bp, back-substitution) is a
  reshape-sum;
- camera-side interactions go through ONE-HOT MATMULS with
  E[p,s,c] = [cam(p,s) == c]: the camera-side reductions (U blocks, bc)
  are ``E^T @ cols``;
- the reduced camera system S = U_d - W V_d^{-1} W^T is built explicitly:
  per-point dense camera-block columns D_p (6C x 3) come from a batched
  one-hot matmul, S accumulates as one contraction over (point, 3) in
  (j, c)-major packing (index j * C + c), and ONE dense solve
  (``torch.linalg.solve_ex``, nothing waits on the host) of the (6C, 6C)
  system replaces the CG loop.

Precision. For float32 problems the reference works in bfloat16 with
float32 accumulation, and so does this port, cast for cast: the per-slot
residuals and Jacobians and the one-hot E are bfloat16; ``Ucat``, the S
contraction and ``rhs_pt`` multiply bfloat16 operands and accumulate in
float32; D is accumulated in float32 and then ROUNDED to bfloat16; H is
bfloat16; V and bp are summed in float32. PyTorch has no
``preferred_element_type``, and a matmul of two bfloat16 tensors returns
bfloat16, which is not the reference's semantics. A product of two
bfloat16 numbers is exact in float32, so each such product here rounds its
operands to bfloat16 and then multiplies them as float32 tensors with TF32
off (the package pins it), which gives float32 accumulation of exact
bfloat16 products. Float64 problems cast nothing. The LM cost that decides
accept/reject stays in the problem's dtype.

The reference's chunk ``lax.scan``s are loops over the (nc, Q) reshape of
the point axis; the LM ``lax.scan`` is a loop whose accept/reject and
lambda schedule are ``torch.where`` selects (no host reads inside).
``dense_schur_bundle_adjust_sharded`` (the multi-device variant) is not
ported yet.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from sara_tpu_torch.ba.jacobian import (pinhole_jacobians_gathered,
                                        pinhole_residuals_gathered)
from sara_tpu_torch.utils.host import fetch, put


class PtMajorBA(NamedTuple):
    """Point-major padded BA problem (all tensors fixed-shape).

    poses:       (C, 6) angle-axis + translation (world->camera).
    points:      (P, 3).
    intrinsics:  (4,) [fx, fy, cx, cy].
    cam_idx:     (P, Sp) int32 camera of each observation slot.
    uv:          (P, Sp, 2) observed pixels.
    slot_mask:   (P, Sp) bool valid observation slots.
    pose_free:   (C, 6) float, 1 for FREE pose components.
    point_fixed: (P,) bool.
    """

    poses: torch.Tensor
    points: torch.Tensor
    intrinsics: torch.Tensor
    cam_idx: torch.Tensor
    uv: torch.Tensor
    slot_mask: torch.Tensor
    pose_free: torch.Tensor
    point_fixed: torch.Tensor


def _bucket(n: int, lo: int) -> int:
    b = lo
    while b < n:
        b *= 2
    return b


_HOST_FIELDS = ("points", "cam_idx", "pt_idx", "uv", "obs_mask",
                "pose_fixed", "point_fixed")


def _on_host(p):
    """``p`` with the fields the packing reads as numpy arrays, brought
    over in one transfer (``poses`` and ``intrinsics`` stay where they
    are)."""
    dev = [k for k in _HOST_FIELDS if torch.is_tensor(getattr(p, k))]
    if not dev:
        return p
    return p._replace(**dict(zip(dev, fetch(*(getattr(p, k)
                                              for k in dev)))))


def _np_dtype(t) -> np.dtype:
    return (torch.empty((), dtype=t.dtype).numpy().dtype if torch.is_tensor(t)
            else np.asarray(t).dtype)


def pack_pt_major(p, sp_min: int = 8, chunk: int = 16384):
    """Host-side conversion BAProblem -> (PtMajorBA, stats dict).

    Sorts the valid observations by point and lays them out as (P, Sp)
    padded slots, Sp = power-of-two bucket of the max observations per
    point. The packed tensors go to the device of ``p.poses``; ``poses``
    and ``intrinsics`` are passed through. Returns the packed problem and
    {"sp", "chunk", "inflation", "n_obs", "slots"}.
    """
    p = _on_host(p)
    pt, cam, uv, mask = p.pt_idx, p.cam_idx, p.uv, p.obs_mask
    P = int(p.points.shape[0])
    C = int(p.poses.shape[0])
    dev = p.poses.device

    pt_v = pt[mask]
    cam_v = cam[mask]
    uv_v = uv[mask]
    counts = np.bincount(pt_v, minlength=P)
    sp_max = int(counts.max()) if len(pt_v) else 1
    Sp = _bucket(max(sp_max, 1), sp_min)

    order = np.argsort(pt_v, kind="stable")
    pt_s = pt_v[order]
    starts = np.zeros(P, np.int64)
    starts[1:] = np.cumsum(counts)[:-1]
    slot = np.arange(len(pt_s)) - starts[pt_s]
    flat = pt_s * Sp + slot

    cam_ps = np.zeros(P * Sp, np.int32)
    uv_ps = np.zeros((P * Sp, 2), uv.dtype)
    m_ps = np.zeros(P * Sp, bool)
    cam_ps[flat] = cam_v[order]
    uv_ps[flat] = uv_v[order]
    m_ps[flat] = True

    # Pad P to a multiple of the chunk size (padded points: no slots,
    # frozen).
    Q = min(chunk, _bucket(P, 256))
    P_pad = ((P + Q - 1) // Q) * Q
    pose_fixed = np.asarray(p.pose_fixed)
    if pose_fixed.ndim == 1:
        pose_fixed = np.broadcast_to(pose_fixed[:, None], (C, 6))
    pose_free = (~pose_fixed).astype(_np_dtype(p.poses))

    def pad(a, fill=0):
        out = np.full((P_pad,) + a.shape[1:], fill, a.dtype)
        out[:P] = a
        return put(out, dev)

    ptm = PtMajorBA(
        poses=p.poses,
        points=pad(np.asarray(p.points)),
        intrinsics=p.intrinsics,
        cam_idx=pad(cam_ps.reshape(P, Sp)),
        uv=pad(uv_ps.reshape(P, Sp, 2)),
        slot_mask=pad(m_ps.reshape(P, Sp)),
        pose_free=put(pose_free, dev),
        point_fixed=pad(np.asarray(p.point_fixed), True),
    )
    O = max(int(mask.sum()), 1)
    return ptm, {"sp": Sp, "chunk": Q, "inflation": P_pad * Sp / O,
                 "n_obs": O, "slots": P_pad * Sp}


def pack_pt_major_strata(p, sp_min: int = 4, chunk: int = 16384,
                         min_stratum: int = 4096):
    """Stratified point-major packing: group points by the power-of-two
    bucket of their observation count, merging levels with fewer than
    ``min_stratum`` points upward, so padding inflation tracks
    sum_p bucket(count_p)/O instead of the max track length.

    Returns (strata list of PtMajorBA, pt_ids list, stats dict). Every
    stratum shares ``p.poses`` (the same tensor object). The problem's
    index arrays come to the host in one transfer."""
    p = _on_host(p)
    pt = p.pt_idx
    mask = p.obs_mask
    P = int(p.points.shape[0])
    counts = np.bincount(pt[mask], minlength=P)
    O = max(int(mask.sum()), 1)
    level = np.maximum(
        sp_min, 1 << np.ceil(np.log2(np.maximum(counts, 1))).astype(np.int64))
    levels = np.sort(np.unique(level))
    # Merge sparse levels upward (each stratum costs a chunk loop).
    groups = []
    pending = np.zeros(0, np.int64)
    for i, lv in enumerate(levels):
        ids = np.concatenate([pending, np.nonzero(level == lv)[0]])
        if len(ids) < min_stratum and i + 1 < len(levels):
            pending = ids
            continue
        pending = np.zeros(0, np.int64)
        groups.append((np.sort(ids), int(lv)))
    if len(groups) == 1:
        ptm, stats = pack_pt_major(p, sp_min=sp_min, chunk=chunk)
        return [ptm], [np.arange(P)], {**stats, "sps": [stats["sp"]],
                                       "chunks": [stats["chunk"]]}

    strata, id_lists, sps, chunks, slots = [], [], [], [], 0
    for ids, sp in groups:
        # Remap observation point ids into the stratum's local space;
        # foreign observations are masked out.
        local = np.full(P, 0, np.int64)
        member = np.zeros(P, bool)
        local[ids] = np.arange(len(ids))
        member[ids] = True
        sub = p._replace(points=p.points[ids],
                         point_fixed=p.point_fixed[ids],
                         pt_idx=local[pt].astype(np.int32),
                         obs_mask=mask & member[pt])
        ptm, stats = pack_pt_major(sub, sp_min=sp_min, chunk=chunk)
        strata.append(ptm)
        id_lists.append(ids)
        sps.append(stats["sp"])
        chunks.append(stats["chunk"])
        slots += stats["slots"]
    return strata, id_lists, {"sps": sps, "chunks": chunks, "slots": slots,
                              "n_obs": O, "inflation": slots / O}


def dense_eligible(stats, opts) -> bool:
    """Accept the dense path when the padded-slot inflation is bounded OR
    the whole problem is small in absolute terms."""
    return (opts.solver == "dense"
            or stats["slots"] <= max(
                opts.dense_max_inflation * stats["n_obs"], 1_000_000))


# -- chunked stages ----------------------------------------------------------


def _work_dtype(dt: torch.dtype) -> torch.dtype:
    """Bulk working dtype: bfloat16 for float32 problems, else unchanged."""
    return torch.bfloat16 if dt == torch.float32 else dt


def _acc(t: torch.Tensor, dt: torch.dtype) -> torch.Tensor:
    """An operand of an accumulate-in-``dt`` product (see the module
    docstring): bfloat16 values held exactly in ``dt``."""
    return t.to(dt)


def _slot_residual_jac(poses, points_q, intr, cam_q, uv_q, m_q,
                       point_fixed_q, delta, cutoff):
    """Residuals + Huber-weighted Jacobians for one point chunk, in
    (Q*Sp,) flat component layout, cast to the working dtype (bfloat16 for
    float32 problems). Pose-component freezing is applied by the callers
    at block level."""
    Q, Sp = cam_q.shape
    dt = poses.dtype
    pose_ps = poses[cam_q.long()]                           # (Q, Sp, 6)
    N = Q * Sp
    w = pose_ps[..., :3].reshape(N, 3)
    tt = pose_ps[..., 3:].reshape(N, 3)
    Xp = points_q[:, None, :].expand(Q, Sp, 3).reshape(N, 3)
    r, Jcf, Jpf = pinhole_jacobians_gathered(w, tt, Xp, intr,
                                             uv_q.reshape(N, 2))
    mflat = m_q.reshape(N)
    n = torch.linalg.vector_norm(r, dim=-1)
    hw = torch.sqrt(torch.clamp(delta / torch.clamp(n, min=1e-12), max=1.0))
    hw = torch.where(n > cutoff * delta, torch.zeros_like(hw), hw)
    hw = torch.where(mflat, hw, torch.zeros_like(hw)).to(dt)
    r = r * hw[:, None]
    Jcf = Jcf * hw[:, None]
    Jpf = Jpf * hw[:, None]
    ptfree = (~point_fixed_q).to(dt)
    Jpf = Jpf * ptfree.repeat_interleave(Sp)[:, None]
    wd = _work_dtype(dt)
    return r.to(wd), Jcf.to(wd), Jpf.to(wd)


def _vinv3(V, lam, dt):
    """Damped closed-form 3x3 block inverses (adjugate / det)."""
    d = torch.eye(3, dtype=dt, device=V.device)
    Vd = V + lam * V * d + 1e-8 * d
    a, b, c = Vd[:, 0, 0], Vd[:, 0, 1], Vd[:, 0, 2]
    e, f, g = Vd[:, 1, 0], Vd[:, 1, 1], Vd[:, 1, 2]
    h, i, j = Vd[:, 2, 0], Vd[:, 2, 1], Vd[:, 2, 2]
    A = f * j - g * i
    B = -(e * j - g * h)
    Cc = e * i - f * h
    det = a * A + b * B + c * Cc
    det = torch.where(det.abs() < 1e-30, torch.full_like(det, 1e-30), det)
    adj = torch.stack([
        A, -(b * j - c * i), b * g - c * f,
        B, a * j - c * h, -(a * g - c * e),
        Cc, -(a * i - b * h), a * f - b * e,
    ], dim=-1).reshape(-1, 3, 3)
    return adj / det[:, None, None]


def _point_blocks(Px, Py, rx, ry, Q, Sp, dt):
    """V (Q, 3, 3) and bp (Q, 3), summed over each point's slots in dt."""
    v9 = (Px[:, :, None] * Px[:, None, :]
          + Py[:, :, None] * Py[:, None, :]).reshape(Q, Sp, 9)
    V = v9.to(dt).sum(dim=1).reshape(Q, 3, 3)
    bp = -(Px * rx[:, None] + Py * ry[:, None]).reshape(Q, Sp, 3).to(
        dt).sum(dim=1)
    return V, bp


def _chunk_stats(poses, intr, pose_free, lam, chunk_in, delta, cutoff):
    """One chunk's contribution to the reduced camera system.

    Returns (Ucat (C, 42) [U36 | J^T r], S_pt (6C, 6C) contribution
    sum_p D V^-1 D^T, rhs_pt (C, 6) contribution sum_p D V^-1 bp)."""
    points_q, cam_q, uv_q, m_q, ptfix_q = chunk_in
    Q, Sp = cam_q.shape
    C = poses.shape[0]
    dt = poses.dtype
    r, Jcf, Jpf = _slot_residual_jac(poses, points_q, intr, cam_q, uv_q,
                                     m_q, ptfix_q, delta, cutoff)
    wd = r.dtype
    cams = torch.arange(C, dtype=cam_q.dtype, device=cam_q.device)
    E = ((cam_q[..., None] == cams) & m_q[..., None]).to(wd)  # (Q, Sp, C)
    N = Q * Sp
    Jx, Jy = Jcf[:, :6], Jcf[:, 6:]
    Px, Py = Jpf[:, :3], Jpf[:, 3:]
    rx, ry = r[:, 0], r[:, 1]
    # Camera-side columns: U blocks (36) + J^T r (6), one contraction with
    # accumulation in dt.
    u36 = (Jx[:, :, None] * Jx[:, None, :]
           + Jy[:, :, None] * Jy[:, None, :]).reshape(N, 36)
    jtr = Jx * rx[:, None] + Jy * ry[:, None]
    camcols = torch.cat([u36, jtr], dim=1)                  # (N, 42)
    Ucat = _acc(E.reshape(N, C), dt).T @ _acc(camcols, dt)
    # Pose-component freezing at block level: U -> M U M, bc -> M bc.
    ff = (pose_free[:, :, None] * pose_free[:, None, :]).reshape(C, 36)
    Ucat = Ucat * torch.cat([ff, pose_free], dim=1)
    V, bp = _point_blocks(Px, Py, rx, ry, Q, Sp, dt)
    Vinv = _vinv3(V, lam, dt)
    # W blocks per slot in K-MAJOR packing W[k*6+j] = Jc_j Jp_k, so the
    # per-point camera columns D reshape into the (rows=(q,k),
    # cols=(j,c)) operand of the S product.
    W18 = (Px[:, :, None] * Jx[:, None, :]
           + Py[:, :, None] * Jy[:, None, :]).reshape(Q, Sp, 18)
    # D accumulates in dt and is then rounded to the working dtype.
    D = torch.bmm(_acc(W18, dt).transpose(1, 2), _acc(E, dt)).to(wd)
    D = D.reshape(Q, 3, 6, C) * pose_free.T[None, None, :, :].to(wd)
    # H[q,k] = sum_l Vinv[q,k,l] D[q,l], in the working dtype.
    H = torch.sum(Vinv.to(wd)[:, :, :, None, None] * D[:, None, :, :, :],
                  dim=2)
    D2 = D.reshape(3 * Q, 6 * C)
    H2 = H.reshape(3 * Q, 6 * C)
    # The S contraction: working-dtype operands, dt accumulation. S_pt is
    # (6C, 6C) in (j, c)-major packing: index = j * C + c.
    S_pt = _acc(H2, dt).T @ _acc(D2, dt)
    y = torch.einsum("qkl,ql->qk", Vinv, bp).reshape(3 * Q).to(wd)
    rhs_pt = (_acc(D2, dt).T @ _acc(y, dt)).reshape(6, C).T  # (C, 6)
    return Ucat, S_pt, rhs_pt


def _chunk_backsub(poses, intr, pose_free, dc6, lam, chunk_in, delta,
                   cutoff):
    """Point updates dp = V^-1 (bp - W^T dc) for one chunk (recomputes the
    per-slot quantities)."""
    points_q, cam_q, uv_q, m_q, ptfix_q = chunk_in
    Q, Sp = cam_q.shape
    dt = poses.dtype
    r, Jcf, Jpf = _slot_residual_jac(poses, points_q, intr, cam_q, uv_q,
                                     m_q, ptfix_q, delta, cutoff)
    Jx, Jy = Jcf[:, :6], Jcf[:, 6:]
    Px, Py = Jpf[:, :3], Jpf[:, 3:]
    rx, ry = r[:, 0], r[:, 1]
    V, bp = _point_blocks(Px, Py, rx, ry, Q, Sp, dt)
    Vinv = _vinv3(V, lam, dt)
    W18 = (Jx[:, :, None] * Px[:, None, :]
           + Jy[:, :, None] * Py[:, None, :]).reshape(Q, Sp, 6, 3)
    wd = W18.dtype
    dcs = dc6.to(wd)[cam_q.long()] * m_q[..., None].to(wd)  # (Q, Sp, 6)
    z = torch.sum(_acc(W18, dt) * _acc(dcs, dt)[..., None], dim=(1, 2))
    dp = torch.einsum("qkl,ql->qk", Vinv, bp - z)
    return torch.where(ptfix_q[:, None], torch.zeros_like(dp), dp)


def _chunk_cost(poses, points_q, intr, cam_q, uv_q, m_q, delta, cutoff):
    """Robust (trimmed-Huber) cost of one chunk, mirroring ba_cost, in the
    problem dtype end to end (accept/reject must be exact)."""
    Q, Sp = cam_q.shape
    pose_ps = poses[cam_q.long()]
    N = Q * Sp
    w = pose_ps[..., :3].reshape(N, 3)
    tt = pose_ps[..., 3:].reshape(N, 3)
    Xp = points_q[:, None, :].expand(Q, Sp, 3).reshape(N, 3)
    r = pinhole_residuals_gathered(w, tt, Xp, intr, uv_q.reshape(N, 2))
    n = torch.linalg.vector_norm(r, dim=-1)
    quad = 0.5 * n * n
    lin = delta * (n - 0.5 * delta)
    c = torch.where(n <= delta, quad, lin)
    c = torch.clamp(c, max=delta * (cutoff * delta - 0.5 * delta))
    return torch.sum(torch.where(m_q.reshape(N), c, torch.zeros_like(c)))


def _chunked(arrs, Q):
    """Split each tensor's leading dim P_pad into its (nc, Q) chunks."""
    return list(zip(*(a.split(Q) for a in arrs)))


def ptm_cost(ptm: PtMajorBA, poses, points, delta, cutoff, Q: int):
    total = poses.new_zeros(())
    for pts_q, cam_q, uv_q, m_q in _chunked(
            (points, ptm.cam_idx, ptm.uv, ptm.slot_mask), Q):
        total = total + _chunk_cost(poses, pts_q, ptm.intrinsics, cam_q,
                                    uv_q, m_q, delta, cutoff)
    return total


def dense_schur_bundle_adjust(ptm: PtMajorBA, opts, Q: int):
    """Robust LM with an explicit dense Schur solve, with the semantics of
    ``bundle_adjust`` (accept/reject, lambda schedule, trimmed Huber).
    Returns (poses, points, info)."""
    poses, points, info = _lm_loop((ptm,), opts, (Q,))
    return poses, points[0], info


def dense_schur_bundle_adjust_strata(strata, opts, Qs):
    """Stratified dense-Schur LM: points split by observation count into a
    few (Sp, chunk) strata. Returns (poses, per-stratum points tuple,
    info)."""
    return _lm_loop(tuple(strata), opts, tuple(Qs))


def _solve_cameras(Ucat, S_pt, rhs_pt, lam, pose_free):
    """The camera step dc6 (C, 6) of the reduced system
    S = blockdiag(U_d) - S_pt, rhs = bc - rhs_pt, one dense solve in the
    (j, c)-major packing of ``S_pt`` (index j * C + c)."""
    C = Ucat.shape[0]
    dt, dev = Ucat.dtype, Ucat.device
    d6 = torch.eye(6, dtype=dt, device=dev)
    U = Ucat[:, :36].reshape(C, 6, 6)
    bc = -Ucat[:, 36:]                                       # (C, 6)
    U_d = U + lam * U * d6 + 1e-8 * d6
    S = (torch.einsum("cd,cji->jcid", torch.eye(C, dtype=dt, device=dev),
                      U_d).reshape(6 * C, 6 * C) - S_pt)
    rhs = (bc - rhs_pt).T.reshape(6 * C)
    return (torch.linalg.solve_ex(S, rhs[:, None])[0][:, 0]
            .reshape(6, C).T * pose_free)


def _lm_loop(strata, opts, Qs):
    """The LM loop over one or more point STRATA (each a PtMajorBA with its
    own Sp/chunk; poses/intrinsics/pose_free are shared)."""
    p0 = strata[0]
    C = p0.poses.shape[0]
    dt = p0.poses.dtype
    dev = p0.poses.device
    delta = opts.huber_delta
    cutoff = opts.outlier_cutoff

    def total_cost(poses, points_t):
        c = poses.new_zeros(())
        for ptm, pts, Q in zip(strata, points_t, Qs):
            c = c + ptm_cost(ptm, poses, pts, delta, cutoff, Q)
        return c

    poses = p0.poses
    points_t = tuple(ptm.points for ptm in strata)
    lam = torch.full((), opts.lambda_init, dtype=dt, device=dev)
    cost = total_cost(poses, points_t)
    cost0 = cost
    costs = []
    for _ in range(opts.max_iters):
        Ucat = torch.zeros((C, 42), dtype=dt, device=dev)
        S_pt = torch.zeros((6 * C, 6 * C), dtype=dt, device=dev)
        rhs_pt = torch.zeros((C, 6), dtype=dt, device=dev)
        chunk_sets = []
        for ptm, pts, Q in zip(strata, points_t, Qs):
            chunks = _chunked((pts, ptm.cam_idx, ptm.uv, ptm.slot_mask,
                               ptm.point_fixed), Q)
            chunk_sets.append(chunks)
            for ch in chunks:
                u, s, rh = _chunk_stats(poses, ptm.intrinsics, ptm.pose_free,
                                        lam, ch, delta, cutoff)
                Ucat += u
                S_pt += s
                rhs_pt += rh
        dc6 = _solve_cameras(Ucat, S_pt, rhs_pt, lam, p0.pose_free)

        cand_points = []
        for ptm, chunks in zip(strata, chunk_sets):
            dp = torch.cat([_chunk_backsub(poses, ptm.intrinsics,
                                           ptm.pose_free, dc6, lam, ch,
                                           delta, cutoff) for ch in chunks])
            cand_points.append(torch.cat([ch[0] for ch in chunks]) + dp)
        cand_points = tuple(cand_points)

        cand_poses = poses + dc6
        new_cost = total_cost(cand_poses, cand_points)
        accept = new_cost < cost
        poses = torch.where(accept, cand_poses, poses)
        points_t = tuple(torch.where(accept, cp, pp)
                         for cp, pp in zip(cand_points, points_t))
        lam = torch.where(accept,
                          torch.clamp(lam * opts.lambda_down,
                                      min=opts.lambda_min),
                          torch.clamp(lam * opts.lambda_up,
                                      max=opts.lambda_max))
        cost = torch.where(accept, new_cost, cost)
        costs.append(cost)
    info = {"initial_cost": cost0, "final_cost": cost,
            "costs": torch.stack(costs) if costs else cost0.new_zeros((0,)),
            "lambda": lam}
    return poses, points_t, info


class DenseSchurSession:
    """Device-resident dense-Schur BA: pack ONCE, solve repeatedly.

    ``bundle_adjust`` re-packs the point-major layout on the host on every
    call. The session keeps the packed strata on the device; ``solve``
    optionally swaps in new pose/point VALUES without touching the layout
    tensors (the persistent-problem idiom of Ceres' Problem object).

    Invariant: every stratum holds the SAME poses tensor (true after
    packing and after each solve). The points-only refresh relies on it,
    so it is asserted at construction and at every refresh.
    """

    def __init__(self, p, opts):
        self.opts = opts
        strata, id_lists, stats = pack_pt_major_strata(
            p, chunk=opts.dense_chunk)
        self.stats = stats
        self.strata = tuple(strata)
        self.Qs = tuple(stats["chunks"])
        self._P = int(p.points.shape[0])
        dev = p.poses.device
        self._ids = [put(ids.astype(np.int64), dev) for ids in id_lists]
        self._check_shared_poses()

    def _check_shared_poses(self):
        first = self.strata[0].poses
        assert all(ptm.poses is first for ptm in self.strata), \
            "DenseSchurSession: the strata no longer share one poses tensor"

    @property
    def eligible(self) -> bool:
        return dense_eligible(self.stats, self.opts)

    def solve(self, poses=None, points=None, opts=None):
        """Run the LM loop on the resident problem. ``poses`` (C, 6) and
        ``points`` (P, 3) override the resident VALUES (layout unchanged).
        Returns (poses, points (P, 3), info)."""
        opts = opts or self.opts
        if poses is not None or points is not None:
            self._check_shared_poses()
            dev = self.strata[0].poses.device
            poses_in = (torch.as_tensor(poses).to(dev) if poses is not None
                        else self.strata[0].poses)
            if points is not None:
                points = torch.as_tensor(points).to(dev)
                new = []
                for ptm, idv in zip(self.strata, self._ids):
                    pts = points[idv]
                    pad = ptm.points.shape[0] - idv.shape[0]
                    if pad:
                        pts = torch.cat([pts, pts.new_zeros((pad, 3))])
                    new.append(ptm._replace(poses=poses_in, points=pts))
                self.strata = tuple(new)
            else:
                self.strata = tuple(ptm._replace(poses=poses_in)
                                    for ptm in self.strata)
        poses_f, points_t, info = dense_schur_bundle_adjust_strata(
            self.strata, opts, self.Qs)
        # Keep the solution resident so chained solves continue from it.
        self.strata = tuple(ptm._replace(poses=poses_f, points=pts)
                            for ptm, pts in zip(self.strata, points_t))
        pts_full = points_t[0].new_zeros((self._P, 3))
        for idv, pnew in zip(self._ids, points_t):
            pts_full[idv] = pnew[:idv.shape[0]]
        return poses_f, pts_full, info
