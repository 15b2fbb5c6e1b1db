"""Pose-graph optimization (loop closure) over SE(3) and Sim(3).

Twin of ``sara_tpu/sfm/pose_graph_opt.py``. The reference has NO pose-graph
optimizer in its C++ path (rotation averaging exists only as a Python
note, reference: python/oddkiva/sara/sfm/rotation_averaging.py). Required
by BASELINE config 3 (100-frame VO with loop closure).

Levenberg-Marquardt over absolute poses with relative-pose residuals:
  r_ij = log( T_meas_ij^-1 o T_j o T_i^-1 )  in se(3) (or sim(3)),
forward-mode autodiff Jacobians (each edge touches only two poses).
Graphs up to a few hundred keyframes solve the dense (DN)^2 normal
equations directly; larger graphs use matrix-free
block-Jacobi-preconditioned CG over the per-edge products (O(E) per
iteration) — select with ``method=`` or let "auto" pick by size. The LM
loop keeps accept/reject and the damping schedule on the device
(``torch.where``), so it never waits on the host.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from sara_tpu_torch.core import lie
from sara_tpu_torch.ops.smallmat import assemble_blocks, batched_inv


class PoseGraphProblem(NamedTuple):
    """poses: (N, 6) angle-axis+t (world->camera). Edges: measured relative
    motions x_j = R_meas x_i + t_meas with weights."""

    poses: torch.Tensor        # (N, 6) SE(3) [w, t] — or (N, 7) Sim(3)
                               # [w, t, log_s] for monocular scale-drift-
                               # aware closure (rel_pose/weight rows match)
    edge_i: torch.Tensor       # (E,) int
    edge_j: torch.Tensor       # (E,) int
    rel_pose: torch.Tensor     # (E, 6) measured log(T_j T_i^-1)-style packing
    weight: torch.Tensor       # (E,) scalar information weight, or (E, 6)
                               # per-residual-component weights (rotation
                               # rows 0:3, translation rows 3:6)
    edge_mask: torch.Tensor    # (E,) bool
    pose_fixed: torch.Tensor   # (N,) bool


def _pose_to_Rt(p6):
    return lie.so3_exp(p6[..., :3]), p6[..., 3:]


def _pose_to_Rts(p7):
    return lie.so3_exp(p7[..., :3]), p7[..., 3:6], torch.exp(p7[..., 6])


def edge_residual(pose_i, pose_j, meas):
    """Per-edge tangent residual (broadcasts over leading edge dims). 6-wide
    rows are SE(3) (se(3) residual); 7-wide rows [w, t, log_s] are Sim(3) —
    the similarity group monocular loop closure needs, since an SE(3) graph
    cannot express scale drift."""
    if pose_i.shape[-1] == 7:
        Ri, ti, si = _pose_to_Rts(pose_i)
        Rj, tj, sj = _pose_to_Rts(pose_j)
        Rm, tm, sm = _pose_to_Rts(meas)
        Rrel, trel, srel = lie.sim3_compose(
            Rj, tj, sj, *lie.sim3_inverse(Ri, ti, si))
        Re, te, se_ = lie.sim3_compose(
            *lie.sim3_inverse(Rm, tm, sm), Rrel, trel, srel)
        return lie.sim3_log(Re, te, se_)
    Ri, ti = _pose_to_Rt(pose_i)
    Rj, tj = _pose_to_Rt(pose_j)
    Rm, tm = _pose_to_Rt(meas)
    # T_rel = T_j o T_i^-1 ; residual = log(T_meas^-1 o T_rel).
    Rrel, trel = lie.se3_compose(Rj, tj, *lie.se3_inverse(Ri, ti))
    Rinv, tinv = lie.se3_inverse(Rm, tm)
    Re, te = lie.se3_compose(Rinv, tinv, Rrel, trel)
    return lie.se3_log(Re, te)


def _edge_weights6(p: PoseGraphProblem):
    """(E, D) per-component weights from a scalar or vector weight field."""
    w = p.weight
    if w.dim() == 1:
        w = w[:, None].expand(w.shape[0], p.poses.shape[1])
    return w


def _edge_poses(p: PoseGraphProblem):
    return p.poses[p.edge_i.long()], p.poses[p.edge_j.long()]


def pose_graph_cost(p: PoseGraphProblem, huber_delta: float = 0.0,
                    outlier_cutoff: float = math.inf):
    """Total (optionally robust) edge cost. ``huber_delta`` > 0 applies the
    TRIMMED Huber loss per edge: linear growth past delta, plateau past
    ``outlier_cutoff * delta`` — a grossly wrong (false-loop) edge stops
    influencing the solution entirely, while a true loop edge carrying
    honest drift still pulls.

    The robust gate tests the UNWEIGHTED residual norm (measurement
    units); the information weight scales the cost multiplicatively
    (gating on the weighted norm trimmed exactly the edges marked most
    trustworthy)."""
    w = _edge_weights6(p)
    r = edge_residual(*_edge_poses(p), p.rel_pose)
    q = torch.sum(w * r * r, dim=-1)
    if huber_delta > 0:
        n = torch.sqrt(torch.clamp(torch.sum(r * r, dim=-1), min=1e-24))
        wbar = torch.sum(w, dim=-1) / w.shape[-1]
        q = torch.where(n <= huber_delta, 0.5 * q,
                        wbar * huber_delta * (n - 0.5 * huber_delta))
        q = torch.minimum(q, wbar * huber_delta
                          * (outlier_cutoff * huber_delta
                             - 0.5 * huber_delta))
    else:
        q = 0.5 * q
    return torch.sum(torch.where(p.edge_mask, q, torch.zeros_like(q)))


def _residual_jacobians(pi, pj, meas):
    """Ji, Jj (E, D, D) of :func:`edge_residual` by forward mode.

    The reference takes ``jax.jacfwd`` per edge under ``jax.vmap``. Here
    ``torch.func.vmap`` runs over a one-hot tangent basis of
    ``torch.func.jvp`` on the whole edge batch — the same forward-mode
    products, since edge e's residual depends only on its own two poses.
    The per-edge form (``vmap(jacfwd(...))``) fails in float32: PyTorch's
    forward AD gives a 0-dim tensor plus a Python float a float64 tangent
    (``lie.matrix_to_quat``'s ``1.0 + tr``, ``sim3_inverse``'s ``1.0 /
    s``), which the next matrix product rejects; with the edge axis kept
    no operand is 0-dim."""
    from torch.func import jvp, vmap

    D = pi.shape[-1]
    eye = torch.eye(D, dtype=pi.dtype, device=pi.device)
    zero = torch.zeros_like(eye)
    basis_i = torch.cat([eye, zero])[:, None, :].expand(2 * D, *pi.shape)
    basis_j = torch.cat([zero, eye])[:, None, :].expand(2 * D, *pj.shape)

    def column(ti, tj):
        return jvp(lambda a, b: edge_residual(a, b, meas), (pi, pj),
                   (ti, tj))[1]

    cols = vmap(column)(basis_i, basis_j)                 # (2D, E, D)
    return (cols[:D].permute(1, 2, 0), cols[D:].permute(1, 2, 0))


def _edge_jacobians(p: PoseGraphProblem, huber_delta: float = 0.0,
                    outlier_cutoff: float = math.inf):
    """Weighted residuals r (E, D) and Jacobian blocks Ji, Jj (E, D, D)
    (forward mode, :func:`_residual_jacobians`)."""
    w = _edge_weights6(p)
    pi, pj = _edge_poses(p)
    r = edge_residual(pi, pj, p.rel_pose)
    Ji, Jj = _residual_jacobians(pi, pj, p.rel_pose)
    sw = torch.sqrt(w) * p.edge_mask.to(r.dtype)[:, None]
    if huber_delta > 0:
        # IRLS scaling of the whole edge by the (trimmed) robust weight,
        # gated on the UNWEIGHTED residual norm (see pose_graph_cost).
        n = torch.sqrt(torch.clamp(torch.sum(r * r, dim=-1), min=1e-24))
        rw = torch.sqrt(torch.clamp(huber_delta / n, max=1.0))
        rw = torch.where(n > outlier_cutoff * huber_delta,
                         torch.zeros_like(rw), rw)
        sw = sw * rw[:, None]
    return r * sw, Ji * sw[:, :, None], Jj * sw[:, :, None]


def _free_jacobians(p: PoseGraphProblem, Ji, Jj):
    free = (~p.pose_fixed).to(Ji.dtype)
    return (Ji * free[p.edge_i.long()][:, None, None],
            Jj * free[p.edge_j.long()][:, None, None])


def _assemble_dense(p: PoseGraphProblem, r, Ji, Jj):
    """Dense H (DN, DN) and g (DN,) by scatter-add over edges (repeated
    node pairs accumulate)."""
    N, D = p.poses.shape
    Ji, Jj = _free_jacobians(p, Ji, Jj)
    ei, ej = p.edge_i.long(), p.edge_j.long()
    Hii = torch.einsum("eab,eac->ebc", Ji, Ji)
    Hjj = torch.einsum("eab,eac->ebc", Jj, Jj)
    Hij = torch.einsum("eab,eac->ebc", Ji, Jj)
    H = assemble_blocks(N, [(ei, ei, Hii), (ej, ej, Hjj), (ei, ej, Hij),
                            (ej, ei, Hij.transpose(-1, -2))])
    g = r.new_zeros((N, D))
    g.index_add_(0, ei, -torch.einsum("eab,ea->eb", Ji, r))
    g.index_add_(0, ej, -torch.einsum("eab,ea->eb", Jj, r))
    return H, g.reshape(D * N)


def _segment_sum(data, idx, n):
    return data.new_zeros((n,) + data.shape[1:]).index_add_(0, idx, data)


def _matfree_solve(p: PoseGraphProblem, r, Ji, Jj, lam, cg_iters: int):
    """CG on the damped normal equations, matrix-free over edges: each
    matvec is two (E, D, D) batched products + two segment-sums — O(E)
    memory instead of the dense (DN)^2 assemble."""
    from sara_tpu_torch.ba.core import _pcg

    N, D = p.poses.shape
    # Eliminate fixed poses from the system (zeroing dx after an unmasked
    # solve is NOT equivalent and stalls convergence).
    Ji, Jj = _free_jacobians(p, Ji, Jj)
    ei, ej = p.edge_i.long(), p.edge_j.long()
    g = (_segment_sum(-torch.einsum("eab,ea->eb", Ji, r), ei, N)
         + _segment_sum(-torch.einsum("eab,ea->eb", Jj, r), ej, N))
    # Damping needs the diagonal blocks anyway — reuse them for both the
    # LM term and the preconditioner.
    Dblk = (_segment_sum(torch.einsum("eab,eac->ebc", Ji, Ji), ei, N)
            + _segment_sum(torch.einsum("eab,eac->ebc", Jj, Jj), ej, N))
    eye = torch.eye(D, dtype=Dblk.dtype, device=Dblk.device)
    damp = lam * (Dblk * eye) + 1e-8 * eye           # (N, D, D) diag blocks
    Minv = batched_inv(Dblk + damp)

    def matvec(x):
        y = (torch.einsum("eab,eb->ea", Ji, x[ei])
             + torch.einsum("eab,eb->ea", Jj, x[ej]))
        out = (_segment_sum(torch.einsum("eab,ea->eb", Ji, y), ei, N)
               + _segment_sum(torch.einsum("eab,ea->eb", Jj, y), ej, N))
        return out + torch.einsum("nab,nb->na", damp, x)

    return _pcg(matvec, g, Minv, cg_iters)


def optimize_pose_graph(p: PoseGraphProblem, max_iters: int = 20,
                        lambda_init: float = 1e-4, method: str = "auto",
                        cg_iters: int = 50, huber_delta: float = 0.0,
                        outlier_cutoff: float = float("inf")):
    """LM on the pose graph. Returns (problem with updated poses, info).

    method: "dense" assembles the (DN)^2 normal equations (exact solve,
    fine to a few hundred keyframes); "cg" runs matrix-free preconditioned
    CG over the edge products (O(E) per iteration, scales to thousands of
    keyframes); "auto" picks dense for N <= 192.

    huber_delta > 0 makes every edge Huber-robust (IRLS) — an inconsistent
    loop edge degrades gracefully instead of dragging the trajectory."""
    N, D = p.poses.shape
    if method == "auto":
        method = "dense" if N <= 192 else "cg"
    eye = torch.eye(D * N, dtype=p.poses.dtype, device=p.poses.device)

    cost0 = pose_graph_cost(p, huber_delta, outlier_cutoff)
    cost = cost0
    lam = torch.full((), lambda_init, dtype=p.poses.dtype,
                     device=p.poses.device)
    prob = p
    for _ in range(max_iters):
        r, Ji, Jj = _edge_jacobians(prob, huber_delta, outlier_cutoff)
        if method == "dense":
            H, g = _assemble_dense(prob, r, Ji, Jj)
            diag = torch.diag(torch.diagonal(H))
            dx = torch.linalg.solve_ex(H + lam * diag + 1e-8 * eye, g)[0]
            dx = dx.reshape(N, D)
        else:
            dx = _matfree_solve(prob, r, Ji, Jj, lam, cg_iters)
        dx = torch.where(prob.pose_fixed[:, None], torch.zeros_like(dx), dx)
        cand = prob._replace(poses=prob.poses + dx)
        new_cost = pose_graph_cost(cand, huber_delta, outlier_cutoff)
        accept = new_cost < cost
        prob = prob._replace(poses=torch.where(accept, cand.poses,
                                               prob.poses))
        lam = torch.where(accept, torch.clamp(lam * 0.5, min=1e-9),
                          torch.clamp(lam * 4.0, max=1e6))
        cost = torch.where(accept, new_cost, cost)
    return prob, {"initial_cost": cost0, "final_cost": cost}


def relative_pose_to_packing(R, t):
    """Pack measured relative motion(s) (R, t) as the (..., 6) rows
    expected by PoseGraphProblem (angle-axis + t)."""
    R = torch.as_tensor(R)
    w = lie.so3_log(R)
    return torch.cat([w, torch.as_tensor(t, dtype=w.dtype).to(w.device)],
                     dim=-1)
