"""Bundle adjustment core: robust reprojection LM with Schur-complement PCG.

Twin of ``sara_tpu/ba/core.py`` (reference: Ceres DENSE_SCHUR with
Huber(4 px), cpp/src/DO/Sara/SfM/BuildingBlocks/BundleAdjuster.cpp:162-226;
angle-axis + translation per camera, 3 per point).

- Residuals and Jacobians: the closed-form flat chain rule
  (``ba/jacobian.py``) for plain pinhole problems; ``torch.func.jacfwd``
  under ``torch.func.vmap`` for Brown-Conrady (8,) residuals and for
  optimizable intrinsics.
- Robustness: trimmed Huber via IRLS scaling of residual/Jacobian rows.
- Normal equations: Schur complement on the reduced camera system,
  matrix-free (gathers and ``index_add_`` segment sums), block-Jacobi PCG
  with a fixed iteration count, then back-substitution for the points.
- LM: accept/reject and the lambda schedule are ``torch.where`` selects,
  so nothing inside the iteration loop reads a tensor on the host.

On CUDA ``index_add_`` sums with float atomics, so the segment sums vary by
a few ulps from run to run. ``bundle_adjust`` sends plain pinhole problems
with up to ``dense_max_cameras`` cameras to the dense-Schur direct solver
(``ba/dense_schur.py``).
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from sara_tpu_torch.core import lie
from sara_tpu_torch.ops.smallmat import batched_inv
from sara_tpu_torch.utils.host import put


class BAProblem(NamedTuple):
    """Fixed-shape bundle adjustment state (tensors on one device).

    poses:      (C, 6) angle-axis + translation, world->camera.
    points:     (P, 3) scene points.
    intrinsics: (4,) shared pinhole [fx, fy, cx, cy], or (8,)
                [fx, fy, cx, cy, k1, k2, p1, p2] for a Brown-Conrady
                distortion-aware residual.
    cam_idx:    (O,) int camera of each observation.
    pt_idx:     (O,) int point of each observation.
    uv:         (O, 2) observed pixels.
    obs_mask:   (O,) bool.
    pose_fixed: (C,) bool (frozen cameras) or (C, 6) bool (frozen pose
                components).
    point_fixed:(P,) bool frozen points.
    intr_free:  optional (Ki,) bool: which intrinsics to OPTIMIZE. None
                keeps the intrinsics constant.
    """

    poses: torch.Tensor
    points: torch.Tensor
    intrinsics: torch.Tensor
    cam_idx: torch.Tensor
    pt_idx: torch.Tensor
    uv: torch.Tensor
    obs_mask: torch.Tensor
    pose_fixed: torch.Tensor
    point_fixed: torch.Tensor
    intr_free: torch.Tensor | None = None


class BAOptions(NamedTuple):
    max_iters: int = 50
    cg_iters: int = 30
    huber_delta: float = 4.0       # pixels (reference: Huber(4 px))
    outlier_cutoff: float = 6.0    # residuals > cutoff*delta get zero weight
                                   # (trimmed Huber; disable with math.inf)
    lambda_init: float = 1e-3
    lambda_up: float = 4.0
    lambda_down: float = 0.5
    lambda_min: float = 1e-9
    lambda_max: float = 1e6
    # "auto": the dense-Schur direct solver for plain pinhole problems with
    # <= dense_max_cameras cameras and bounded point-major padding; "cg":
    # the matrix-free Schur+PCG path; "dense" forces dense.
    solver: str = "auto"
    dense_max_cameras: int = 512
    dense_chunk: int = 16384
    dense_max_inflation: float = 8.0


def _segment_sum(data: torch.Tensor, idx: torch.Tensor, n: int):
    out = data.new_zeros((n,) + data.shape[1:])
    return out.index_add_(0, idx.long(), data)


def _project(intr, pose6, X):
    """Projection of world point(s) X (..., 3) through pose(s) (..., 6).

    intr is (4,) pinhole or (8,) pinhole + Brown-Conrady distortion
    ``x_d = x (1 + k1 r^2 + k2 r^4) + (r^2 I + 2 x x^T) p``. Returns
    (pixels (..., 2), depth (...))."""
    w, t = pose6[..., :3], pose6[..., 3:]
    R = lie.so3_exp(w)
    Xc = (R @ X[..., None])[..., 0] + t
    z = torch.where(Xc[..., 2].abs() < 1e-9,
                    torch.full_like(Xc[..., 2], 1e-9), Xc[..., 2])
    x = Xc[..., 0] / z
    y = Xc[..., 1] / z
    if intr.shape[0] >= 8:
        k1, k2, p1, p2 = intr[4], intr[5], intr[6], intr[7]
        r2 = x * x + y * y
        radial = 1.0 + r2 * (k1 + r2 * k2)
        tx = r2 * p1 + 2.0 * x * (x * p1 + y * p2)
        ty = r2 * p2 + 2.0 * y * (x * p1 + y * p2)
        x, y = x * radial + tx, y * radial + ty
    return torch.stack([intr[0] * x + intr[2], intr[1] * y + intr[3]],
                       dim=-1), Xc[..., 2]


def project_obs(p: BAProblem):
    """Project every observation; returns (pred (O,2), depth (O,))."""
    return _project(p.intrinsics, p.poses[p.cam_idx.long()],
                    p.points[p.pt_idx.long()])


def _residuals(p: BAProblem):
    pred, depth = project_obs(p)
    r = pred - p.uv
    return torch.where(p.obs_mask[:, None], r, torch.zeros_like(r)), depth


def _huber_weights(r, delta: float, mask, cutoff: float = math.inf):
    """sqrt IRLS weights for the (trimmed) Huber loss on the residual norm."""
    n = torch.linalg.vector_norm(r, dim=-1)
    w = torch.sqrt(torch.clamp(delta / torch.clamp(n, min=1e-12), max=1.0))
    w = torch.where(n > cutoff * delta, torch.zeros_like(w), w)
    return torch.where(mask, w, torch.zeros_like(w))


def ba_cost(p: BAProblem, huber_delta: float = 4.0,
            cutoff: float = math.inf):
    """Robust total cost (trimmed Huber on the residual norm)."""
    r, _ = _residuals(p)
    n = torch.linalg.vector_norm(r, dim=-1)
    quad = 0.5 * n * n
    lin = huber_delta * (n - 0.5 * huber_delta)
    c = torch.where(n <= huber_delta, quad, lin)
    # Plateau beyond the trim point so trimmed observations do not steer
    # accept/reject decisions.
    c = torch.clamp(c, max=huber_delta * (cutoff * huber_delta
                                          - 0.5 * huber_delta))
    return torch.sum(torch.where(p.obs_mask, c, torch.zeros_like(c)))


def _pose_free(p: BAProblem):
    """(C, 6) float mask of FREE pose components."""
    pf = p.pose_fixed
    if pf.dim() == 1:
        pf = pf[:, None].expand(pf.shape[0], 6)
    return (~pf).to(p.poses.dtype)


def _jacobians(p: BAProblem, delta: float, cutoff: float = math.inf):
    """Per-observation weighted residuals and Jacobian blocks by autodiff
    (``torch.func.jacfwd`` under ``vmap``), for Brown-Conrady (8,)
    residuals and optimizable intrinsics.

    Returns r (O, 2), Jc (O, 2, 6), Jp (O, 2, 3), Ji (O, 2, Ki) or None,
    all Huber-weighted and masked (fixed params get zero columns)."""
    from torch.func import jacfwd, vmap

    want_intr = p.intr_free is not None

    def res_one(intr, pose6, X, uv):
        pred, _ = _project(intr, pose6, X)
        return pred - uv

    poses = p.poses[p.cam_idx.long()]
    X = p.points[p.pt_idx.long()]
    in_dims = (None, 0, 0, 0)
    r = res_one(p.intrinsics, poses, X, p.uv)
    Jc = vmap(jacfwd(res_one, argnums=1), in_dims)(p.intrinsics, poses, X,
                                                   p.uv)
    Jp = vmap(jacfwd(res_one, argnums=2), in_dims)(p.intrinsics, poses, X,
                                                   p.uv)
    w = _huber_weights(r, delta, p.obs_mask, cutoff)
    r = r * w[:, None]
    Jc = Jc * w[:, None, None]
    Jp = Jp * w[:, None, None]
    cam_free = _pose_free(p)[p.cam_idx.long()]               # (O, 6)
    pt_free = (~p.point_fixed)[p.pt_idx.long()].to(r.dtype)
    Jc = Jc * cam_free[:, None, :]
    Jp = Jp * pt_free[:, None, None]
    Ji = None
    if want_intr:
        Ji = vmap(jacfwd(res_one, argnums=0), in_dims)(p.intrinsics, poses,
                                                       X, p.uv)
        Ji = Ji * w[:, None, None]
        Ji = Ji * p.intr_free.to(r.dtype)[None, None, :]
    return r, Jc, Jp, Ji


def _jacobians_closed_form(p: BAProblem, delta: float,
                           cutoff: float = math.inf):
    """Closed-form pinhole Jacobians, Huber-weighted and freeze-masked:
    r (O, 2), Jc (O, 2, 6), Jp (O, 2, 3)."""
    from sara_tpu_torch.ba.jacobian import pinhole_jacobians

    r, Jcf, Jpf = pinhole_jacobians(p.poses, p.points, p.intrinsics,
                                    p.cam_idx, p.pt_idx, p.uv)
    O = r.shape[0]
    Jc = Jcf.reshape(O, 2, 6)
    Jp = Jpf.reshape(O, 2, 3)
    w = _huber_weights(r, delta, p.obs_mask, cutoff)
    r = r * w[:, None]
    Jc = Jc * w[:, None, None]
    Jp = Jp * w[:, None, None]
    cam_free = _pose_free(p)[p.cam_idx.long()]
    pt_free = (~p.point_fixed)[p.pt_idx.long()].to(r.dtype)
    Jc = Jc * cam_free[:, None, :]
    Jp = Jp * pt_free[:, None, None]
    return r, Jc, Jp


def _identity(x):
    return x


def _gauss_newton_blocks(p: BAProblem, r, Jc, Jp, allreduce=_identity):
    """Block operators of the (undamped) normal equations: U (C, 6, 6),
    V (P, 3, 3), per-observation W (O, 6, 3), bc (C, 6), bp (P, 3).
    ``allreduce`` sums the observation sums over observation shards (see
    :func:`_lm_cg`)."""
    C = p.poses.shape[0]
    P = p.points.shape[0]
    U = allreduce(_segment_sum(torch.einsum("oia,oib->oab", Jc, Jc),
                               p.cam_idx, C))
    V = allreduce(_segment_sum(torch.einsum("oia,oib->oab", Jp, Jp),
                               p.pt_idx, P))
    Wo = torch.einsum("oia,oib->oab", Jc, Jp)
    bc = -allreduce(_segment_sum(torch.einsum("oia,oi->oa", Jc, r),
                                 p.cam_idx, C))
    bp = -allreduce(_segment_sum(torch.einsum("oia,oi->oa", Jp, r),
                                 p.pt_idx, P))
    return U, V, Wo, bc, bp


def _damp(M, lam):
    """LM damping: M + lam * diag(M) + eps I (per block)."""
    d = torch.eye(M.shape[-1], dtype=M.dtype, device=M.device)
    return M + lam * (M * d) + 1e-8 * d


def _schur_matvec(x, U_d, Vinv, Wo, cam_idx, pt_idx, C, P,
                  allreduce=_identity):
    """S x = U_d x - W V^-1 W^T x, matrix-free over observations."""
    Ux = torch.einsum("cab,cb->ca", U_d, x)
    WT_x = torch.einsum("oab,oa->ob", Wo, x[cam_idx])          # (O, 3)
    VWT_x = allreduce(_segment_sum(WT_x, pt_idx, P))            # (P, 3)
    y = torch.einsum("pab,pb->pa", Vinv, VWT_x)                 # (P, 3)
    Wy = torch.einsum("oab,ob->oa", Wo, y[pt_idx])              # (O, 6)
    return Ux - allreduce(_segment_sum(Wy, cam_idx, C))


def _tiny(x):
    return torch.where(x.abs() < 1e-20, torch.full_like(x, 1e-20), x)


def _pcg(matvec, b, Minv_blocks, iters: int):
    """Block-Jacobi preconditioned CG over (C, 6) unknowns."""
    return _pcg_tree(
        lambda d: (matvec(d[0]),), (b,),
        lambda v: (torch.einsum("cab,cb->ca", Minv_blocks, v[0]),),
        iters)[0]


def _tree_dot(a, b):
    return sum(torch.sum(x * y) for x, y in zip(a, b))


def _pcg_tree(matvec, b, precond, iters: int):
    """Preconditioned CG over a tuple of unknown tensors."""
    x = tuple(torch.zeros_like(v) for v in b)
    r = b
    z = precond(r)
    d = z
    rz = _tree_dot(r, z)
    for _ in range(iters):
        Ad = matvec(d)
        alpha = rz / _tiny(_tree_dot(d, Ad))
        x2 = tuple(u + alpha * v for u, v in zip(x, d))
        r2 = tuple(u - alpha * v for u, v in zip(r, Ad))
        z2 = precond(r2)
        rz2 = _tree_dot(r2, z2)
        beta = rz2 / _tiny(rz)
        d2 = tuple(u + beta * v for u, v in zip(z2, d))
        # Guard stagnation: if rz2 ~ 0, keep the state.
        keep = rz2 < 1e-30
        sel = lambda a, b2: tuple(torch.where(keep, u, v)        # noqa: E731
                                  for u, v in zip(a, b2))
        x, r, d, rz = sel(x, x2), sel(r, r2), sel(d, d2), torch.where(
            keep, rz, rz2)
    return x


def _solve_lm(p: BAProblem, r, Jc, Jp, Ji, lam, opts: BAOptions,
              allreduce=_identity):
    """One damped normal-equation solve.

    Returns (dpose (C,6), dpoint (P,3), dintr (Ki,) or None). With
    ``p.intr_free`` set, the shared intrinsics join the reduced camera
    system as one extra global block."""
    C = p.poses.shape[0]
    P = p.points.shape[0]
    red = allreduce
    U, V, Wo, bc, bp = _gauss_newton_blocks(p, r, Jc, Jp, red)
    U_d = _damp(U, lam)
    V_d = _damp(V, lam)
    Vinv = batched_inv(V_d)
    Uinv = batched_inv(U_d)
    cam_idx, pt_idx = p.cam_idx.long(), p.pt_idx.long()
    Vb = torch.einsum("pab,pb->pa", Vinv, bp)

    if Ji is None:
        # Classic path: cameras only in the reduced system.
        Wv = torch.einsum("oab,ob->oa", Wo, Vb[pt_idx])
        rhs = bc - red(_segment_sum(Wv, cam_idx, C))
        matvec = lambda x: _schur_matvec(x, U_d, Vinv, Wo,      # noqa: E731
                                         cam_idx, pt_idx, C, P, red)
        dc = _pcg(matvec, rhs, Uinv, opts.cg_iters)
        WTdc = torch.einsum("oab,oa->ob", Wo, dc[cam_idx])
        di = None
    else:
        Ki = p.intrinsics.shape[0]
        O = Ji.shape[0]
        Wi = torch.einsum("oia,oib->oab", Ji, Jp)              # (O, Ki, 3)
        U_ii = red(torch.einsum("oia,oib->ab", Ji, Ji))
        U_ci = red(_segment_sum(torch.einsum("oia,oib->oab", Jc, Ji),
                                cam_idx, C))                    # (C, 6, Ki)
        bi = -red(torch.einsum("oia,oi->a", Ji, r))
        U_ii_d = _damp(U_ii, lam)
        U_ii_inv = torch.linalg.inv_ex(U_ii_d)[0]

        rhs_c = bc - red(_segment_sum(
            torch.einsum("oab,ob->oa", Wo, Vb[pt_idx]), cam_idx, C))
        rhs_i = bi - red(torch.einsum("oab,ob->a", Wi, Vb[pt_idx]))

        def matvec(x):
            xc, xi = x
            tp = (torch.einsum("oab,oa->ob", Wo, xc[cam_idx])
                  + torch.einsum("oab,oa->ob", Wi, xi.expand(O, Ki)))
            yp = torch.einsum("pab,pb->pa", Vinv,
                              red(_segment_sum(tp, pt_idx, P)))
            out_c = (torch.einsum("cab,cb->ca", U_d, xc)
                     + torch.einsum("cak,k->ca", U_ci, xi)
                     - red(_segment_sum(
                         torch.einsum("oab,ob->oa", Wo, yp[pt_idx]),
                         cam_idx, C)))
            out_i = (torch.einsum("cak,ca->k", U_ci, xc)
                     + U_ii_d @ xi
                     - red(torch.einsum("oab,ob->a", Wi, yp[pt_idx])))
            return out_c, out_i

        precond = lambda v: (torch.einsum("cab,cb->ca", Uinv, v[0]),  # noqa: E731
                             U_ii_inv @ v[1])
        dc, di = _pcg_tree(matvec, (rhs_c, rhs_i), precond, opts.cg_iters)
        di = torch.where(p.intr_free, di, torch.zeros_like(di))
        WTdc = (torch.einsum("oab,oa->ob", Wo, dc[cam_idx])
                + torch.einsum("oab,oa->ob", Wi, di.expand(O, Ki)))

    # Back-substitute points: dp = V^-1 (bp - W^T dc).
    WTdc_p = red(_segment_sum(WTdc, pt_idx, P))
    dp = torch.einsum("pab,pb->pa", Vinv, bp - WTdc_p)
    dc = dc * _pose_free(p)
    dp = torch.where(p.point_fixed[:, None], torch.zeros_like(dp), dp)
    return dc, dp, di


def _empty_info(p: BAProblem, opts: BAOptions) -> dict:
    z = p.poses.new_zeros(())
    return {"initial_cost": z, "final_cost": z,
            "costs": p.poses.new_zeros((opts.max_iters,)),
            "lambda": torch.full((), opts.lambda_init, dtype=p.poses.dtype,
                                 device=p.poses.device)}


def bundle_adjust(p: BAProblem, opts: BAOptions = BAOptions()):
    """Robust LM bundle adjustment. Returns (problem, info dict).

    Dispatches to the explicit dense-Schur solver (``ba/dense_schur.py``)
    when eligible (plain pinhole, moderate camera count, bounded padding),
    else to the matrix-free Schur+PCG loop (:func:`bundle_adjust_cg`). The
    problem stays on its device; the dense path packs its point-major
    layout on the host before the LM loop."""
    if p.points.shape[0] == 0 or p.uv.shape[0] == 0:
        # Degenerate problem (nothing survived upstream filtering): no-op.
        return p, _empty_info(p, opts)
    eligible = (opts.solver in ("auto", "dense")
                and p.intr_free is None and p.intrinsics.shape[0] == 4
                and p.poses.shape[0] <= opts.dense_max_cameras)
    if eligible:
        from sara_tpu_torch.ba.dense_schur import (
            dense_eligible, dense_schur_bundle_adjust_strata,
            pack_pt_major_strata)

        strata, id_lists, stats = pack_pt_major_strata(
            p, chunk=opts.dense_chunk)
        if dense_eligible(stats, opts):
            poses, points_t, info = dense_schur_bundle_adjust_strata(
                tuple(strata), opts, tuple(stats["chunks"]))
            pts = p.points.clone()
            for ids, pnew in zip(id_lists, points_t):
                pts[put(ids, pts.device)] = pnew[:len(ids)]
            return p._replace(poses=poses, points=pts), info
    return bundle_adjust_cg(p, opts)


def bundle_adjust_cg(p: BAProblem, opts: BAOptions = BAOptions()):
    """Matrix-free Schur+PCG LM loop. Returns (problem, info dict)."""
    return _lm_cg(p, opts)


def _lm_cg(p: BAProblem, opts: BAOptions, allreduce=_identity):
    """The LM loop of :func:`bundle_adjust_cg`. ``allreduce`` sums every
    sum over observations across observation shards (identity on one
    device; ``parallel/dist_ba.py`` passes a ``torch.distributed``
    all-reduce, with cameras, points and intrinsics replicated on every
    rank): the cost, the segment sums of the normal equations and those
    inside each CG matvec, so every rank takes the same steps."""
    fast = p.intr_free is None and p.intrinsics.shape[0] == 4
    delta, cutoff = opts.huber_delta, opts.outlier_cutoff
    prob = p
    cost = allreduce(ba_cost(p, delta, cutoff))
    cost0 = cost
    lam = torch.full((), opts.lambda_init, dtype=p.poses.dtype,
                     device=p.poses.device)
    costs = []
    for _ in range(opts.max_iters):
        if fast:
            r, Jc, Jp = _jacobians_closed_form(prob, delta, cutoff)
            Ji = None
        else:
            r, Jc, Jp, Ji = _jacobians(prob, delta, cutoff)
        dc, dp, di = _solve_lm(prob, r, Jc, Jp, Ji, lam, opts, allreduce)
        cand = prob._replace(poses=prob.poses + dc,
                             points=prob.points + dp)
        if di is not None:
            cand = cand._replace(intrinsics=prob.intrinsics + di)
        new_cost = allreduce(ba_cost(cand, delta, cutoff))
        accept = new_cost < cost
        prob = prob._replace(
            poses=torch.where(accept, cand.poses, prob.poses),
            points=torch.where(accept, cand.points, prob.points),
            intrinsics=torch.where(accept, cand.intrinsics,
                                   prob.intrinsics))
        lam = torch.where(accept,
                          torch.clamp(lam * opts.lambda_down,
                                      min=opts.lambda_min),
                          torch.clamp(lam * opts.lambda_up,
                                      max=opts.lambda_max))
        cost = torch.where(accept, new_cost, cost)
        costs.append(cost)
    info = {"initial_cost": cost0, "final_cost": cost,
            "costs": (torch.stack(costs) if costs
                      else p.poses.new_zeros((0,))),
            "lambda": lam}
    return prob, info
