"""Robust model estimators: H / F / E + pose / PnP.

Twin of ``sara_tpu/ransac/estimators.py``. Each estimator takes an explicit
``torch.Generator`` (on the data's device) where the reference takes a PRNG
key, runs the whole hypothesis batch through the batched solvers, and keeps
every decision (``better``, masks, success) as a tensor, so a call on the
card never waits on the host. Float32 inputs run in full float32: the
package pins TF32 off (``sara_tpu_torch/__init__.py``), which the 5-point
solver needs.
"""

from __future__ import annotations

import torch

from sara_tpu_torch.core import lie
from sara_tpu_torch.mvg.fivepoint import five_point_essential
from sara_tpu_torch.mvg.normalizer import (
    denormalize_homography, hartley_normalize, normalize_points)
from sara_tpu_torch.mvg.p3p import p3p_lambda_twist
from sara_tpu_torch.mvg.solvers import (
    _epipolar_design_rows, four_point_homography, null_vectors,
    seven_point_fundamental)
from sara_tpu_torch.mvg.two_view import (
    _homogeneous, sampson_epipolar_distance, symmetric_transfer_error,
    two_view_geometry)
from sara_tpu_torch.ops.smallmat import cross
from sara_tpu_torch.ransac.engine import ransac


def _frobenius_normalized(M: torch.Tensor) -> torch.Tensor:
    return M / torch.clamp(torch.linalg.matrix_norm(M), min=1e-12)[
        ..., None, None]


def estimate_homography(generator, u, v, mask, threshold: float = 4.0,
                        num_samples: int = 1000):
    """Robust homography from pixel correspondences (N, 2) x 2."""

    def solver(sample):
        su, sv = sample                                      # (S, 4, 2)
        un, sT = normalize_points(su)
        vn, tT = normalize_points(sv)
        Hn, valid = four_point_homography(un, vn)            # (S, 1, 3, 3)
        return denormalize_homography(Hn, sT[:, None], tT[:, None]), valid

    def residual(H, data):
        return symmetric_transfer_error(H, *data)

    return ransac(generator, (u, v), mask, solver, residual,
                  sample_size=4, num_samples=num_samples, threshold=threshold)


def estimate_fundamental(generator, u, v, mask, threshold: float = 2.0,
                         num_samples: int = 1000):
    """Robust fundamental matrix via the 7-point solver + Sampson distance."""

    def solver(sample):
        su, sv = sample                                      # (S, 7, 2)
        un, vn, Tu, Tv = hartley_normalize(su, sv)
        Fn, valid = seven_point_fundamental(un, vn)          # (S, 3, 3, 3)
        F = Tv.transpose(-1, -2)[:, None] @ Fn @ Tu[:, None]
        return _frobenius_normalized(F), valid

    def residual(F, data):
        return sampson_epipolar_distance(F, *data)

    return ransac(generator, (u, v), mask, solver, residual,
                  sample_size=7, num_samples=num_samples, threshold=threshold)


def _normalize_by(p: torch.Tensor, Ki: torch.Tensor) -> torch.Tensor:
    q = _homogeneous(p) @ Ki.T
    return q[..., :2] / q[..., 2:]


def estimate_relative_pose(generator, u, v, mask, K1, K2,
                           threshold_px: float = 4.0,
                           num_samples: int = 1000,
                           min_inliers: int = 100,
                           n_remix: int = 0):
    """Robust essential matrix + relative pose from pixel correspondences.

    Normalize by K^-1, 5-point solver, Sampson distance in normalized units
    with the pixel threshold over the mean focal length; then an IRLS refit
    of E, cheirality voting for the motion, and a Gauss-Newton polish of
    (R, t), each kept only where it does not make the fit worse.

    ``u``, ``v`` (..., N, 2) and ``mask`` (..., N) may carry leading batch
    dimensions (independent pairs, as the reference ``vmap``s them): every
    step then runs once for the whole batch and each pair keeps its own
    decisions. Returns (RansacResult over E, R (..., 3, 3), t (..., 3)).
    """
    un = _normalize_by(u, torch.linalg.inv_ex(K1)[0])
    vn = _normalize_by(v, torch.linalg.inv_ex(K2)[0])
    f_mean = 0.25 * (K1[0, 0] + K1[1, 1] + K2[0, 0] + K2[1, 1])
    thr = threshold_px / f_mean                              # 0-dim tensor

    def solver(sample):
        if n_remix > 0:
            return five_point_essential(*sample, n_remix=n_remix)
        return five_point_essential(*sample)

    def residual(E, data):
        return sampson_epipolar_distance(E, *data)

    res = ransac(generator, (un, vn), mask, solver, residual,
                 sample_size=5, num_samples=num_samples, threshold=thr,
                 min_inliers=min_inliers)

    # Local optimization: IRLS refit of E on the inliers, kept only if it
    # lowers the truncated-Sampson cost.
    E_refit = _refit_essential(un, vn, mask, res.inliers, 0.5 * thr)

    def trunc_cost(E):
        r = sampson_epipolar_distance(E, un, vn)
        return torch.sum(torch.where(mask, torch.minimum(r, thr), 0.0) ** 2,
                         dim=-1), r

    c_old, _ = trunc_cost(res.model)
    c_new, r_new = trunc_cost(E_refit)
    better = c_new < c_old
    inliers = torch.where(better[..., None], (r_new < thr) & mask,
                          res.inliers)
    model = torch.where(better[..., None, None], E_refit, res.model)

    R, t, _, _, _ = two_view_geometry(model, _homogeneous(un),
                                      _homogeneous(vn), inliers)

    # Nonlinear (R, t) polish: Gauss-Newton on the signed Sampson residual
    # over the inliers, kept only if it does not lose inliers; the returned
    # (R, t) is gated on the same flag so pose and model stay consistent.
    R_pol, t_pol = refine_relative_pose(R, t, un, vn, inliers.to(un.dtype))
    E_pol = _frobenius_normalized(_cross_mat(t_pol) @ R_pol)
    inl_pol = (sampson_epipolar_distance(E_pol, un, vn) < thr) & mask
    better = torch.sum(inl_pol, dim=-1) >= torch.sum(inliers, dim=-1)
    R = torch.where(better[..., None, None], R_pol, R)
    t = torch.where(better[..., None], t_pol, t)
    inliers = torch.where(better[..., None], inl_pol, inliers)
    res = res._replace(model=torch.where(better[..., None, None], E_pol,
                                         model),
                       inliers=inliers,
                       num_inliers=torch.sum(inliers.to(torch.int32),
                                             dim=-1))
    return res, R, t


_cross_mat = lie.skew       # [v]x, the reference's _cross_mat


def refine_relative_pose(R0, t0, un, vn, weights, iters: int = 8):
    """Gauss-Newton minimization of the weighted signed Sampson residual
    over (R, t): R = exp(w) R0, t = normalize(t0 + B s) with B an
    orthonormal basis of t0's tangent plane. Returns (R, t).

    Leading batch dimensions of (R0 (..., 3, 3), t0 (..., 3), un, vn
    (..., N, 2), weights (..., N)) are independent problems; their
    Jacobians (..., N, 5) come from five forward-mode products over the
    whole batch."""
    from torch.func import jvp, vmap

    def unit(x):
        return x / torch.clamp(torch.linalg.vector_norm(x, dim=-1,
                                                        keepdim=True),
                               min=1e-12)

    t0 = unit(t0)
    eye = torch.eye(3, dtype=t0.dtype, device=t0.device)
    a = torch.where(t0[..., :1].abs() < 0.9, eye[0], eye[1])
    b1 = unit(cross(t0, a))
    b2 = cross(t0, b1)
    B = torch.stack([b1, b2], dim=-1)                        # (..., 3, 2)
    uh, vh = _homogeneous(un), _homogeneous(vn)

    def resid(p):
        t = unit(t0 + (B @ p[..., 3:, None])[..., 0])
        E = _cross_mat(t) @ (lie.so3_exp(p[..., :3]) @ R0)
        Eu = uh @ E.transpose(-1, -2)                        # (..., N, 3)
        Etv = vh @ E
        num = torch.sum(vh * Eu, dim=-1)
        den = torch.sqrt(Eu[..., 0] ** 2 + Eu[..., 1] ** 2
                         + Etv[..., 0] ** 2 + Etv[..., 1] ** 2)
        return weights * num / torch.clamp(den, min=1e-12)

    eye5 = torch.eye(5, dtype=un.dtype, device=un.device)
    p = un.new_zeros(t0.shape[:-1] + (5,))
    basis = eye5.reshape((5,) + (1,) * (p.dim() - 1) + (5,)).expand(
        (5,) + p.shape)
    for _ in range(iters):
        r = resid(p)
        J = vmap(lambda d: jvp(resid, (p,), (d,))[1])(basis)  # (5, ..., N)
        J = torch.movedim(J, 0, -1)                           # (..., N, 5)
        Jt = J.transpose(-1, -2)
        dp = -torch.linalg.solve_ex(Jt @ J + 1e-10 * eye5,
                                    (Jt @ r[..., None]))[0][..., 0]
        p2 = p + dp
        ok = torch.sum(resid(p2) ** 2, dim=-1) < torch.sum(r ** 2, dim=-1)
        p = torch.where(ok[..., None], p2, p)
    return (lie.so3_exp(p[..., :3]) @ R0,
            unit(t0 + (B @ p[..., 3:, None])[..., 0]))


def _refit_essential(un, vn, mask, inliers, thr, iters: int = 3):
    """IRLS refit of E: weighted masked linear system + essential
    projection, with Cauchy weights on the Sampson residual (scale thr)."""
    A = _epipolar_design_rows(un, vn)                        # (..., N, 9)
    diag = torch.ones(3, dtype=A.dtype, device=A.device)
    diag[2] = 0.0

    def fit(w):
        E = null_vectors(A * w[..., None])[..., -1, :].reshape(
            A.shape[:-2] + (3, 3))
        U, _, V = torch.linalg.svd(E)
        return _frobenius_normalized((U * diag) @ V)

    E = fit(inliers.to(A.dtype))
    for _ in range(iters - 1):
        r = sampson_epipolar_distance(E, un, vn)
        w = mask.to(A.dtype) / (1.0 + (r / thr) ** 2)
        E = fit(torch.where(r < 3.0 * thr, w, 0.0))
    return E


def estimate_absolute_pose(generator, Xw, rays, uv, K, mask,
                           threshold_px: float = 5.0,
                           num_samples: int = 1000,
                           min_inliers: int = 50):
    """Robust PnP: P3P over (scene point, unit ray) pairs, scored by pixel
    reprojection + cheirality.

    Args:
      Xw: (N, 3) scene points; rays: (N, 3) unit bearing rays;
      uv: (N, 2) observed pixels; K: (3, 3) intrinsics.
    """

    def solver(sample):
        R, t, valid = p3p_lambda_twist(*sample)              # (S, 4, ...)
        return torch.cat([R, t[..., None]], dim=-1), valid   # (S, 4, 3, 4)

    def residual(Rt, data):
        dX, _ = data
        R, t = Rt[..., :3], Rt[..., 3]
        Xc = dX @ R.transpose(-1, -2) + t[..., None, :]      # (..., N, 3)
        proj = Xc @ K.T
        w = proj[..., 2:]
        pix = proj[..., :2] / torch.where(w.abs() < 1e-12, 1e-12, w)
        err = torch.linalg.vector_norm(pix - uv, dim=-1)
        return torch.where(Xc[..., 2] > 0, err, torch.inf)

    res = ransac(generator, (Xw, rays), mask, solver, residual,
                 sample_size=3, num_samples=num_samples,
                 threshold=threshold_px, min_inliers=min_inliers)
    return res, res.model[:, :3], res.model[:, 3]
