"""P3P absolute pose: Lambda-Twist.

Twin of ``sara_tpu/mvg/p3p.py`` (method of Persson & Nordberg, ECCV 2018):
given 3 scene points and 3 unit bearing rays, recover up to 4 camera poses,
branch-free:

  1. depth quadrics  lambda^T M_ij lambda = a_ij,
  2. one real root of the cubic det(D1 + gamma D2) = 0 (closed form),
  3. the rank-2 quadric D0 splits into two planes via symmetric ``eigh``,
  4. each plane inserted into the depth quadrics gives a quadratic in the
     plane parameter: up to 4 positive-depth solutions,
  5. pose by the exact 3-point orthonormal-frame (triad) alignment.

A leading batch of samples (..., 3, 3) is solved in one pass.
"""

from __future__ import annotations

import torch

from sara_tpu_torch.core.poly import roots_cubic_single_real, roots_quadratic
from sara_tpu_torch.ops.smallmat import cross, det3


def _quadric(b, i, j):
    """M_ij (..., 3, 3) with lambda^T M lambda = l_i^2 + l_j^2 - 2 b l_i l_j."""
    M = torch.zeros(b.shape + (3, 3), dtype=b.dtype, device=b.device)
    M[..., i, i] = 1.0
    M[..., j, j] = 1.0
    M[..., i, j] = -b
    M[..., j, i] = -b
    return M


def _normalized(x: torch.Tensor) -> torch.Tensor:
    return x / torch.clamp(torch.linalg.vector_norm(x, dim=-1, keepdim=True),
                           min=1e-12)


def _plane_basis(p: torch.Tensor):
    """Orthonormal basis (q1, q2) of the plane p^T x = 0, branch-free."""
    eye = torch.eye(3, dtype=p.dtype, device=p.device)
    e = eye[torch.argmin(p.abs(), dim=-1)]      # unit vector least along p
    q1 = _normalized(cross(p, e))
    q2 = _normalized(cross(p, q1))
    return q1, q2


def _triad_pose(Xw: torch.Tensor, Yc: torch.Tensor):
    """Exact rigid alignment from 3 correspondences (..., 3, 3): (R, t)
    with Yc ~= R Xw + t, from orthonormal frames of the point triangles."""

    def frame(P):
        e1 = _normalized(P[..., 1, :] - P[..., 0, :])
        v = P[..., 2, :] - P[..., 0, :]
        e2 = _normalized(v - torch.sum(v * e1, dim=-1, keepdim=True) * e1)
        return torch.stack([e1, e2, cross(e1, e2)], dim=-1)  # columns

    R = frame(Yc) @ frame(Xw).transpose(-1, -2)
    t = Yc[..., 0, :] - (R @ Xw[..., 0, :, None])[..., 0]
    return R, t


def _quad(a, M, b):
    """a^T M b for batched vectors (..., 3) and matrices (..., 3, 3)."""
    return torch.sum(a * (M @ b[..., None])[..., 0], dim=-1)


def p3p_lambda_twist(Xw: torch.Tensor, rays: torch.Tensor):
    """Up to 4 poses from 3 scene points and 3 unit bearing rays.

    Args:
      Xw: (..., 3, 3) scene points (world frame), one per row.
      rays: (..., 3, 3) unit bearing vectors in the camera frame.

    Returns:
      R: (..., 4, 3, 3), t: (..., 4, 3) with x_cam = R x_world + t;
      valid: (..., 4).
    """
    X0, X1, X2 = Xw.unbind(-2)
    r0, r1, r2 = rays.unbind(-2)
    a12 = torch.sum((X0 - X1) ** 2, dim=-1)
    a13 = torch.sum((X0 - X2) ** 2, dim=-1)
    a23 = torch.sum((X1 - X2) ** 2, dim=-1)
    b12 = torch.sum(r0 * r1, dim=-1)
    b13 = torch.sum(r0 * r2, dim=-1)
    b23 = torch.sum(r1 * r2, dim=-1)

    M12 = _quadric(b12, 0, 1)
    M13 = _quadric(b13, 0, 2)
    M23 = _quadric(b23, 1, 2)
    s = lambda x: x[..., None, None]                        # noqa: E731
    D1 = M12 * s(a23) - M23 * s(a12)
    D2 = M13 * s(a23) - M23 * s(a13)

    # Cubic det(D1 + g D2) = 0, coefficients by interpolation at 4 nodes.
    d0 = det3(D1)
    d1 = det3(D1 + D2)
    dm1 = det3(D1 - D2)
    d2 = det3(D1 + 2.0 * D2)
    c0 = d0
    c2 = 0.5 * (d1 + dm1) - d0
    c3 = (d2 - c0 - 4.0 * c2 - d1 + dm1) / 6.0
    c1 = 0.5 * (d1 - dm1) - c3
    gamma = roots_cubic_single_real(c3, c2, c1, c0)
    D0 = D1 + s(gamma) * D2

    # Split the rank-2 indefinite quadric into two planes via eigh.
    evals, evecs = torch.linalg.eigh(D0)                    # ascending
    sig_n = torch.clamp(-evals[..., 0], min=0.0)[..., None]
    sig_p = torch.clamp(evals[..., 2], min=0.0)[..., None]
    vn, vp = evecs[..., :, 0], evecs[..., :, 2]
    p_a = torch.sqrt(sig_p) * vp + torch.sqrt(sig_n) * vn
    p_b = torch.sqrt(sig_p) * vp - torch.sqrt(sig_n) * vn

    def solve_plane(p):
        q1, q2 = _plane_basis(p)

        # lambda = alpha q1 + beta q2; quadratics A a^2 + B ab + C b^2.
        def qform(M):
            return _quad(q1, M, q1), 2.0 * _quad(q1, M, q2), _quad(q2, M, q2)

        A1, B1, C1 = qform(M12)
        A2, B2, C2 = qform(M23)
        r = a12 / torch.clamp(a23, min=1e-12)
        # (A1 - r A2) t^2 + (B1 - r B2) t + (C1 - r C2) = 0, t = alpha/beta.
        ts, tvalid = roots_quadratic(A1 - r * A2, B1 - r * B2, C1 - r * C2)

        def depths(t, ok):
            denom = A2 * t * t + B2 * t + C2
            beta2 = a23 / torch.where(denom.abs() < 1e-12, 1e-12, denom)
            good = ok & (beta2 > 0)
            beta = torch.sqrt(torch.clamp(beta2, min=0.0))
            lam = beta[..., None] * (t[..., None] * q1 + q2)
            # Depths must be positive; flip the overall sign if needed.
            lam = lam * torch.sign(torch.sum(lam, dim=-1, keepdim=True)
                                   + 1e-12)
            return lam, good & torch.all(lam > 0, dim=-1)

        lam0, g0 = depths(ts[..., 0], tvalid[..., 0])
        lam1, g1 = depths(ts[..., 1], tvalid[..., 1])
        return torch.stack([lam0, lam1], dim=-2), torch.stack([g0, g1], -1)

    lam_a, good_a = solve_plane(p_a)
    lam_b, good_b = solve_plane(p_b)
    lam = torch.cat([lam_a, lam_b], dim=-2)                 # (..., 4, 3)
    good = torch.cat([good_a, good_b], dim=-1)              # (..., 4)

    Yc = lam[..., None] * rays[..., None, :, :]             # (..., 4, 3, 3)
    Xw4 = Xw[..., None, :, :].expand(Yc.shape)
    R, t = _triad_pose(Xw4, Yc)

    # Verify reprojection of the minimal sample itself (guards eigh noise).
    Yr = Xw4 @ R.transpose(-1, -2) + t[..., None, :]        # (..., 4, 3, 3)
    align = torch.sum(_normalized(Yr) * rays[..., None, :, :], dim=-1)
    return R, t, good & torch.all(align > 0.9999, dim=-1)
