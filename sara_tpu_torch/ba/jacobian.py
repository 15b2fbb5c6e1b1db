"""Closed-form reprojection Jacobians in flat (O,)-component form.

Twin of ``sara_tpu/ba/jacobian.py``: the same chain rule over (O,)
component vectors, packed flat in the layout the dense-Schur solver reads:

  r   (O, 2)
  Jcf (O, 12)  [i*6 + a]   d r_i / d pose_a   (w then t)
  Jpf (O, 6)   [i*3 + a]   d r_i / d X_a

Math (world->camera pose (w, t), R = exp([w]x), Xc = R X + t):
  dpi/dXc = [[fx/z, 0, -fx x/z], [0, fy/z, -fy y/z]],  x = Xc0/z, ...
  dXc/dt  = I
  dXc/dX  = R
  dXc/dw  = -R [X]x Jr(w)   (right Jacobian of SO(3):
            Jr = I - (1-cos t)/t^2 [w]x + (t - sin t)/t^3 [w]x^2)

Pinhole (4,) intrinsics only; Brown-Conrady (8,) and optimizable
intrinsics take the autodiff path of ``ba/core.py``.
"""

from __future__ import annotations

import torch


def _mat3_mul(A, B):
    """Component (O,)-wise product of two flat 3x3 matrices."""
    return tuple(
        sum(A[3 * i + k] * B[3 * k + j] for k in range(3))
        for i in range(3) for j in range(3))


def _exp_and_jr_flat(wx, wy, wz, with_jr: bool = True):
    """R = exp([w]x) and right Jacobian Jr(w) as flat component tuples
    (Jr is None without ``with_jr``; R is the same either way)."""
    t2 = wx * wx + wy * wy + wz * wz
    t = torch.sqrt(torch.clamp(t2, min=1e-24))
    small = t2 < 1e-12
    st, ct = torch.sin(t), torch.cos(t)
    A = torch.where(small, 1.0 - t2 / 6.0, st / torch.clamp(t, min=1e-24))
    B = torch.where(small, 0.5 - t2 / 24.0,
                    (1.0 - ct) / torch.clamp(t2, min=1e-24))

    def build(cA, cB):
        """I + cA [w]x + cB [w]x^2 with [w]x^2 = w w^T - t^2 I."""
        return (
            1.0 + cB * (wx * wx - t2), cA * (-wz) + cB * wx * wy,
            cA * wy + cB * wx * wz,
            cA * wz + cB * wx * wy, 1.0 + cB * (wy * wy - t2),
            cA * (-wx) + cB * wy * wz,
            cA * (-wy) + cB * wx * wz, cA * wx + cB * wy * wz,
            1.0 + cB * (wz * wz - t2),
        )

    if not with_jr:
        return build(A, B), None
    C = torch.where(small, 1.0 / 6.0 - t2 / 120.0,
                    (t - st) / torch.clamp(t2 * t, min=1e-36))
    return build(A, B), build(-B, C)


def _residual_flat(R, tt, Xp, intr, uv):
    """Residuals r (O, 2) of world points Xp through rotations R (flat
    tuple) and translations tt, with the normalized coordinates x, y and
    the inverse depth iz the Jacobians reuse."""
    X0, X1, X2 = Xp[:, 0], Xp[:, 1], Xp[:, 2]
    Xc0 = R[0] * X0 + R[1] * X1 + R[2] * X2 + tt[:, 0]
    Xc1 = R[3] * X0 + R[4] * X1 + R[5] * X2 + tt[:, 1]
    Xc2 = R[6] * X0 + R[7] * X1 + R[8] * X2 + tt[:, 2]
    z = torch.where(Xc2.abs() < 1e-9, torch.full_like(Xc2, 1e-9), Xc2)
    iz = 1.0 / z
    x = Xc0 * iz
    y = Xc1 * iz
    fx, fy, cx, cy = intr[0], intr[1], intr[2], intr[3]
    r = torch.stack([fx * x + cx - uv[:, 0], fy * y + cy - uv[:, 1]], dim=1)
    return r, x, y, iz


def pinhole_jacobians(poses, points, intr, cam_idx, pt_idx, uv):
    """Residuals + closed-form Jacobians, flat layouts only.

    Returns r (O, 2), Jcf (O, 12), Jpf (O, 6): unweighted and unmasked
    (the caller applies Huber weights and freeze masks).
    """
    cam_idx = cam_idx.long()
    w = poses[cam_idx, :3]
    tt = poses[cam_idx, 3:]
    Xp = points[pt_idx.long()]
    return pinhole_jacobians_gathered(w, tt, Xp, intr, uv)


def pinhole_residuals_gathered(w, tt, Xp, intr, uv):
    """The residuals of :func:`pinhole_jacobians_gathered` alone, the same
    values without the Jacobian work (the reference's compiler drops that
    work where only r is used; an eager caller must not launch it)."""
    R, _ = _exp_and_jr_flat(w[:, 0], w[:, 1], w[:, 2], with_jr=False)
    return _residual_flat(R, tt, Xp, intr, uv)[0]


def pinhole_jacobians_gathered(w, tt, Xp, intr, uv):
    """Same chain rule from already-gathered per-observation pose/point
    rows (w (O,3), tt (O,3), Xp (O,3))."""
    X0, X1, X2 = Xp[:, 0], Xp[:, 1], Xp[:, 2]
    R, Jr = _exp_and_jr_flat(w[:, 0], w[:, 1], w[:, 2])
    r, x, y, iz = _residual_flat(R, tt, Xp, intr, uv)
    fx, fy = intr[0], intr[1]

    # dpi/dXc rows: row0 = fx iz (e0 - x e2), row1 = fy iz (e1 - y e2).
    a0 = fx * iz
    a2 = -fx * x * iz
    b1 = fy * iz
    b2 = -fy * y * iz

    # Jp rows: dpi . R  (Jp[i, a] = dpi[i, :] . R[:, a]).
    Jp0 = [a0 * R[0 + a] + a2 * R[6 + a] for a in range(3)]
    Jp1 = [b1 * R[3 + a] + b2 * R[6 + a] for a in range(3)]

    # M = [X]x Jr   (M_{ik} = (eps_{ijm} X_m) Jr_{jk}).
    M = (
        X1 * Jr[6] - X2 * Jr[3], X1 * Jr[7] - X2 * Jr[4],
        X1 * Jr[8] - X2 * Jr[5],
        X2 * Jr[0] - X0 * Jr[6], X2 * Jr[1] - X0 * Jr[7],
        X2 * Jr[2] - X0 * Jr[8],
        X0 * Jr[3] - X1 * Jr[0], X0 * Jr[4] - X1 * Jr[1],
        X0 * Jr[5] - X1 * Jr[2],
    )
    # dXc/dw = -R M.
    G = tuple(-g for g in _mat3_mul(R, M))
    # Jw rows: dpi . G.
    Jw0 = [a0 * G[0 + a] + a2 * G[6 + a] for a in range(3)]
    Jw1 = [b1 * G[3 + a] + b2 * G[6 + a] for a in range(3)]

    # Pack flat: Jcf [i*6 + a] with pose layout (w0 w1 w2 t0 t1 t2);
    # dXc/dt = I so the t-columns are the dpi rows themselves.
    zeros = torch.zeros_like(a0)
    Jcf = torch.stack(Jw0 + [a0, zeros, a2] + Jw1 + [zeros, b1, b2], dim=1)
    Jpf = torch.stack(Jp0 + Jp1, dim=1)
    return r, Jcf, Jpf
