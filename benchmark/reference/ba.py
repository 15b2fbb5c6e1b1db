"""Plain Levenberg-Marquardt bundle adjustment: the reference for the
port's ``bundle_adjust`` on the benchmark's problems.

Float64 throughout, with the semantics the port documents for its solver:
angle-axis + translation per camera (world to camera), updated additively,
3 coordinates per point, one shared pinhole row [fx, fy, cx, cy]; the
trimmed Huber loss on the residual norm (delta 4 px, cut at 6 delta) by
square-root IRLS weights; Jacobians by forward-mode autodiff
(``torch.func``); the normal equations reduced to the cameras by an
explicit Schur complement built from each point's own observing cameras;
damping M + lambda diag(M) + 1e-8 I on each camera and point block; one
Cholesky solve over the free cameras; accept a step when the cost falls,
lambda x 0.5 (floor 1e-9) on accept and x 4 (cap 1e6) on reject.

``low=True`` rounds the residuals and Jacobians to TF32's 10-bit mantissa
(to nearest, ties away, as the tensor cores' input conversion) before the
normal equations are formed; the products then accumulate in float64.
That is the control the benchmark's comparison has to reject for a
float32 configuration with TF32 off.
"""

from __future__ import annotations

import torch


def _so3_exp(w):
    """Rotation matrices (..., 3, 3) of angle-axis vectors w (..., 3)."""
    t2 = (w * w).sum(-1)
    small = t2 < 1e-12
    t = torch.sqrt(torch.where(small, torch.ones_like(t2), t2))
    a = torch.where(small, 1.0 - t2 / 6.0, torch.sin(t) / t)
    b = torch.where(small, 0.5 - t2 / 24.0, (1.0 - torch.cos(t)) / (t * t))
    z = torch.zeros_like(w[..., 0])
    K = torch.stack([z, -w[..., 2], w[..., 1], w[..., 2], z, -w[..., 0],
                     -w[..., 1], w[..., 0], z], -1).reshape(w.shape + (3,))
    eye = torch.eye(3, dtype=w.dtype, device=w.device)
    return eye + a[..., None, None] * K + b[..., None, None] * (K @ K)


def _project_one(pose, X, intr):
    R = _so3_exp(pose[:3])
    Xc = R @ X + pose[3:]
    z = torch.where(Xc[2].abs() < 1e-9, torch.full_like(Xc[2], 1e-9), Xc[2])
    return torch.stack([intr[0] * Xc[0] / z + intr[2],
                        intr[1] * Xc[1] / z + intr[3]])


def residuals(poses, points, intr, cam, pt, uv):
    return torch.vmap(_project_one, in_dims=(0, 0, None))(
        poses[cam], points[pt], intr) - uv


def cost(poses, points, intr, cam, pt, uv, delta=4.0, cutoff=6.0):
    """Trimmed Huber cost, summed in float64."""
    n = torch.linalg.vector_norm(
        residuals(poses.double(), points.double(), intr.double(), cam, pt,
                  uv.double()), dim=-1)
    c = torch.where(n <= delta, 0.5 * n * n, delta * (n - 0.5 * delta))
    return torch.clamp(c, max=delta * (cutoff * delta - 0.5 * delta)).sum()


def tf32(t):
    """``t`` rounded to TF32: float32 with a 10-bit mantissa."""
    bits = t.float().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32).to(t.dtype)


def _pairs(pt, P):
    """All ordered pairs (o1, o2) of observations of one point."""
    order = torch.argsort(pt, stable=True)
    n = torch.bincount(pt, minlength=P)
    start = torch.cumsum(n, 0) - n
    # For every observation o1 (in point order), its point's n_p partners.
    reps = n[pt[order]]
    o1 = torch.repeat_interleave(order, reps)
    first = torch.repeat_interleave(start[pt[order]], reps)
    offs = torch.arange(o1.shape[0], device=pt.device) - torch.repeat_interleave(
        torch.cumsum(reps, 0) - reps, reps)
    return o1, order[first + offs]


PAIR_BLOCK = 1 << 21     # observation pairs per block of the S build


def solve(poses, points, intr, cam, pt, uv, cam_fixed, iters: int,
          delta=4.0, cutoff=6.0, lam=1e-3, low=False):
    """``iters`` LM iterations from (poses (C, 6), points (P, 3)); returns
    (poses, points, costs) in float64, ``costs`` the cost after each
    iteration."""
    dev = poses.device
    f64 = torch.float64
    poses, points, intr, uv = (a.to(f64) for a in (poses, points, intr, uv))
    cam, pt = cam.long(), pt.long()
    C, P = poses.shape[0], points.shape[0]
    free = ~cam_fixed
    o1, o2 = _pairs(pt, P)
    key = cam[o1] * C + cam[o2]
    jac = torch.vmap(torch.func.jacfwd(_project_one, argnums=(0, 1)),
                     in_dims=(0, 0, None))
    eye6 = torch.eye(6, dtype=f64, device=dev)
    eye3 = torch.eye(3, dtype=f64, device=dev)
    cur = cost(poses, points, intr, cam, pt, uv, delta, cutoff)
    costs = []
    for _ in range(iters):
        r = residuals(poses, points, intr, cam, pt, uv)
        Jc, Jp = jac(poses[cam], points[pt], intr)
        n = torch.linalg.vector_norm(r, dim=-1)
        w = torch.sqrt(torch.clamp(delta / n.clamp(min=1e-12), max=1.0))
        w = torch.where(n > cutoff * delta, torch.zeros_like(w), w)[:, None]
        r, Jc, Jp = r * w, Jc * w[..., None], Jp * w[..., None]
        if low:
            r, Jc, Jp = tf32(r), tf32(Jc), tf32(Jp)
        Jc = Jc * free[cam].to(f64)[:, None, None]
        U = torch.zeros((C, 6, 6), dtype=f64, device=dev).index_add_(
            0, cam, Jc.transpose(1, 2) @ Jc)
        V = torch.zeros((P, 3, 3), dtype=f64, device=dev).index_add_(
            0, pt, Jp.transpose(1, 2) @ Jp)
        W = Jc.transpose(1, 2) @ Jp                          # (O, 6, 3)
        bc = -torch.zeros((C, 6), dtype=f64, device=dev).index_add_(
            0, cam, (Jc.transpose(1, 2) @ r[..., None])[..., 0])
        bp = -torch.zeros((P, 3), dtype=f64, device=dev).index_add_(
            0, pt, (Jp.transpose(1, 2) @ r[..., None])[..., 0])
        Ud = U + lam * U * eye6 + 1e-8 * eye6
        Vinv = torch.linalg.inv(V + lam * V * eye3 + 1e-8 * eye3)
        H = Vinv[pt] @ W.transpose(1, 2)                     # (O, 3, 6)
        S = torch.zeros((C * C, 6, 6), dtype=f64, device=dev)
        for a in range(0, o1.shape[0], PAIR_BLOCK):
            sl = slice(a, a + PAIR_BLOCK)
            S.index_add_(0, key[sl], W[o1[sl]] @ H[o2[sl]])
        S = -S.view(C, C, 6, 6)
        S[torch.arange(C), torch.arange(C)] += Ud
        S = S.permute(0, 2, 1, 3).reshape(6 * C, 6 * C)
        rhs = bc - torch.zeros((C, 6), dtype=f64, device=dev).index_add_(
            0, cam, (W @ (Vinv[pt] @ bp[pt][..., None]))[..., 0])
        idx = torch.nonzero(free.repeat_interleave(6)).view(-1)
        dc = torch.zeros(6 * C, dtype=f64, device=dev)
        Lc = torch.linalg.cholesky(S[idx][:, idx])
        dc[idx] = torch.cholesky_solve(rhs.reshape(-1)[idx, None], Lc)[:, 0]
        dc = dc.view(C, 6)
        z = torch.zeros((P, 3), dtype=f64, device=dev).index_add_(
            0, pt, (W.transpose(1, 2) @ dc[cam][..., None])[..., 0])
        dp = (Vinv @ (bp - z)[..., None])[..., 0]
        cand_poses, cand_points = poses + dc, points + dp
        new = cost(cand_poses, cand_points, intr, cam, pt, uv, delta, cutoff)
        if bool(new < cur):
            poses, points, cur = cand_poses, cand_points, new
            lam = max(lam * 0.5, 1e-9)
        else:
            lam = min(lam * 4.0, 1e6)
        costs.append(float(cur))
    return poses, points, costs
