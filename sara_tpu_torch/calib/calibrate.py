"""Pinhole and omnidirectional camera calibration from planar views.

Twin of ``sara_tpu/calib/calibrate.py``: Zhang's closed-form intrinsics
from homographies and a pose per view from its homography (host, float64
NumPy), then one Levenberg-Marquardt program over [fx fy cx cy k1 k2 p1
p2] (or the unified model's [fx fy cx cy k1 k2 xi]) plus every view's
pose, with forward-mode Jacobians (``torch.func.jacfwd``) and a dense
normal-equation solve. The LM runs on ``device`` (None = the card) without
a host sync: each step's accept / reject is a ``torch.where``, and the
result comes back in one transfer.

Dtype rule: the LM runs in the dtype of ``img_points``: float64 points give
a float64 LM, any other input a float32 one. The twin runs its LM in float32
in production (it never enables x64) and in float64 under its tests.
"""

from __future__ import annotations

import numpy as np
import torch

from sara_tpu_torch import resolve_device
from sara_tpu_torch.core import lie
from sara_tpu_torch.utils.host import fetch, put


def _homography(obj_xy: np.ndarray, img_xy: np.ndarray) -> np.ndarray:
    """DLT homography object plane (z=0) -> image, host-side f64."""
    A = []
    for (X, Y), (u, v) in zip(obj_xy, img_xy):
        A.append([X, Y, 1, 0, 0, 0, -u * X, -u * Y, -u])
        A.append([0, 0, 0, X, Y, 1, -v * X, -v * Y, -v])
    _, _, Vt = np.linalg.svd(np.asarray(A))
    H = Vt[-1].reshape(3, 3)
    return H / H[2, 2]


def zhang_init_intrinsics(obj_points: np.ndarray, img_points: np.ndarray):
    """Closed-form K from >= 3 planar views (Zhang 2000).

    Args:
      obj_points: (V, N, 2) planar model points (z = 0).
      img_points: (V, N, 2) detected pixels.

    Returns (K (3,3), homographies (V, 3, 3)).
    """
    V = len(obj_points)
    Hs = [_homography(obj_points[v], img_points[v]) for v in range(V)]

    def vij(H, i, j):
        return np.array([
            H[0, i] * H[0, j],
            H[0, i] * H[1, j] + H[1, i] * H[0, j],
            H[1, i] * H[1, j],
            H[2, i] * H[0, j] + H[0, i] * H[2, j],
            H[2, i] * H[1, j] + H[1, i] * H[2, j],
            H[2, i] * H[2, j],
        ])

    rows = []
    for H in Hs:
        rows.append(vij(H, 0, 1))
        rows.append(vij(H, 0, 0) - vij(H, 1, 1))
    _, _, Vt = np.linalg.svd(np.stack(rows))
    B11, B12, B22, B13, B23, B33 = Vt[-1]
    v0 = (B12 * B13 - B11 * B23) / (B11 * B22 - B12 ** 2)
    lam = B33 - (B13 ** 2 + v0 * (B12 * B13 - B11 * B23)) / B11
    alpha = np.sqrt(abs(lam / B11))
    beta = np.sqrt(abs(lam * B11 / (B11 * B22 - B12 ** 2)))
    gamma = -B12 * alpha ** 2 * beta / lam
    u0 = gamma * v0 / beta - B13 * alpha ** 2 / lam
    K = np.array([[alpha, gamma, u0], [0, beta, v0], [0, 0, 1.0]])
    return K, np.stack(Hs)


def homography_pose(K: np.ndarray, H: np.ndarray):
    """Pose (R, t) of a planar view from its homography: H ~ K [r1 r2 t]."""
    M = np.linalg.inv(K) @ H
    s = 1.0 / np.linalg.norm(M[:, 0])
    # Cheirality: t_z > 0 for a visible plane.
    if M[2, 2] * s < 0:
        s = -s
    r1 = s * M[:, 0]
    r2 = s * M[:, 1]
    t = s * M[:, 2]
    R = np.stack([r1, r2, np.cross(r1, r2)], axis=1)
    U, _, Vt = np.linalg.svd(R)
    R = U @ Vt
    if np.linalg.det(R) < 0:
        R = U @ np.diag([1, 1, -1.0]) @ Vt
    return R, t


def _camera_points(pose6: torch.Tensor, Xw: torch.Tensor) -> torch.Tensor:
    """(V, N, 3) camera-frame points of (V, N, 3) world points under (V, 6)
    angle-axis + translation poses."""
    R = lie.so3_exp(pose6[:, :3])                              # (V, 3, 3)
    return torch.einsum("vij,vnj->vni", R, Xw) + pose6[:, None, 3:]


def _project_bc(intr, pose6, Xw):
    """Project (V, N, 3) points with Brown-Conrady distortion [fx fy cx cy
    k1 k2 p1 p2]; (V, N, 2) pixels. The twin projects one point; this
    takes every view and point at once."""
    Xc = _camera_points(pose6, Xw)
    x = Xc[..., 0] / Xc[..., 2]
    y = Xc[..., 1] / Xc[..., 2]
    r2 = x * x + y * y
    radial = 1.0 + intr[4] * r2 + intr[5] * r2 * r2
    p1, p2 = intr[6], intr[7]
    xd = x * radial + r2 * p1 + 2 * x * (x * p1 + y * p2)
    yd = y * radial + r2 * p2 + 2 * y * (x * p1 + y * p2)
    return torch.stack([intr[0] * xd + intr[2], intr[1] * yd + intr[3]], -1)


def _project_omni(intr, pose6, Xw):
    """Unified-mirror projection [fx fy cx cy k1 k2 xi] of (V, N, 3)
    points; (V, N, 2) pixels."""
    Xc = _camera_points(pose6, Xw)
    Xs = Xc / torch.linalg.vector_norm(Xc, dim=-1, keepdim=True)
    denom = Xs[..., 2] + intr[6]
    x = Xs[..., 0] / denom
    y = Xs[..., 1] / denom
    r2 = x * x + y * y
    radial = 1.0 + intr[4] * r2 + intr[5] * r2 * r2
    return torch.stack([intr[0] * x * radial + intr[2],
                        intr[1] * y * radial + intr[3]], -1)


def _lm(project, n_intr, intr0, poses0, obj_xyz, img_xy, iters, free):
    """The twin's LM scan: ``iters`` damped Gauss-Newton steps over theta =
    [intrinsics, poses], each accepted where it lowers the cost (lambda
    halves) and rejected otherwise (lambda quadruples). ``free`` masks the
    frozen parameters out of J and the step. No host sync."""
    V, N, _ = obj_xyz.shape

    def residuals(theta):
        pred = project(theta[:n_intr], theta[n_intr:].reshape(V, 6), obj_xyz)
        return (pred - img_xy).reshape(-1)

    theta = torch.cat([intr0, poses0.reshape(-1)])
    n_par = theta.shape[0]
    eye = torch.eye(n_par, dtype=theta.dtype, device=theta.device)
    lam = torch.tensor(1e-3, dtype=theta.dtype, device=theta.device)
    cost = torch.sum(residuals(theta) ** 2)
    for _ in range(iters):
        r = residuals(theta)
        J = torch.func.jacfwd(residuals)(theta) * free[None, :]
        H = J.T @ J
        g = -J.T @ r
        dtheta = torch.linalg.solve(
            H + lam * torch.diag(torch.diag(H)) + 1e-9 * eye, g)
        cand = theta + torch.where(free, dtheta, torch.zeros_like(dtheta))
        new_cost = torch.sum(residuals(cand) ** 2)
        accept = new_cost < cost
        theta = torch.where(accept, cand, theta)
        lam = torch.where(accept, torch.clamp(lam * 0.5, min=1e-10),
                          torch.clamp(lam * 4.0, max=1e8))
        cost = torch.where(accept, new_cost, cost)
    return (theta[:n_intr], theta[n_intr:].reshape(V, 6),
            torch.sqrt(cost / (V * N)))


def _refine(intr0, poses0, obj_xyz, img_xy, iters: int = 30,
            fix_distortion: bool = False):
    """Joint LM over intrinsics + poses. obj_xyz: (V, N, 3); img: (V, N, 2);
    tensors on one device and of one dtype. Returns (intr (8,), poses (V,
    6), rms) as tensors."""
    free = torch.ones(intr0.shape[0] + poses0.numel(), dtype=torch.bool,
                      device=intr0.device)
    if fix_distortion:
        free[4:8] = False
    return _lm(_project_bc, 8, intr0, poses0, obj_xyz, img_xy, iters, free)


def _refine_omni(intr0, poses0, obj_xyz, img_xy, iters: int = 40):
    """Joint LM over omnidirectional intrinsics [fx fy cx cy k1 k2 xi] and
    view poses."""
    free = torch.ones(intr0.shape[0] + poses0.numel(), dtype=torch.bool,
                      device=intr0.device)
    return _lm(_project_omni, 7, intr0, poses0, obj_xyz, img_xy, iters, free)


def _lm_inputs(obj_points, img_points, device):
    """Zhang's K, the poses from the homographies, and the LM's device
    tensors (obj_xyz, img_xy, poses0) in the input's dtype (float64 stays
    float64, anything else is float32)."""
    img_points = np.asarray(img_points)
    dtype = np.float64 if img_points.dtype == np.float64 else np.float32
    K0, Hs = zhang_init_intrinsics(obj_points, img_points)
    poses0 = []
    for v in range(len(obj_points)):
        R, t = homography_pose(K0, Hs[v])
        w = lie.so3_log(torch.from_numpy(R)).numpy()
        poses0.append(np.concatenate([w, t]))
    obj_xyz = np.concatenate([obj_points,
                              np.zeros_like(obj_points[..., :1])], axis=-1)
    dev = resolve_device(device)
    on = lambda a: put(np.asarray(a, dtype), dev)          # noqa: E731
    return K0, on(obj_xyz), on(img_points), on(np.stack(poses0)), on


def calibrate_omnidirectional(obj_points: np.ndarray, img_points: np.ndarray,
                              iters: int = 60,
                              xi0_candidates=(0.2, 0.5, 0.8, 1.1),
                              device: str | torch.device | None = None):
    """Omnidirectional (unified mirror) calibration: pinhole Zhang init +
    joint LM over [fx fy cx cy k1 k2 xi] and poses, multi-started over the
    mirror parameter (the (f, xi) pair has local minima; narrow-FOV targets
    leave xi unobservable). Every start runs on ``device`` (None = the
    card); their results come back in one transfer."""
    K0, obj, img, poses0, on = _lm_inputs(obj_points, img_points, device)
    runs = []
    for xi0 in xi0_candidates:
        # The mirror parameter rescales the apparent focal ~ (1 + xi).
        intr0 = on([K0[0, 0] * (1 + xi0), K0[1, 1] * (1 + xi0),
                    K0[0, 2], K0[1, 2], 0.0, 0.0, xi0])
        runs.extend(_refine_omni(intr0, poses0, obj, img, iters=iters))
    host = fetch(*runs)
    best = None
    for k in range(len(xi0_candidates)):
        intr, poses, rms = host[3 * k:3 * k + 3]
        if best is None or float(rms) < best[2]:
            best = (intr, poses, float(rms))
    intr, poses, rms = best
    K = np.array([[intr[0], 0, intr[2]], [0, intr[1], intr[3]], [0, 0, 1.0]])
    return {"K": K, "dist": intr[4:6], "xi": float(intr[6]),
            "poses": poses, "rms": rms}


def calibrate_pinhole(obj_points: np.ndarray, img_points: np.ndarray,
                      iters: int = 30, fix_distortion: bool = False,
                      device: str | torch.device | None = None):
    """Full calibration: Zhang init + joint LM refinement on ``device``
    (None = the card; raises without one), in the dtype rule of the
    module docstring.

    Args:
      obj_points: (V, N, 2) planar model points (e.g. chessboard corners in
        square-size units).
      img_points: (V, N, 2) detected pixels.

    Returns dict with K (3,3), dist (4,) [k1 k2 p1 p2], poses (V, 6), rms.
    """
    K0, obj, img, poses0, on = _lm_inputs(obj_points, img_points, device)
    intr0 = on([K0[0, 0], K0[1, 1], K0[0, 2], K0[1, 2], 0.0, 0.0, 0.0, 0.0])
    intr, poses, rms = fetch(*_refine(intr0, poses0, obj, img, iters=iters,
                                      fix_distortion=fix_distortion))
    K = np.array([[intr[0], 0, intr[2]], [0, intr[1], intr[3]], [0, 0, 1.0]])
    return {"K": K, "dist": intr[4:8], "poses": poses, "rms": float(rms)}
