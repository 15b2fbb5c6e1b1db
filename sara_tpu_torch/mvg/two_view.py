"""Two-view geometry: E -> motions, triangulation, epipolar distances.

Twin of ``sara_tpu/mvg/two_view.py``. Models broadcast over leading batch
dimensions: an error function given models (..., 3, 3) and points (N, 2)
returns (..., N), so one call scores a whole batch of RANSAC hypotheses.
"""

from __future__ import annotations

import torch

from sara_tpu_torch.ops.smallmat import cross, det3, take


def _cofactor(E: torch.Tensor) -> torch.Tensor:
    """Cofactor matrix of a 3x3 (batched): cof(E)[i,j] = dE/dE[i,j] of det."""
    return cross(E[..., [1, 2, 0], :], E[..., [2, 0, 1], :])


def _homogeneous(p: torch.Tensor) -> torch.Tensor:
    return torch.cat([p, torch.ones_like(p[..., :1])], dim=-1)


def _apply(M: torch.Tensor, ph: torch.Tensor) -> torch.Tensor:
    """Rows M @ p for models (..., 3, 3) and points (N, 3): (..., N, 3)."""
    return ph @ M.transpose(-1, -2)


def essential_to_motions(E: torch.Tensor):
    """E -> 4 candidate (R, t) motions via the SVD construction
    E = U diag(1,1,0) V^T, R in {U W V^T, U W^T V^T}, t = +/- u3.

    Returns R (..., 4, 3, 3), t (..., 4, 3).
    """
    U, _, Vt = torch.linalg.svd(E)
    U = U * det3(U)[..., None, None]
    Vt = Vt * det3(Vt)[..., None, None]
    eye = torch.eye(3, dtype=E.dtype, device=E.device)
    W = torch.stack([-eye[1], eye[0], eye[2]])   # no copy from the host
    Ra = U @ W @ Vt
    Rb = U @ W.T @ Vt
    t = U[..., :, 2]
    return (torch.stack([Ra, Ra, Rb, Rb], dim=-3),
            torch.stack([t, -t, t, -t], dim=-2))


def triangulate_linear(R: torch.Tensor, t: torch.Tensor,
                       ray1: torch.Tensor, ray2: torch.Tensor):
    """DLT triangulation of rays under motion (R, t), camera 1 at identity.

    Args:
      R, t: (..., 3, 3), (..., 3) relative motion (x2 = R x1 + t).
      ray1, ray2: (N, 3) backprojected rays (homogeneous image points).

    Returns (X (..., N, 3) in the camera-1 frame, depth1 (..., N),
    depth2 (..., N)), from the 4x4 homogeneous DLT (two rows per view).
    """
    eye = torch.eye(3, dtype=R.dtype, device=R.device).expand(R.shape)
    P1 = torch.cat([eye, torch.zeros_like(t)[..., None]], dim=-1)
    P2 = torch.cat([R, t[..., None]], dim=-1)                # (..., 3, 4)

    def rows(P, ray):
        # x cross (P X) = 0 -> two independent rows, (..., N, 4) each.
        x, y, w = ray[..., 0, None], ray[..., 1, None], ray[..., 2, None]
        P = P[..., None, :, :]
        return (x * P[..., 2, :] - w * P[..., 0, :],
                y * P[..., 2, :] - w * P[..., 1, :])

    a1, a2 = rows(P1, ray1)
    a3, a4 = rows(P2, ray2)
    A = torch.stack(torch.broadcast_tensors(a1, a2, a3, a4), dim=-2)
    Xh = torch.linalg.svd(A)[2][..., -1, :]                  # (..., N, 4)
    w = Xh[..., 3]
    w = torch.where(w.abs() < 1e-12, 1e-12, w)
    X = Xh[..., :3] / w[..., None]
    depth1 = X[..., 2]
    depth2 = (X @ R.transpose(-1, -2) + t[..., None, :])[..., 2]
    return X, depth1, depth2


def sampson_epipolar_distance(F: torch.Tensor, u: torch.Tensor,
                              v: torch.Tensor):
    """Sampson distance of correspondences under F (or E with normalized
    coordinates). F: (..., 3, 3); u, v: (N, 2). Returns (..., N), not
    squared."""
    uh, vh = _homogeneous(u), _homogeneous(v)
    Fu = _apply(F, uh)                                       # (..., N, 3)
    Ftv = vh @ F                                             # (..., N, 3)
    num = torch.sum(vh * Fu, dim=-1)
    den = Fu[..., 0] ** 2 + Fu[..., 1] ** 2 + Ftv[..., 0] ** 2 \
        + Ftv[..., 1] ** 2
    return num.abs() / torch.sqrt(torch.clamp(den, min=1e-12))


def symmetric_epipolar_distance(F: torch.Tensor, u: torch.Tensor,
                                v: torch.Tensor):
    """Symmetric point-to-epipolar-line distance."""
    uh, vh = _homogeneous(u), _homogeneous(v)
    Fu = _apply(F, uh)
    Ftv = vh @ F
    num = torch.sum(vh * Fu, dim=-1).abs()
    d1 = num / torch.sqrt(torch.clamp(Fu[..., 0] ** 2 + Fu[..., 1] ** 2,
                                      min=1e-12))
    d2 = num / torch.sqrt(torch.clamp(Ftv[..., 0] ** 2 + Ftv[..., 1] ** 2,
                                      min=1e-12))
    return 0.5 * (d1 + d2)


def symmetric_transfer_error(H: torch.Tensor, u: torch.Tensor,
                             v: torch.Tensor):
    """Symmetric homography transfer error (pixels): H (..., 3, 3),
    u, v (N, 2) -> (..., N)."""

    def transfer(M, p):
        q = _apply(M, _homogeneous(p))
        w = q[..., 2:]
        return q[..., :2] / torch.where(w.abs() < 1e-12, 1e-12, w)

    Hinv = torch.linalg.inv_ex(H)[0]
    d1 = torch.linalg.vector_norm(transfer(H, u) - v, dim=-1)
    d2 = torch.linalg.vector_norm(transfer(Hinv, v) - u, dim=-1)
    return 0.5 * (d1 + d2)


def two_view_geometry(E: torch.Tensor, ray1: torch.Tensor,
                      ray2: torch.Tensor, mask: torch.Tensor | None = None):
    """Resolve the 4-fold motion ambiguity by cheirality voting.

    Triangulates the correspondences under each of the 4 motions (one
    batch of 4) and returns the (R, t) with the most points in front of
    both cameras, its points, their cheirality and the count. ``E``
    (..., 3, 3) with rays (..., N, 3) resolves a batch of pairs at once.
    """
    if mask is None:
        mask = torch.ones(ray1.shape[:-1], dtype=torch.bool,
                          device=ray1.device)
    R4, t4 = essential_to_motions(E)
    Xs, d1, d2 = triangulate_linear(R4, t4, ray1.unsqueeze(-3),
                                    ray2.unsqueeze(-3))    # (..., 4, N, ...)
    cheirals = (d1 > 0) & (d2 > 0) & mask.unsqueeze(-2)
    counts = torch.sum(cheirals.to(torch.int32), dim=-1)
    best = torch.argmax(counts, dim=-1)
    return tuple(take(x, best) for x in (R4, t4, Xs, cheirals, counts))
