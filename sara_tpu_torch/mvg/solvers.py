"""Direct linear minimal solvers: 8-pt / 7-pt fundamental, 4-pt homography.

Twin of ``sara_tpu/mvg/solvers.py``. Every solver takes a fixed-size
sample and returns a fixed number of candidate models with a validity
mask; a leading batch of samples (..., N, 2) gives models (..., M, 3, 3),
which takes the place of the reference's ``vmap`` over RANSAC hypotheses.
Inputs are normalized coordinates (see ``normalizer``).
"""

from __future__ import annotations

import torch

from sara_tpu_torch.core import poly
from sara_tpu_torch.ops.smallmat import det3


def _epipolar_design_rows(u: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Rows of the epipolar design matrix, v^T F u = 0 per correspondence:
    (..., N, 2) x 2 -> (..., N, 9), F vectorized row-major."""
    ux, uy = u[..., 0], u[..., 1]
    vx, vy = v[..., 0], v[..., 1]
    one = torch.ones_like(ux)
    return torch.stack(
        [vx * ux, vx * uy, vx, vy * ux, vy * uy, vy, ux, uy, one], dim=-1)


def null_vectors(A: torch.Tensor) -> torch.Tensor:
    """Right singular vectors of (..., m, n) as rows (..., n, n), smallest
    singular value last: ``Vt`` of the full SVD. For m >= n the reduced
    SVD gives the same ``Vt`` without the (m, m) left factor."""
    return torch.linalg.svd(A, full_matrices=A.shape[-2] < A.shape[-1])[2]


def _batch_mask(like: torch.Tensor, m: int) -> torch.Tensor:
    return torch.ones(like.shape[:-2] + (m,), dtype=torch.bool,
                      device=like.device)


def eight_point_fundamental(u: torch.Tensor, v: torch.Tensor):
    """8+ point linear fundamental matrix with rank-2 projection.

    Args: u, v (..., N>=8, 2) normalized correspondences.
    Returns (F (..., 1, 3, 3), valid (..., 1)).
    """
    A = _epipolar_design_rows(u, v)
    F = null_vectors(A)[..., -1, :].reshape(A.shape[:-2] + (3, 3))
    Uf, Sf, Vtf = torch.linalg.svd(F)
    S2 = torch.cat([Sf[..., :2], torch.zeros_like(Sf[..., 2:])], dim=-1)
    F = (Uf * S2[..., None, :]) @ Vtf
    return F[..., None, :, :], _batch_mask(u, 1)


def seven_point_fundamental(u: torch.Tensor, v: torch.Tensor):
    """7-point fundamental: 2-D null space + cubic det constraint.

    Returns (F (..., 3, 3, 3), valid (..., 3)): up to three real solutions.
    """
    A = _epipolar_design_rows(u, v)                          # (..., 7, 9)
    Vt = null_vectors(A)
    shape = A.shape[:-2] + (3, 3)
    F1 = Vt[..., -1, :].reshape(shape)
    F2 = Vt[..., -2, :].reshape(shape)

    # det(F2 + a (F1 - F2)) as a cubic in a, by interpolation at
    # a = 0, 1, -1, 2 (exact for degree 3).
    D = F1 - F2
    d0 = det3(F2)
    d1 = det3(F2 + D)
    dm1 = det3(F2 - D)
    d2 = det3(F2 + 2.0 * D)
    c0 = d0
    c2 = 0.5 * (d1 + dm1) - d0
    c3 = (d2 - c0 - 4.0 * c2 - d1 + dm1) / 6.0
    c1 = 0.5 * (d1 - dm1) - c3
    roots, valid = poly.roots_cubic(c3, c2, c1, c0)          # (..., 3)
    F = F2[..., None, :, :] + roots[..., None, None] * D[..., None, :, :]
    norm = torch.linalg.vector_norm(F.flatten(-2), dim=-1)
    return F / torch.clamp(norm, min=1e-12)[..., None, None], valid


def four_point_homography(u: torch.Tensor, v: torch.Tensor):
    """4+ point DLT homography (the full 2N x 9 DLT + SVD null space).

    Returns (H (..., 1, 3, 3), valid (..., 1)).
    """
    ux, uy = u[..., 0], u[..., 1]
    vx, vy = v[..., 0], v[..., 1]
    one = torch.ones_like(ux)
    zero = torch.zeros_like(ux)
    r1 = torch.stack([ux, uy, one, zero, zero, zero,
                      -vx * ux, -vx * uy, -vx], dim=-1)
    r2 = torch.stack([zero, zero, zero, ux, uy, one,
                      -vy * ux, -vy * uy, -vy], dim=-1)
    A = torch.cat([r1, r2], dim=-2)                          # (..., 2N, 9)
    H = null_vectors(A)[..., -1, :].reshape(A.shape[:-2] + (3, 3))
    h22 = H[..., 2:3, 2:3]
    H = H / torch.where(h22.abs() > 1e-12, h22, 1e-12)
    return H[..., None, :, :], _batch_mask(u, 1)
