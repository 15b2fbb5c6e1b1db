"""Epipolar degeneracy (dominant plane) detection, DEGENSAC-style.

Twin of ``sara_tpu/mvg/degeneracy.py`` (Chum et al., "Two-view Geometry
Estimation Unaffected by a Dominant Plane", CVPR 2005, Eq. (4)): given an
epipolar matrix F (or E in normalized coordinates) and 3 correspondences
consistent with it, the homography of the plane through their 3-D points is

    H = A - e2 (M^-1 b)^T,   A = [e2]_x F,

and a set dominated by one plane is detected by counting how many
correspondences that H explains. Random triples come from an explicit
``torch.Generator`` where the reference takes a PRNG key.
"""

from __future__ import annotations

import torch

from sara_tpu_torch.core.lie import skew as _cross_mat
from sara_tpu_torch.mvg.two_view import _homogeneous
from sara_tpu_torch.ops.smallmat import batched_inv, cross


def epipoles(F: torch.Tensor):
    """Left/right epipoles of F (..., 3, 3): F e1 = 0, F^T e2 = 0."""
    e1 = torch.linalg.svd(F)[2][..., -1, :]
    e2 = torch.linalg.svd(F.transpose(-1, -2))[2][..., -1, :]
    return e1, e2


def homography_from_epipolar(F: torch.Tensor, x1: torch.Tensor,
                             x2: torch.Tensor) -> torch.Tensor:
    """Plane homography from F (3, 3) and 3 F-consistent correspondences
    x1, x2 (..., 3, 2). Returns H (..., 3, 3) with x2 ~ H x1 for coplanar
    points."""
    _, e2 = epipoles(F)
    A = _cross_mat(e2) @ F
    X1, X2 = _homogeneous(x1), _homogeneous(x2)              # (..., 3, 3)
    u = cross(X2, X1 @ A.T)
    vv = cross(X2, e2)
    b = torch.sum(u * vv, dim=-1) / torch.clamp(
        torch.sum(vv * vv, dim=-1), min=1e-30)               # (..., 3)
    Minv = batched_inv(X1)                                   # rows = x1_i^T
    return A - e2[:, None] * (Minv @ b[..., None])[..., None, :, 0]


def homography_transfer_error(H: torch.Tensor, x1: torch.Tensor,
                              x2: torch.Tensor) -> torch.Tensor:
    """Forward transfer error |x2 - proj(H x1)| per correspondence:
    H (..., 3, 3), x1, x2 (N, 2) -> (..., N)."""
    p = _homogeneous(x1) @ H.transpose(-1, -2)
    z = p[..., 2:3]
    z = torch.where(z.abs() < 1e-12, 1e-12, z)
    return torch.linalg.vector_norm(p[..., :2] / z - x2, dim=-1)


def dominant_plane_ratio(F: torch.Tensor, u: torch.Tensor, v: torch.Tensor,
                         inlier_mask: torch.Tensor,
                         threshold: float = 3.0,
                         n_triples: int = 8,
                         generator: torch.Generator | None = None
                         ) -> torch.Tensor:
    """Fraction of epipolar inliers explained by a single plane homography.

    Fits homographies from random F-consistent inlier triples and returns
    the best H-consistency ratio; a ratio near 1 signals a plane-degenerate
    epipolar geometry. ``generator`` (on the data's device) draws the
    triples; None means a generator seeded with 0.
    """
    if generator is None:
        generator = torch.Generator(device=u.device).manual_seed(0)
    w = inlier_mask.to(torch.float32) + 1e-9
    idx = torch.multinomial(w, n_triples * 3, replacement=True,
                            generator=generator).reshape(n_triples, 3)
    H = homography_from_epipolar(F, u[idx], v[idx])         # (T, 3, 3)
    err = homography_transfer_error(H, u, v)                # (T, N)
    ok = (err < threshold) & inlier_mask
    ratio = torch.sum(ok, dim=-1) / torch.clamp(torch.sum(inlier_mask),
                                                min=1)
    return torch.amax(ratio)
