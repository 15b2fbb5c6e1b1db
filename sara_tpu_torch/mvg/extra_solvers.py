"""Additional minimal solvers: 2-pt absolute translation, vanishing points.

Twin of ``sara_tpu/mvg/extra_solvers.py``.
"""

from __future__ import annotations

import torch

from sara_tpu_torch.mvg.two_view import _homogeneous
from sara_tpu_torch.ops.smallmat import cross


def absolute_translation(R: torch.Tensor, Xw: torch.Tensor,
                         rays: torch.Tensor):
    """Camera translation given rotation and >= 2 point-ray correspondences.

    Solves min_t sum || (I - r r^T)(R X + t) ||^2 in closed form: each
    bearing ray r constrains t to the line through -R X along r.

    Args: R (3, 3); Xw (N, 3) scene points; rays (N, 3) unit bearings.
    Returns t (3,).
    """
    eye = torch.eye(3, dtype=R.dtype, device=R.device)
    P = eye - rays[:, :, None] * rays[:, None, :]            # (N, 3, 3)
    A = torch.sum(P, dim=0)
    b = -torch.sum((P @ (Xw @ R.T)[..., None])[..., 0], dim=0)
    return torch.linalg.solve(A + 1e-12 * eye, b)


def vanishing_point_from_lines(lines: torch.Tensor, weights=None):
    """Least-squares vanishing point of a pencil of homogeneous lines
    (N, 3), optionally weighted (N,): the smallest right singular vector
    of the stacked line matrix, homogeneous (3,)."""
    A = lines if weights is None else lines * weights[:, None]
    return torch.linalg.svd(A, full_matrices=True)[2][-1]


def line_through(p: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """Homogeneous line through two image points (batched): l = p x q."""
    return cross(_homogeneous(p), _homogeneous(q))
