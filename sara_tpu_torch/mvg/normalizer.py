"""Hartley point normalization for linear solvers.

Twin of ``sara_tpu/mvg/normalizer.py``. Masked: padded correspondences
(mask=False) do not influence the transform. Points are (..., N, 2): the
statistics run over the point axis, so a batch of minimal samples is
normalized in one call.
"""

from __future__ import annotations

import math

import torch


def normalize_points(x: torch.Tensor, mask: torch.Tensor | None = None):
    """Hartley isotropic normalization of (..., N, 2) points.

    Returns (x_norm (..., N, 2), T (..., 3, 3)) with T mapping raw ->
    normalized homogeneous coordinates: centroid at the origin, mean
    distance sqrt(2).
    """
    if mask is None:
        w = torch.ones(x.shape[:-1], dtype=x.dtype, device=x.device)
    else:
        w = mask.to(x.dtype)
    n = torch.clamp(torch.sum(w, dim=-1), min=1.0)               # (...,)
    mean = torch.sum(x * w[..., None], dim=-2) / n[..., None]    # (..., 2)
    d = torch.linalg.vector_norm(x - mean[..., None, :], dim=-1)
    scale = math.sqrt(2.0) / torch.clamp(torch.sum(d * w, dim=-1) / n,
                                         min=1e-12)
    zero, one = torch.zeros_like(scale), torch.ones_like(scale)
    T = torch.stack([
        torch.stack([scale, zero, -scale * mean[..., 0]], dim=-1),
        torch.stack([zero, scale, -scale * mean[..., 1]], dim=-1),
        torch.stack([zero, zero, one], dim=-1),
    ], dim=-2)
    xn = (x - mean[..., None, :]) * scale[..., None, None]
    return xn, T


def hartley_normalize(u: torch.Tensor, v: torch.Tensor, mask=None):
    """Normalize both sides of a correspondence set. Returns
    (un, vn, Tu, Tv)."""
    un, Tu = normalize_points(u, mask)
    vn, Tv = normalize_points(v, mask)
    return un, vn, Tu, Tv


def denormalize_fundamental(Fn: torch.Tensor, Tu: torch.Tensor,
                            Tv: torch.Tensor):
    """F = Tv^T Fn Tu (residual v'^T F u on raw pixels)."""
    return Tv.transpose(-1, -2) @ Fn @ Tu


def denormalize_homography(Hn: torch.Tensor, Tu: torch.Tensor,
                           Tv: torch.Tensor):
    """H = Tv^-1 Hn Tu."""
    return torch.linalg.inv_ex(Tv)[0] @ Hn @ Tu
