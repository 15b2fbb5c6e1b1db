"""Differential operators: gradients, Laplacian, Hessian, structure tensor.

Twin of ``sara_tpu/image/differential.py``: central differences with
replicated borders, over whole images and any leading batch dims.
"""

from __future__ import annotations

import torch

from sara_tpu_torch.image.filtering import gaussian_blur


def _shift(image: torch.Tensor, dy: int, dx: int) -> torch.Tensor:
    """Shift with edge replication: out[y, x] = in[y+dy, x+dx] (clamped)."""
    H, W = image.shape[-2], image.shape[-1]
    ys = torch.clamp(torch.arange(H, device=image.device) + dy, 0, H - 1)
    xs = torch.clamp(torch.arange(W, device=image.device) + dx, 0, W - 1)
    return image.index_select(-2, ys).index_select(-1, xs)


def gradient(image: torch.Tensor):
    """Central-difference gradient (gx, gy), each (..., H, W)."""
    gx = 0.5 * (_shift(image, 0, 1) - _shift(image, 0, -1))
    gy = 0.5 * (_shift(image, 1, 0) - _shift(image, -1, 0))
    return gx, gy


def gradient_polar(image: torch.Tensor):
    """Gradient in polar coords (magnitude, orientation in (-pi, pi])."""
    gx, gy = gradient(image)
    return torch.sqrt(gx * gx + gy * gy), torch.atan2(gy, gx)


def laplacian(image: torch.Tensor) -> torch.Tensor:
    """5-point Laplacian."""
    return (_shift(image, 0, 1) + _shift(image, 0, -1)
            + _shift(image, 1, 0) + _shift(image, -1, 0) - 4.0 * image)


def hessian(image: torch.Tensor):
    """Per-pixel 2x2 Hessian entries (dxx, dxy, dyy)."""
    dxx = _shift(image, 0, 1) + _shift(image, 0, -1) - 2.0 * image
    dyy = _shift(image, 1, 0) + _shift(image, -1, 0) - 2.0 * image
    dxy = 0.25 * (_shift(image, 1, 1) - _shift(image, 1, -1)
                  - _shift(image, -1, 1) + _shift(image, -1, -1))
    return dxx, dxy, dyy


def second_moment_matrix(image: torch.Tensor, sigma_d: float,
                         sigma_i: float):
    """Structure tensor (mxx, mxy, myy), derivative scale sigma_d then
    integration scale sigma_i."""
    gx, gy = gradient(gaussian_blur(image, sigma_d))
    # One batched blur of the three products.
    m = gaussian_blur(torch.stack([gx * gx, gx * gy, gy * gy]), sigma_i)
    return m[0], m[1], m[2]


def harris_cornerness(image: torch.Tensor, sigma_d: float, sigma_i: float,
                      kappa: float = 0.04) -> torch.Tensor:
    """det(M) - kappa tr(M)^2 with the twin's sigma_d^4 scale
    normalization."""
    mxx, mxy, myy = second_moment_matrix(image, sigma_d, sigma_i)
    det = mxx * myy - mxy * mxy
    tr = mxx + myy
    return (sigma_d * sigma_d) ** 2 * (det - kappa * tr * tr)


def _curvature_terms(u: torch.Tensor):
    gx, gy = gradient(u)
    hxx, hxy, hyy = hessian(u)
    n2 = gx * gx + gy * gy
    num = (gx * gx * hxx + 2.0 * gx * gy * hxy + gy * gy * hyy
           - n2 * (hxx + hyy))
    return n2, num


def mean_curvature(u: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """Mean curvature of the isolines of a (H, W) scalar field, densely:
    (Du^T Hu Du - |Du|^2 tr(Hu)) / (2 |Du|^3), zero where the gradient
    vanishes (the reference's convention: minus half the classical isoline
    curvature)."""
    n2, num = _curvature_terms(u)
    return torch.where(n2 < eps, torch.zeros_like(u),
                       0.5 * num / torch.clamp(n2, min=eps) ** 1.5)


def mean_curvature_flow(u: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """Mean curvature motion (Du^T Hu Du - |Du|^2 tr Hu) / (2 |Du|^2)."""
    n2, num = _curvature_terms(u)
    return torch.where(n2 < eps, torch.zeros_like(u),
                       0.5 * num / torch.clamp(n2, min=eps))
