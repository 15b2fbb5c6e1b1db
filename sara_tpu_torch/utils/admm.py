"""Generic ADMM for consensus-form convex problems (twin of
``sara_tpu/utils/admm.py``). Solves

    min f(x) + g(z)   s.t.  A x + B z = c

by scaled-form ADMM with user-supplied proximal operators, in torch on the
inputs' device and dtype; the iterations queue without a host sync.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import torch


class ADMMState(NamedTuple):
    x: torch.Tensor
    z: torch.Tensor
    u: torch.Tensor  # scaled dual
    primal_res: torch.Tensor
    dual_res: torch.Tensor


def admm(prox_f: Callable, prox_g: Callable, A: torch.Tensor,
         B: torch.Tensor, c: torch.Tensor, x0: torch.Tensor,
         z0: torch.Tensor, rho: float = 1.0, iters: int = 100) -> ADMMState:
    """Scaled-form ADMM.

    prox_f(v, rho): argmin_x f(x) + rho/2 ||A x - v||^2
    prox_g(v, rho): argmin_z g(z) + rho/2 ||B z - v||^2
    """
    inf = torch.full((), float("inf"), dtype=c.dtype, device=c.device)
    st = ADMMState(x0, z0, torch.zeros_like(c), inf, inf)
    for _ in range(iters):
        x, z, u = st.x, st.z, st.u
        x_new = prox_f(c - B @ z - u, rho)
        z_new = prox_g(c - A @ x_new - u, rho)
        r = A @ x_new + B @ z_new - c
        s = rho * (B @ (z_new - z))
        st = ADMMState(x_new, z_new, u + r, torch.linalg.norm(r),
                       torch.linalg.norm(s))
    return st


def lasso(Amat: torch.Tensor, b: torch.Tensor, lam: float,
          rho: float = 1.0, iters: int = 200) -> torch.Tensor:
    """l1-regularized least squares via ADMM (the classic example):
    min 1/2 ||A x - b||^2 + lam ||x||_1."""
    n = Amat.shape[1]
    Atb = Amat.T @ b
    L = torch.linalg.cholesky(
        Amat.T @ Amat + rho * torch.eye(n, dtype=Amat.dtype,
                                        device=Amat.device))

    def solve(v):
        return torch.cholesky_solve(v[:, None], L)[:, 0]

    def shrink(v, k):
        return torch.sign(v) * torch.clamp(torch.abs(v) - k, min=0.0)

    x = z = u = torch.zeros(n, dtype=Amat.dtype, device=Amat.device)
    for _ in range(iters):
        x = solve(Atb + rho * (z - u))
        z = shrink(x + u, lam / rho)
        u = u + x - z
    return z
