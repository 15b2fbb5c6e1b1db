"""Batched small-matrix determinant, solve and inverse.

Twin of ``sara_tpu/ops/smallmat.py``. The reference eliminated with a
batch-last Gauss-Jordan only to dodge the TPU's padded LU layout; here the
closed forms stay for n <= 3 and larger matrices go to ``torch.linalg``'s
batched LU (partial pivoting, the same pivots as the reference's
elimination). The ``_ex`` variants are used so that no call waits on the
device to check for singular input: a singular matrix gives non-finite
entries instead of an exception.
"""

from __future__ import annotations

import torch


def _nonzero(x: torch.Tensor, eps: float = 1e-30) -> torch.Tensor:
    """``x`` with entries below ``eps`` in magnitude replaced by ``eps``."""
    return torch.where(x.abs() < eps, torch.full_like(x, eps), x)


def cross(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Cross product over the last axis, broadcasting the leading ones
    like ``jnp.cross`` (``torch.linalg.cross`` wants equal ranks)."""
    a, b = torch.broadcast_tensors(a, b)
    return torch.linalg.cross(a, b)


def select(x: torch.Tensor, i: torch.Tensor) -> torch.Tensor:
    """``x[i]`` for a 0-dim index tensor, without a host sync (indexing
    with a 0-dim tensor reads it on the host)."""
    return x.index_select(0, i.reshape(1))[0]


def take(x: torch.Tensor, i: torch.Tensor) -> torch.Tensor:
    """``x[..., i, ...]`` per batch element: x (*L, M, ...) and an index
    tensor i (*L,) give (*L, ...); with a 0-dim ``i`` this is
    :func:`select`. No host sync."""
    L = i.dim()
    idx = i.reshape(i.shape + (1,) * (x.dim() - L)).expand(
        i.shape + (1,) + x.shape[L + 1:])
    return x.gather(L, idx).squeeze(L)


def det3(A: torch.Tensor) -> torch.Tensor:
    """Closed-form determinant of (..., 3, 3)."""
    a, b, c = A[..., 0, 0], A[..., 0, 1], A[..., 0, 2]
    d, e, f = A[..., 1, 0], A[..., 1, 1], A[..., 1, 2]
    g, h, i = A[..., 2, 0], A[..., 2, 1], A[..., 2, 2]
    return a * (e * i - f * h) - b * (d * i - f * g) + c * (d * h - e * g)


def batched_det(A: torch.Tensor) -> torch.Tensor:
    """Determinant of (..., n, n) small-matrix batches."""
    if A.shape[-1] == 3:
        return det3(A)
    return torch.linalg.det(A)


def batched_solve(A: torch.Tensor, B: torch.Tensor) -> torch.Tensor:
    """Solve A X = B for (..., n, n) x (..., n, k) small-matrix batches."""
    return torch.linalg.solve_ex(A, B)[0]


def inv2(A: torch.Tensor) -> torch.Tensor:
    """Closed-form inverse of (..., 2, 2)."""
    a, b = A[..., 0, 0], A[..., 0, 1]
    c, d = A[..., 1, 0], A[..., 1, 1]
    det = a * d - b * c
    det = _nonzero(det)
    row0 = torch.stack([d, -b], dim=-1)
    row1 = torch.stack([-c, a], dim=-1)
    return torch.stack([row0, row1], dim=-2) / det[..., None, None]


def inv3(A: torch.Tensor) -> torch.Tensor:
    """Closed-form adjugate inverse of (..., 3, 3)."""
    a, b, c = A[..., 0, 0], A[..., 0, 1], A[..., 0, 2]
    d, e, f = A[..., 1, 0], A[..., 1, 1], A[..., 1, 2]
    g, h, i = A[..., 2, 0], A[..., 2, 1], A[..., 2, 2]
    A11 = e * i - f * h
    A12 = c * h - b * i
    A13 = b * f - c * e
    A21 = f * g - d * i
    A22 = a * i - c * g
    A23 = c * d - a * f
    A31 = d * h - e * g
    A32 = b * g - a * h
    A33 = a * e - b * d
    det = a * A11 + b * A21 + c * A31
    det = _nonzero(det)
    adj = torch.stack([
        torch.stack([A11, A12, A13], dim=-1),
        torch.stack([A21, A22, A23], dim=-1),
        torch.stack([A31, A32, A33], dim=-1),
    ], dim=-2)
    return adj / det[..., None, None]


def assemble_blocks(n: int, terms) -> torch.Tensor:
    """Dense (n*D, n*D) matrix from (rows, cols, blocks) terms: blocks[e]
    (D, D) added at block (rows[e], cols[e]), repeated pairs accumulating.

    The reference's ``H.at[rows, :, cols, :].add(blocks)`` accumulates
    repeated indices; ``H[rows, :, cols, :] += blocks`` in PyTorch is a
    non-accumulating ``index_put_`` that keeps one of the duplicates. Here
    every term is one ``index_add_`` over the flattened (row, col) block
    index."""
    blocks = terms[0][2]
    D = blocks.shape[-1]
    buf = blocks.new_zeros((n * n, D, D))
    for rows, cols, b in terms:
        buf.index_add_(0, rows.long() * n + cols.long(), b)
    return buf.view(n, n, D, D).transpose(1, 2).reshape(n * D, n * D)


def batched_inv(A: torch.Tensor) -> torch.Tensor:
    """Inverse of (..., n, n) small-matrix batches (closed form for
    n <= 3, batched LU otherwise)."""
    n = A.shape[-1]
    if n == 2:
        return inv2(A)
    if n == 3:
        return inv3(A)
    return torch.linalg.inv_ex(A)[0]
