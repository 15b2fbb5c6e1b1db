"""Global rotation averaging: spectral relaxation + IRLS.

Twin of ``sara_tpu/sfm/rotation_averaging.py``, the capability the
reference only sketches in Python (reference:
python/oddkiva/sara/sfm/rotation_averaging.py) — the initialization stage
for global SfM pipelines.

Method (Arie-Nachimson et al. style eigenvalue relaxation): the symmetric
3n x 3n block "rotation connection" matrix A with A[j, i] = w R_ij
(measurement R_j ~= R_ij R_i) and A[i, j] = w R_ij^T. The stacked true
rotations form the dominant rank-3 invariant subspace, found by shifted
subspace iteration with edge-structured matvecs; blocks are projected onto
SO(3) by batched SVD. A tangent-space Gauss-Newton polish and Cauchy IRLS
reject outlier edges. Every scatter-add over edges accumulates repeated
indices (``index_add_``).
"""

from __future__ import annotations

import torch

from sara_tpu_torch.ops.smallmat import assemble_blocks, det3


def _project_so3(M):
    """Nearest rotation(s) by SVD (batched), det = +1 enforced."""
    U, _, Vt = torch.linalg.svd(M)
    d = det3(U @ Vt)
    S = torch.stack([torch.ones_like(d), torch.ones_like(d), d], dim=-1)
    return (U * S[..., None, :]) @ Vt


def _solve_once(n, edge_i, edge_j, R_rel, w, iters: int = 300):
    """Top-3 invariant subspace of the normalized rotation-connection
    operator by SHIFTED SUBSPACE ITERATION with edge-structured matvecs.

    A dense eigensolve of the (3n)^2 connection matrix is O((3n)^3); the
    operator only has 2E off-diagonal blocks, so applying it is O(E); (I +
    A~) power iterations with per-step QR reach the same subspace in
    O(E * iters). The QR's column signs may differ between LAPACK and
    cuSOLVER; the gauge removal below is invariant to them.
    """
    ei, ej = edge_i.long(), edge_j.long()
    dtype = R_rel.dtype
    deg = R_rel.new_zeros((n,)).index_add_(0, ei, w).index_add_(0, ej, w)
    dinv = 1.0 / torch.sqrt(torch.clamp(deg, min=1e-9))
    wR = R_rel * w[:, None, None]
    wRT = wR.transpose(-1, -2)

    def matvec(U):                       # U: (n, 3, 3) block columns
        V = U * dinv[:, None, None]
        y = (torch.zeros_like(U)
             .index_add_(0, ej, wR @ V[ei])
             .index_add_(0, ei, wRT @ V[ej]))
        return y * dinv[:, None, None]

    B = torch.eye(3, dtype=dtype, device=R_rel.device).expand(n, 3, 3) \
        / (float(n) ** 0.5)
    for _ in range(iters):
        B = B + matvec(B)                # shift: top eigenvalues are ~ +1
        Q, _ = torch.linalg.qr(B.reshape(3 * n, 3))
        B = Q.reshape(n, 3, 3)
    # Remove the global gauge: B_k = R_k G with G (scaled) orthogonal, so
    # B_k B_0^T = (1/n) R_k R_0^T regardless of whether G is improper —
    # do NOT project B_0 first (that would flip the gauge when det(G) < 0).
    return _project_so3(torch.einsum("nab,cb->nac", B, B[0]))


def _log_batch(R):
    """Batched SO(3) log map, (E, 3, 3) -> (E, 3) (small/moderate angles)."""
    tr = R[..., 0, 0] + R[..., 1, 1] + R[..., 2, 2]
    c = torch.clamp((tr - 1.0) * 0.5, -1.0, 1.0)
    theta = torch.arccos(c)
    v = 0.5 * torch.stack([R[..., 2, 1] - R[..., 1, 2],
                           R[..., 0, 2] - R[..., 2, 0],
                           R[..., 1, 0] - R[..., 0, 1]], dim=-1)
    s = torch.sin(theta)
    # theta/sin(theta), series-safe near 0.
    fac = torch.where(theta < 1e-4, 1.0 + theta * theta / 6.0,
                      theta / torch.clamp(s, min=1e-12))
    return v * fac[..., None]


def _exp_batch(v):
    """Batched SO(3) exp map, (n, 3) -> (n, 3, 3) (Rodrigues)."""
    theta = torch.linalg.vector_norm(v, dim=-1, keepdim=True)
    small = theta < 1e-8
    a = torch.where(small, torch.ones_like(theta),
                    torch.sin(theta) / torch.clamp(theta, min=1e-12))
    b = torch.where(small, torch.full_like(theta, 0.5),
                    (1.0 - torch.cos(theta))
                    / torch.clamp(theta ** 2, min=1e-12))
    zero = torch.zeros_like(v[..., 0])
    Kx = torch.stack([
        torch.stack([zero, -v[..., 2], v[..., 1]], dim=-1),
        torch.stack([v[..., 2], zero, -v[..., 0]], dim=-1),
        torch.stack([-v[..., 1], v[..., 0], zero], dim=-1)], dim=-2)
    eye = torch.eye(3, dtype=v.dtype, device=v.device)
    return eye + a[..., None] * Kx + b[..., None] * (Kx @ Kx)


def _refine_tangent(n, R, edge_i, edge_j, R_rel, w, outer: int = 3,
                    inner: int = 16):
    """Local Gauss-Newton polish of the spectral solution.

    The spectral relaxation has SYSTEMATIC error on weakly connected
    (chain-like) graphs. First-order model: perturbing R_v <- exp(d_v) R_v
    turns each edge residual r_e = log(R_rel R_i R_j^T) into
    |r_e + R_rel d_i - d_j|^2 (the i-side tangent transports through the
    edge rotation) — a sparse Gauss-Newton system in so(3)^n solved
    DIRECTLY with the node-0 gauge pinned by masking its rows/columns.
    O((3n)^3) per linearization — the same cost class as the translation
    solve.
    """
    del inner  # direct solve; kept for signature compat
    ei, ej = edge_i.long(), edge_j.long()
    dt = R.dtype
    eyeN = torch.eye(3 * n, dtype=dt, device=R.device)
    gmask = torch.cat([torch.zeros(3, dtype=dt, device=R.device),
                       torch.ones(3 * (n - 1), dtype=dt, device=R.device)])
    eye3 = torch.eye(3, dtype=dt, device=R.device)
    wI = w[:, None, None] * eye3
    wA = w[:, None, None] * R_rel
    for _ in range(outer):
        r = _log_batch(torch.einsum("eab,ebc,edc->ead", R_rel, R[ei],
                                    R[ej]))            # (E, 3)
        Hf = assemble_blocks(n, [(ei, ei, wI), (ej, ej, wI),
                                 (ei, ej, -wA.transpose(-1, -2)),
                                 (ej, ei, -wA)])
        b = (R.new_zeros((n, 3))
             .index_add_(0, ei, -torch.einsum("eba,eb->ea", wA, r))
             .index_add_(0, ej, w[:, None] * r))
        Hf = (Hf * gmask[:, None] * gmask[None, :]
              + torch.diag(1.0 - gmask) + 1e-9 * eyeN)
        d = torch.linalg.solve_ex(Hf, b.reshape(-1) * gmask)[0].reshape(n, 3)
        R = _exp_batch(d) @ R
    return R


def average_rotations(n: int, edge_i=None, edge_j=None, R_rel=None,
                      edge_mask=None, irls_iters: int = 4):
    """Estimate absolute rotations from relative measurements.

    Spectral initialization (once), then alternating tangent-space
    Gauss-Newton refinement and Cauchy IRLS reweighting.

    Args:
      n: number of cameras.
      edge_i, edge_j: (E,) int; measurement convention R_j ~= R_rel @ R_i.
      R_rel: (E, 3, 3).
      edge_mask: (E,) bool.

    Returns R: (n, 3, 3) absolute rotations with R[0] = I (gauge), on
    R_rel's device and in its dtype.
    """
    E = edge_i.shape[0]
    if edge_mask is None:
        edge_mask = torch.ones((E,), dtype=torch.bool, device=R_rel.device)
    ei, ej = edge_i.long(), edge_j.long()
    w0 = edge_mask.to(R_rel.dtype)

    R = _solve_once(n, ei, ej, R_rel, w0)
    for _ in range(irls_iters):
        # Reweight BEFORE refining: the spectral solution already separates
        # outlier edges by residual.
        res = torch.linalg.vector_norm(
            (R[ej] - R_rel @ R[ei]).reshape(E, 9), dim=-1)
        sigma = 0.5
        # TRIMMED Cauchy: gross edges (chordal residual > ~40 deg) get
        # weight ZERO, not merely small.
        w = torch.where(res > 1.0, torch.zeros_like(res),
                        w0 / (1.0 + (res / sigma) ** 2))
        R = _refine_tangent(n, R, ei, ej, R_rel, w)
    # Re-fix the gauge to camera 0 (refinement preserves it; keep exact).
    return torch.einsum("nab,cb->nac", R, R[0])
