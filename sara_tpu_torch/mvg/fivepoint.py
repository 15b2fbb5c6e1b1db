"""Five-point relative pose (essential matrix) solver.

Twin of ``sara_tpu/mvg/fivepoint.py``, with the same formulation:

1. Null space: SVD of the 5x9 epipolar design matrix; E(x, y, z) =
   x X + y Y + z Z + W over the right 4-dimensional null basis.
2. The 10 cubic constraints (det E = 0 and 2 E E^T E - tr(E E^T) E = 0)
   are C(z) @ m(x, y) = 0 with m the 10 (x, y) monomials up to degree 3;
   C0..C3 come from evaluating the constraints at 20 fixed points and a
   precomputed inverse Vandermonde.
3. Hidden-variable resultant: det C(z) = 0 is a 31-term trig series in
   phi (z = tan phi), fixed by 31 determinant samples; real roots come from
   sign brackets on a grid, a subdivision pass for close pairs, bisection
   and Newton steps.
4. The search runs over fixed random orthogonal remixes of the null basis
   (first = identity), each restricted to |z| <= tan(PHI_MAX).
5. Per root: null vector of C(z) by inverse iteration, three Gauss-Newton
   steps on (x, y, z), validation, and a greedy dedup across remixes.

A leading batch of samples, (..., 5, 2), is solved in one pass; that batch
takes the place of the reference's ``vmap`` over RANSAC hypotheses. The
constant tables are built with numpy exactly as the reference builds them,
call for call, so both packages hold the same arrays.

Precision: the solve runs in float64 whatever the input type, and the
candidates come back in the input type. The reference's recovery gate
(>= 99% of a generalized-eigenproblem oracle's solutions on generic
problems, >= 97% near-planar; scripts/mc_fivepoint.py) holds in float64;
in float32 the same formulation recovers about 98% / 95-96%, in the
reference and in this port alike (tests/test_torch_geometry.py).
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from sara_tpu_torch.core.poly import first_true
from sara_tpu_torch.features.dog import _solve3
from sara_tpu_torch.ops.smallmat import batched_det, batched_inv, det3
from sara_tpu_torch.mvg.solvers import _epipolar_design_rows

MAX_SOLUTIONS = 10
_N_REMIX = 4
_ROOTS_PER_REMIX = 8
_GRID = 192
_PHI_MAX = 1.45           # |z| <= tan(1.45) ~ 8.2 per remix
_BISECT_ITERS = 4
_NEWTON_ITERS = 3
_N_SUSPICIOUS = 3         # cells re-examined for hidden root pairs
_SUBDIV = 16              # subsamples per suspicious cell

# ---------------------------------------------------------------------------
# Constant tables (numpy, at import time; same calls as the reference).
# ---------------------------------------------------------------------------

# (x, y) monomial order for the columns of C(z).
_XY_MONOMIALS = [(3, 0), (2, 1), (1, 2), (0, 3), (2, 0),
                 (1, 1), (0, 2), (1, 0), (0, 1), (0, 0)]
# All degree-<=3 trivariate monomials (a, b, c) for x^a y^b z^c.
_XYZ_MONOMIALS = [(a, b, c)
                  for c in range(4)
                  for (a, b) in _XY_MONOMIALS
                  if a + b + c <= 3]
assert len(_XYZ_MONOMIALS) == 20

_rs = np.random.RandomState(12345)
_PTS = _rs.uniform(-1.0, 1.0, size=(20, 3))
_VAND = np.stack([
    [p[0] ** a * p[1] ** b * p[2] ** c for (a, b, c) in _XYZ_MONOMIALS]
    for p in _PTS
])  # (20 points, 20 monomials)
_VAND_INV = np.linalg.inv(_VAND)
assert np.linalg.cond(_VAND) < 1e6

# Scatter maps: trivariate monomial index -> (z-degree k, xy column).
_ZDEG = np.array([c for (_, _, c) in _XYZ_MONOMIALS])
_XYCOL = np.array([_XY_MONOMIALS.index((a, b))
                   for (a, b, _) in _XYZ_MONOMIALS])

# Second start vector of the null-space inverse iteration.
_START2 = _rs.normal(size=10)
_START2 /= np.linalg.norm(_START2)

# Fixed random orthogonal basis remixes (first = identity).
_QS = [np.eye(4)]
for _i in range(_N_REMIX - 1):
    _q, _ = np.linalg.qr(_rs.normal(size=(4, 4)))
    _QS.append(_q)
_REMIXES = np.stack(_QS)  # (_N_REMIX, 4, 4)

# Fourier representation of the homogenized resultant: g(phi) is spanned by
# {cos(k phi)}_{k=0,2,..,30} and {sin(k phi)}_{k=2,..,30}, 31 coefficients.
_N_SAMP = 31
_K_COS = np.arange(0, 31, 2)
_K_SIN = np.arange(2, 31, 2)


def _trig_basis_np(phi):
    phi = np.asarray(phi, np.float64)
    return np.concatenate([np.cos(np.outer(phi, _K_COS)),
                           np.sin(np.outer(phi, _K_SIN))], axis=1)


_PHI_NODES = -np.pi / 2 + np.pi * np.arange(_N_SAMP) / _N_SAMP
_B_NODES_INV = np.linalg.inv(_trig_basis_np(_PHI_NODES))
assert np.linalg.cond(_trig_basis_np(_PHI_NODES)) < 50.0
_GRID_PHI = np.linspace(-_PHI_MAX, _PHI_MAX, _GRID)
_B_GRID = _trig_basis_np(_GRID_PHI)  # (_GRID, 31)

# The reference scatters coeffs[m, i] to C[zdeg(m), i, xycol(m)]; the
# (zdeg, xycol) pairs are distinct, so the scatter is a row placement of
# the inverse Vandermonde: row zdeg(m) * 10 + xycol(m) holds row m.
_SCATTER_VAND_INV = np.zeros((40, 20))
_SCATTER_VAND_INV[_ZDEG * 10 + _XYCOL] = _VAND_INV


@functools.lru_cache(maxsize=None)
def _tables(dtype: torch.dtype, device: torch.device) -> dict:
    """The constant tables as tensors of one dtype on one device, made once
    per (dtype, device) so that a solve copies nothing from the host."""
    arrays = dict(pts=_PTS, scatter=_SCATTER_VAND_INV, start2=_START2,
                  remixes=_REMIXES, phi_nodes=_PHI_NODES,
                  b_nodes_inv=_B_NODES_INV, b_grid=_B_GRID, k_cos=_K_COS,
                  k_sin=_K_SIN, grid_phi=_GRID_PHI)
    return {k: torch.as_tensor(np.asarray(a, np.float64)).to(
        device=device, dtype=dtype) for k, a in arrays.items()}


def _constraints(E: torch.Tensor) -> torch.Tensor:
    """The 10 essential constraints of E (..., 3, 3) -> (..., 10):
    [det(E), vec(2 E E^T E - tr(E E^T) E)]."""
    EEt = E @ E.transpose(-1, -2)
    tr = torch.diagonal(EEt, dim1=-2, dim2=-1).sum(-1)
    M = 2.0 * EEt @ E - tr[..., None, None] * E
    return torch.cat([det3(E)[..., None], M.flatten(-2)], dim=-1)


def _coefficient_matrices(X, Y, Z, W):
    """C0..C3 (..., 4, 10, 10) for E = xX + yY + zZ + W, numerically;
    C[..., k] multiplies z^k."""
    T = _tables(X.dtype, X.device)
    pts = T["pts"]
    E_pts = (pts[:, 0, None, None] * X[..., None, :, :]
             + pts[:, 1, None, None] * Y[..., None, :, :]
             + pts[:, 2, None, None] * Z[..., None, :, :]
             + W[..., None, :, :])                          # (..., 20, 3, 3)
    vals = _constraints(E_pts)                              # (..., 20, 10)
    C = (T["scatter"] @ vals).unflatten(-2, (4, 10))        # [k, col, i]
    return C.transpose(-1, -2)                              # [k, i, col]


def _resultant_coeffs(C):
    """Fourier coefficients (..., 31) of g(phi) = det of the homogenized
    pencil, rows scaled by a phi-independent factor; 31 determinants."""
    T = _tables(C.dtype, C.device)
    rown = torch.linalg.vector_norm(
        torch.cat(C.unbind(-3), dim=-1), dim=-1)            # (..., 10)
    Cs = C / torch.clamp(rown, min=1e-30)[..., None, :, None]
    s, c = torch.sin(T["phi_nodes"]), torch.cos(T["phi_nodes"])
    w = torch.stack([c ** 3, c * c * s, c * s * s, s ** 3], dim=-1)
    M = torch.einsum("pk,...kij->...pij", w, Cs)             # (..., 31, 10, 10)
    return batched_det(M) @ T["b_nodes_inv"].T


def _series_eval(coeff, phi):
    """The 31-term trig series at phi; ``coeff`` broadcasts against
    (phi.shape + (31,))."""
    T = _tables(coeff.dtype, coeff.device)
    b = torch.cat([torch.cos(phi[..., None] * T["k_cos"]),
                   torch.sin(phi[..., None] * T["k_sin"])], dim=-1)
    return torch.sum(b * coeff, dim=-1)


def _take(x, idx):
    return torch.gather(x, -1, idx)


def _find_roots(C):
    """Real roots of det C(z) = 0 with |z| <= tan(_PHI_MAX).

    Returns (z (..., _ROOTS_PER_REMIX), has_root (..., _ROOTS_PER_REMIX))."""
    R = _ROOTS_PER_REMIX
    T = _tables(C.dtype, C.device)
    coeff = _resultant_coeffs(C)                            # (..., 31)
    phi = torch.linspace(-_PHI_MAX, _PHI_MAX, _GRID, dtype=C.dtype,
                         device=C.device)
    g = coeff @ T["b_grid"].T                               # (..., G)
    sign = torch.sign(g)
    change = (sign[..., :-1] * sign[..., 1:]) < 0
    idx = first_true(change, R)
    has = _take(change, idx)
    lo, hi, glo = phi[idx], phi[idx + 1], _take(g, idx)

    # Subdivision pass for close pairs: local minima of |g| without a sign
    # change. Real-valued scores: a stable descending sort breaks ties by
    # the lower index, as lax.top_k does.
    absg = g.abs()
    interior_min = ((absg[..., 1:-1] < absg[..., :-2])
                    & (absg[..., 1:-1] < absg[..., 2:])
                    & ~change[..., :-1] & ~change[..., 1:])
    sus_score = torch.where(interior_min, -absg[..., 1:-1], -torch.inf)
    sus_idx = torch.sort(sus_score, dim=-1, descending=True,
                         stable=True).indices[..., :_N_SUSPICIOUS]
    sus_valid = _take(interior_min, sus_idx)
    ctr = sus_idx + 1
    sub_lo = phi[torch.clamp(ctr - 1, min=0)]
    sub_hi = phi[torch.clamp(ctr + 1, max=_GRID - 1)]
    frac = torch.linspace(0.0, 1.0, _SUBDIV + 1, dtype=C.dtype,
                          device=C.device)
    sub_phi = sub_lo[..., None] + (sub_hi - sub_lo)[..., None] * frac
    sub_g = _series_eval(coeff[..., None, None, :], sub_phi)  # (..., 3, 17)
    ssign = torch.sign(sub_g)
    sub_change = ((ssign[..., :-1] * ssign[..., 1:]) < 0) & sus_valid[..., None]
    sc_idx = first_true(sub_change, 2)                      # (..., 3, 2)
    sub_has = _take(sub_change, sc_idx).flatten(-2)
    s_lo = _take(sub_phi, sc_idx).flatten(-2)
    s_hi = _take(sub_phi, sc_idx + 1).flatten(-2)
    s_glo = _take(sub_g, sc_idx).flatten(-2)

    all_has = torch.cat([has, sub_has], dim=-1)
    keep = first_true(all_has, R)
    lo = _take(torch.cat([lo, s_lo], dim=-1), keep)
    hi = _take(torch.cat([hi, s_hi], dim=-1), keep)
    glo = _take(torch.cat([glo, s_glo], dim=-1), keep)
    has = _take(all_has, keep)

    cR = coeff[..., None, :]
    for _ in range(_BISECT_ITERS):
        mid = 0.5 * (lo + hi)
        gmid = _series_eval(cR, mid)
        left = (glo * gmid) <= 0
        lo, hi, glo = (torch.where(left, lo, mid), torch.where(left, mid, hi),
                       torch.where(left, glo, gmid))
    phi_r = 0.5 * (lo + hi)

    # Newton tail on the series (the derivative is the same series with
    # k-weighted coefficients), steps clamped to the bracket width.
    kc, ks = T["k_cos"], T["k_sin"]

    def dgeval(p):
        b = torch.cat([-kc * torch.sin(p[..., None] * kc),
                       ks * torch.cos(p[..., None] * ks)], dim=-1)
        return torch.sum(b * cR, dim=-1)

    width = hi - lo
    for _ in range(_NEWTON_ITERS):
        g_r = _series_eval(cR, phi_r)
        dg = dgeval(phi_r)
        step = -g_r / torch.where(dg.abs() < 1e-30, 1e-30, dg)
        phi_r = phi_r + torch.clamp(step, -width, width)
    return torch.tan(phi_r), has


def _resid_p(p, basis4):
    """Scale-invariant constraint residual (10,) of E(p) over one basis
    (4, 3, 3); written for one root, batched by ``torch.func.vmap``."""
    X, Y, Z, W = basis4.unbind(0)
    Ep = p[0] * X + p[1] * Y + p[2] * Z + W
    Ep = Ep / torch.clamp(torch.linalg.vector_norm(Ep), min=1e-12)
    return _constraints(Ep)


def _gn_polish(p, basis4, steps: int = 3):
    """Damped Gauss-Newton on (x, y, z) for a flat batch of roots:
    p (P, 3), basis4 (P, 4, 3, 3). A step is kept only if it lowers the
    residual norm (branch-free)."""
    from torch.func import jacfwd, vmap

    resid = vmap(_resid_p)
    jac = vmap(jacfwd(_resid_p))
    eye3 = torch.eye(3, dtype=p.dtype, device=p.device)
    for _ in range(steps):
        r = resid(p, basis4)                                # (P, 10)
        J = jac(p, basis4)                                  # (P, 10, 3)
        JtJ = J.transpose(-1, -2) @ J + 1e-10 * eye3
        g = (J.transpose(-1, -2) @ r[..., None])[..., 0]
        dp = -_solve3((JtJ[..., 0, 0], JtJ[..., 1, 1], JtJ[..., 2, 2],
                       JtJ[..., 0, 1], JtJ[..., 0, 2], JtJ[..., 1, 2]), g)
        p2 = p + torch.clamp(dp, -0.5, 0.5)
        better = (torch.linalg.vector_norm(resid(p2, basis4), dim=-1)
                  < torch.linalg.vector_norm(r, dim=-1))
        p = torch.where(better[..., None], p2, p)
    return p


def _solve_basis(basis4):
    """E candidates over (possibly remixed) null bases (..., 4, 3, 3).

    Returns E (..., R, 3, 3), valid (..., R), resid (..., R)."""
    T = _tables(basis4.dtype, basis4.device)
    X, Y, Z, W = basis4.unbind(-3)
    C = _coefficient_matrices(X, Y, Z, W)                   # (..., 4, 10, 10)
    z, has = _find_roots(C)                                 # (..., R)
    zz = z[..., None, None]
    Cz = (C[..., None, 0, :, :] + C[..., None, 1, :, :] * zz
          + C[..., None, 2, :, :] * zz ** 2
          + C[..., None, 3, :, :] * zz ** 3)                # (..., R, 10, 10)

    # Null vector of Cz by shifted inverse iteration on the normal
    # equations, from two start vectors; one inverse, two matmul steps.
    Czn = Cz / torch.clamp(torch.linalg.matrix_norm(Cz), min=1e-30)[
        ..., None, None]
    eye10 = torch.eye(10, dtype=Cz.dtype, device=Cz.device)
    Ainv = batched_inv(Czn.transpose(-1, -2) @ Czn + 1e-6 * eye10)
    m0 = torch.full(Cz.shape[:-1], 10.0 ** -0.5, dtype=Cz.dtype,
                    device=Cz.device)
    M2 = torch.stack([m0, T["start2"].expand_as(m0)], dim=-1)  # (..., 10, 2)
    for _ in range(2):
        M2 = Ainv @ M2
        M2 = M2 / torch.clamp(torch.linalg.vector_norm(M2, dim=-2,
                                                       keepdim=True),
                              min=1e-30)
    r2 = torch.linalg.vector_norm(Czn @ M2, dim=-2)         # (..., R, 2)
    pick = torch.argmin(r2, dim=-1)
    m = torch.gather(M2, -1, pick[..., None, None].expand(
        M2.shape[:-1] + (1,)))[..., 0]                      # (..., R, 10)
    w_m = m[..., 9]
    w_safe = torch.where(w_m.abs() < 1e-10, 1e-10, w_m)
    x = m[..., 7] / w_safe
    y = m[..., 8] / w_safe

    # Gauss-Newton polish of (x, y, z) on the 10 essential constraints.
    p0 = torch.stack([x, y, z], dim=-1)                     # (..., R, 3)
    bases = basis4[..., None, :, :, :].expand(p0.shape[:-1] + (4, 3, 3))
    p_fin = _gn_polish(p0.reshape(-1, 3), bases.reshape(-1, 4, 3, 3))
    x, y, z = p_fin.reshape(p0.shape).unbind(-1)

    E = (x[..., None, None] * X[..., None, :, :]
         + y[..., None, None] * Y[..., None, :, :]
         + z[..., None, None] * Z[..., None, :, :] + W[..., None, :, :])
    En = E / torch.clamp(torch.linalg.matrix_norm(E), min=1e-12)[
        ..., None, None]
    resid = torch.linalg.vector_norm(_constraints(En), dim=-1)
    valid = has & (w_m.abs() > 1e-8) & (resid < 1e-3)
    return En, valid, resid


def five_point_essential(u: torch.Tensor, v: torch.Tensor,
                         n_remix: int = _N_REMIX):
    """Essential matrices from 5 normalized correspondences.

    Args:
      u, v: (..., 5, 2) camera-normalized correspondences (K^-1 applied),
        with the epipolar convention v^T E u = 0.
      n_remix: basis remixes to search (default holds the >= 99%
        Monte-Carlo recovery gate).

    Returns:
      E: (..., MAX_SOLUTIONS, 3, 3) candidates (Frobenius-normalized), in
        the input dtype (computed in float64, see the module doc).
      valid: (..., MAX_SOLUTIONS) bool mask.
    """
    dtype = u.dtype
    u, v = u.to(torch.float64), v.to(torch.float64)
    A = _epipolar_design_rows(u, v)                          # (..., 5, 9)
    Vt = torch.linalg.svd(A, full_matrices=True)[2]
    basis = Vt[..., -4:, :].unflatten(-1, (3, 3))            # X, Y, Z, W
    Q = _tables(u.dtype, u.device)["remixes"][:max(1, min(n_remix, _N_REMIX))]
    mixed = torch.einsum("rij,...jab->...riab", Q, basis)
    E_all, valid_all, resid_all = _solve_basis(mixed)        # (..., r, R, ...)
    E_flat = E_all.flatten(-4, -3)                           # (..., r*R, 3, 3)
    valid_flat = valid_all.flatten(-2)
    resid_flat = resid_all.flatten(-2)

    # Greedy dedup: remixes re-find the same roots. Select by (validity,
    # -residual) while suppressing sign-invariant near-duplicates; argmax
    # takes the first maximum, as the reference's does.
    e9 = E_flat.flatten(-2)
    diff = torch.minimum(
        torch.linalg.vector_norm(e9[..., :, None, :] - e9[..., None, :, :],
                                 dim=-1),
        torch.linalg.vector_norm(e9[..., :, None, :] + e9[..., None, :, :],
                                 dim=-1))                    # (..., n, n)
    score = torch.where(valid_flat, -resid_flat, -torch.inf)
    keep, keep_valid = [], []
    for _ in range(MAX_SOLUTIONS):
        i = torch.argmax(score, dim=-1, keepdim=True)        # (..., 1)
        keep.append(i)
        keep_valid.append(_take(score, i) > -torch.inf)
        row = torch.gather(diff, -2, i[..., None].expand(
            i.shape[:-1] + (1, diff.shape[-1])))[..., 0, :]
        score = torch.where(row < 1e-3, -torch.inf, score)
    keep = torch.cat(keep, dim=-1)                           # (..., 10)
    E = torch.gather(E_flat, -3, keep[..., None, None].expand(
        keep.shape + (3, 3)))
    return E.to(dtype), torch.cat(keep_valid, dim=-1)
