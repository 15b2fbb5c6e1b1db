"""Batched polynomial root finding.

Twin of ``sara_tpu/core/poly.py``. Real roots come from the reference's
branch-free bracket-and-bisect scheme (Fujiwara bound, sign changes on a
fixed grid, fixed bisection and Newton steps), so both packages keep the
same roots in the same slots; quadratics and cubics use closed forms.
Every function broadcasts over leading batch dimensions.
"""

from __future__ import annotations

import torch


def first_true(mask: torch.Tensor, k: int) -> torch.Tensor:
    """Indices of up to ``k`` True entries along the last axis, lowest
    index first, then the False entries in index order.

    This is what ``lax.top_k`` returns for a 0/1 score: it breaks ties by
    the lower index, which ``torch.topk`` does not promise. A stable
    descending sort keeps index order among equal scores.
    """
    return torch.sort(mask.to(torch.int8), dim=-1, descending=True,
                      stable=True).indices[..., :k]


def polyval(coeffs: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Evaluate the polynomial ``coeffs`` (..., n+1), highest degree first,
    by Horner's scheme; broadcasts coeffs against x over leading dims."""
    acc = torch.zeros_like(x) + coeffs[..., 0]
    for i in range(1, coeffs.shape[-1]):
        acc = acc * x + coeffs[..., i]
    return acc


def polyder(coeffs: torch.Tensor) -> torch.Tensor:
    """Derivative coefficients (highest degree first)."""
    n = coeffs.shape[-1] - 1
    powers = torch.arange(n, 0, -1, dtype=coeffs.dtype, device=coeffs.device)
    return coeffs[..., :-1] * powers


def real_roots_bracketed(coeffs: torch.Tensor, max_roots: int,
                         grid_size: int = 128, bisect_iters: int = 40,
                         newton_iters: int = 2):
    """Real roots of a batch of polynomials, fixed output capacity.

    Args:
      coeffs: (..., n+1) coefficients, highest degree first. A (near) zero
        leading coefficient is regularized.
      max_roots: capacity of the returned root array.
      grid_size: number of initial samples.
      bisect_iters / newton_iters: iteration counts.

    Returns (roots (..., max_roots), valid (..., max_roots) bool).
    """
    dtype, dev = coeffs.dtype, coeffs.device
    lead = coeffs[..., :1]
    lead = torch.where(lead.abs() < 1e-12, 1e-12, lead)
    c = coeffs / lead

    # Fujiwara bound: 2 * max_i |a_i|^(1/i) for the monic polynomial, with
    # the constant term halved.
    n = c.shape[-1] - 1
    inv_i = 1.0 / torch.arange(1, n + 1, dtype=dtype, device=dev)
    mags = c[..., 1:].abs()
    mags = torch.cat([mags[..., :-1], 0.5 * mags[..., -1:]], dim=-1)
    bound = 2.0 * torch.amax(mags ** inv_i, dim=-1)
    bound = torch.clamp(bound, min=1e-6)

    k = torch.arange(grid_size, dtype=dtype, device=dev)
    u = 2.0 * k / (grid_size - 1) - 1.0
    xs = bound[..., None] * u                                  # (..., G)
    ys = polyval(c[..., None, :], xs)

    s = torch.sign(ys)
    change = (s[..., :-1] * s[..., 1:]) < 0
    change = change | (ys[..., :-1] == 0)

    idx = first_true(change, max_roots)
    has = torch.gather(change, -1, idx)
    lo = torch.gather(xs, -1, idx)
    hi = torch.gather(xs, -1, idx + 1)
    flo = polyval(c[..., None, :], lo)

    for _ in range(bisect_iters):
        mid = 0.5 * (lo + hi)
        fmid = polyval(c[..., None, :], mid)
        go_left = (flo * fmid) <= 0
        lo, hi, flo = (torch.where(go_left, lo, mid),
                       torch.where(go_left, mid, hi),
                       torch.where(go_left, flo, fmid))
    roots = 0.5 * (lo + hi)

    dc = polyder(c)
    for _ in range(newton_iters):
        f = polyval(c[..., None, :], roots)
        df = polyval(dc[..., None, :], roots)
        step = f / torch.where(df.abs() < 1e-12, 1e-12, df)
        cand = roots - step
        ok = (cand >= lo) & (cand <= hi)
        roots = torch.where(ok, cand, roots)
    return roots, has


def roots_quadratic(a, b, c):
    """Real roots of a x^2 + b x + c. Returns (roots (..., 2),
    valid (..., 2))."""
    disc = b * b - 4.0 * a * c
    ok = disc >= 0
    sq = torch.sqrt(torch.clamp(disc, min=0.0))
    q = -0.5 * (b + torch.where(b >= 0, sq, -sq))
    a_safe = torch.where(a.abs() < 1e-12, 1e-12, a)
    q_safe = torch.where(q.abs() < 1e-12, 1e-12, q)
    roots = torch.stack([q / a_safe, c / q_safe], dim=-1)
    valid = torch.stack([ok, ok & (q.abs() > 1e-12)], dim=-1)
    return roots, valid


def _cbrt(x):
    return torch.sign(x) * x.abs() ** (1.0 / 3.0)


def roots_cubic_single_real(a, b, c, d):
    """One guaranteed real root of a x^3 + b x^2 + c x + d (batched), by
    the branch-free Cardano / trigonometric method."""
    a_safe = torch.where(a.abs() < 1e-12, 1e-12, a)
    p = b / a_safe
    q = c / a_safe
    r = d / a_safe
    # Depressed cubic t^3 + pt t + qt with x = t - p/3.
    pt = q - p * p / 3.0
    qt = 2.0 * p ** 3 / 27.0 - p * q / 3.0 + r
    disc = (qt / 2.0) ** 2 + (pt / 3.0) ** 3

    # disc >= 0: one real root (Cardano).
    sq = torch.sqrt(torch.clamp(disc, min=0.0))
    t_card = _cbrt(-qt / 2.0 + sq) + _cbrt(-qt / 2.0 - sq)

    # disc < 0: three real roots; the largest, trigonometric form.
    pt_neg = torch.clamp(pt, max=-1e-12)
    m = 2.0 * torch.sqrt(-pt_neg / 3.0)
    arg = torch.clamp(3.0 * qt / (pt_neg * m), -1.0, 1.0)
    t_trig = m * torch.cos(torch.arccos(arg) / 3.0)

    t = torch.where(disc >= 0, t_card, t_trig)
    return t - p / 3.0


def roots_cubic(a, b, c, d, polish_iters: int = 2):
    """All real roots of a cubic. Returns (roots (..., 3), valid (..., 3))."""
    x0 = roots_cubic_single_real(a, b, c, d)
    # Deflate: a x^3 + ... = (x - x0)(a x^2 + B x + C).
    B = b + a * x0
    C = c + B * x0
    r, v = roots_quadratic(a, B, C)
    roots = torch.cat([x0[..., None], r], dim=-1)
    valid = torch.cat([torch.ones_like(x0[..., None], dtype=torch.bool), v],
                      dim=-1)
    a_, b_, c_, d_ = (z[..., None] for z in (a, b, c, d))
    for _ in range(polish_iters):
        f = ((a_ * roots + b_) * roots + c_) * roots + d_
        df = (3 * a_ * roots + 2 * b_) * roots + c_
        df = torch.where(df.abs() < 1e-12, 1e-12, df)
        roots = roots - f / df
    return roots, valid


def companion_matrix(coeffs: torch.Tensor) -> torch.Tensor:
    """Companion matrix of a (monic-normalized) polynomial, batched."""
    n = coeffs.shape[-1] - 1
    lead = coeffs[..., :1]
    lead = torch.where(lead.abs() < 1e-12, 1e-12, lead)
    c = coeffs / lead
    batch = coeffs.shape[:-1]
    comp = torch.zeros(batch + (n, n), dtype=coeffs.dtype,
                       device=coeffs.device)
    comp[..., 1:, :-1] = torch.eye(n - 1, dtype=coeffs.dtype,
                                   device=coeffs.device)
    comp[..., 0, :] = -c[..., 1:]
    return comp
