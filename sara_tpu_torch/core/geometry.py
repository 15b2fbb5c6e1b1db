"""2-D computational geometry: hulls, simplification, clipping, ellipses.

Twin of ``sara_tpu/core/geometry.py``. The sequential algorithms (hull,
Ramer-Douglas-Peucker, clipping, the exact ellipse intersection) run on the
host in float64 NumPy, as in the twin. The batched ellipse functions
(``fit_ellipse``, ``ellipse_parameters``, ``ellipse_points``) are torch and
run where their input lies: a tensor keeps its device and dtype, a host
array becomes a CPU tensor (float64 stays float64, anything else becomes
float32, as in the twin).
"""

from __future__ import annotations

import math

import numpy as np
import torch


def _as_tensor(x) -> torch.Tensor:
    if isinstance(x, torch.Tensor):
        return x
    a = np.asarray(x)
    return torch.from_numpy(np.ascontiguousarray(
        a, np.float64 if a.dtype == np.float64 else np.float32))


# ---------------------------------------------------------------------------
# Host-side polygon algorithms.
# ---------------------------------------------------------------------------

def _cross2(a, b) -> float:
    """2-D scalar cross product (np.cross on 2-vectors is deprecated)."""
    return float(a[0] * b[1] - a[1] * b[0])


def convex_hull(points: np.ndarray) -> np.ndarray:
    """Andrew monotone chain. points: (N, 2) -> CCW hull vertices (M, 2)."""
    pts = np.unique(np.asarray(points, float), axis=0)
    if len(pts) <= 2:
        return pts
    pts = pts[np.lexsort((pts[:, 1], pts[:, 0]))]

    def half(seq):
        out = []
        for p in seq:
            while len(out) >= 2 and _cross2(out[-1] - out[-2], p - out[-2]) <= 0:
                out.pop()
            out.append(p)
        return out

    lower = half(pts)
    upper = half(pts[::-1])
    return np.asarray(lower[:-1] + upper[:-1])


def ramer_douglas_peucker(poly: np.ndarray, eps: float) -> np.ndarray:
    """Polyline simplification (reference: RamerDouglasPeucker.cpp)."""
    poly = np.asarray(poly, float)
    if len(poly) < 3:
        return poly

    def rec(lo, hi):
        a, b = poly[lo], poly[hi]
        d = b - a
        n = np.linalg.norm(d)
        if n < 1e-12:
            dist = np.linalg.norm(poly[lo + 1:hi] - a, axis=1)
        else:
            dn = d / n
            diff = poly[lo + 1:hi] - a
            dist = np.abs(dn[0] * diff[:, 1] - dn[1] * diff[:, 0])
        if len(dist) == 0:
            return [lo]
        k = np.argmax(dist)
        if dist[k] > eps:
            mid = lo + 1 + k
            return rec(lo, mid) + rec(mid, hi)
        return [lo]

    idx = rec(0, len(poly) - 1) + [len(poly) - 1]
    return poly[np.asarray(idx)]


def clip_polygon(subject: np.ndarray, clip: np.ndarray) -> np.ndarray:
    """Sutherland-Hodgman clipping of a polygon by a convex CCW clip polygon
    (reference: SutherlandHodgman.cpp)."""
    output = list(np.asarray(subject, float))
    clip = np.asarray(clip, float)
    for i in range(len(clip)):
        a = clip[i]
        b = clip[(i + 1) % len(clip)]
        edge = b - a
        input_list = output
        output = []
        if not input_list:
            break

        def inside(p):
            return _cross2(edge, p - a) >= 0

        for j, cur in enumerate(input_list):
            prev = input_list[j - 1]
            ci, pi = inside(cur), inside(prev)
            if ci:
                if not pi:
                    output.append(_segment_intersect(prev, cur, a, b))
                output.append(cur)
            elif pi:
                output.append(_segment_intersect(prev, cur, a, b))
    return np.asarray(output) if output else np.zeros((0, 2))


def _segment_intersect(p, q, a, b):
    """Intersection of line pq with line ab."""
    d1 = q - p
    d2 = b - a
    denom = _cross2(d1, d2)
    if abs(denom) < 1e-12:
        return q
    t = _cross2(a - p, d2) / denom
    return p + t * d1


def polygon_area(poly: np.ndarray) -> float:
    """Signed area (CCW positive) via the shoelace formula."""
    p = np.asarray(poly, float)
    x, y = p[:, 0], p[:, 1]
    return 0.5 * float(np.sum(x * np.roll(y, -1) - np.roll(x, -1) * y))


def point_in_polygon(p, poly: np.ndarray) -> bool:
    """Winding/crossing test."""
    poly = np.asarray(poly, float)
    x, y = p
    inside = False
    j = len(poly) - 1
    for i in range(len(poly)):
        xi, yi = poly[i]
        xj, yj = poly[j]
        if (yi > y) != (yj > y) and \
                x < (xj - xi) * (y - yi) / (yj - yi + 1e-300) + xi:
            inside = not inside
        j = i
    return inside


# ---------------------------------------------------------------------------
# Ellipses (batched, on the input's device).
# ---------------------------------------------------------------------------

def fit_ellipse(points) -> torch.Tensor:
    """Direct least-squares (Fitzgibbon) conic fit of 2-D points.

    Returns conic coefficients (a, b, c, d, e, f) for
    a x^2 + b xy + c y^2 + d x + e y + f = 0, normalized (the sign of a
    singular vector is the solver's, as in the twin).
    """
    p = _as_tensor(points)
    if p.dtype != torch.float64:
        p = p.float()
    x, y = p[:, 0], p[:, 1]
    D = torch.stack([x * x, x * y, y * y, x, y, torch.ones_like(x)], dim=-1)
    # Minimize |D c| subject to |c| = 1 -> smallest right singular vector.
    _, _, Vt = torch.linalg.svd(D, full_matrices=True)
    c = Vt[-1]
    return c / torch.linalg.norm(c)


def ellipse_parameters(conic):
    """Conic (a,b,c,d,e,f) -> (center (2,), axes (2,), angle).

    Returns semi-axes sorted (major, minor)."""
    conic = _as_tensor(conic)
    a, b, c, d, e, f = (conic[i] for i in range(6))
    M = torch.stack([torch.stack([a, b / 2]), torch.stack([b / 2, c])])
    center = torch.linalg.solve(2 * M, -torch.stack([d, e]))
    # Value of the conic at the center.
    fc = (a * center[0] ** 2 + b * center[0] * center[1] + c * center[1] ** 2
          + d * center[0] + e * center[1] + f)
    evals, evecs = torch.linalg.eigh(M)
    axes = torch.sqrt(torch.clamp(-fc / evals, min=0.0))
    order = torch.argsort(-axes, stable=True)
    axes = axes[order]
    v = evecs[:, order[0]]
    return center, axes, torch.atan2(v[1], v[0])


def ellipse_points(center, axes, angle, n: int = 64) -> torch.Tensor:
    """Sample n points on an ellipse boundary."""
    center, axes, angle = (_as_tensor(v) for v in (center, axes, angle))
    t = torch.arange(n, dtype=axes.dtype, device=axes.device) * (
        2 * math.pi / n)
    ca, sa = torch.cos(angle), torch.sin(angle)
    x = axes[0] * torch.cos(t)
    y = axes[1] * torch.sin(t)
    return torch.stack([center[0] + ca * x - sa * y,
                        center[1] + sa * x + ca * y], dim=-1)


def ellipse_intersection_area_polygonal(c1, a1, t1, c2, a2, t2,
                                        n: int = 256) -> float:
    """Area of intersection of two ellipses by polygon clipping of dense
    boundary samplings (reference: EllipseIntersection.cpp
    ``approximate_intersection``; converges ~O(1/n^2))."""
    p1, p2 = (ellipse_points(np.asarray(c, float), np.asarray(a, float),
                             np.asarray(t, float), n).numpy()
              for c, a, t in ((c1, a1, t1), (c2, a2, t2)))
    inter = clip_polygon(p1, p2)
    if len(inter) < 3:
        return 0.0
    return abs(polygon_area(inter))


# ---------------------------------------------------------------------------
# Exact ellipse intersection (conic pencil + quartic resultant).
# Host-side float64, as in the twin.
# ---------------------------------------------------------------------------

def _shape_matrix(axes, angle):
    """M with (p-c)^T M (p-c) = 1 on the boundary."""
    ca, sa = np.cos(angle), np.sin(angle)
    R = np.array([[ca, -sa], [sa, ca]])
    D = np.diag([1.0 / axes[0] ** 2, 1.0 / axes[1] ** 2])
    return R @ D @ R.T


def conic_equation_of_ellipse(center, axes, angle):
    """Coefficients (s0..s5) of s0 + s1 x + s2 y + s3 x^2 + s4 xy + s5 y^2
    (reference: EllipseIntersection.cpp::conic_equation)."""
    c = np.asarray(center, float)
    M = _shape_matrix(np.asarray(axes, float), float(angle))
    s = np.empty(6)
    s[0] = c @ M @ c - 1.0
    s[1] = -2.0 * (M[0, 0] * c[0] + M[0, 1] * c[1])
    s[2] = -2.0 * (M[1, 0] * c[0] + M[1, 1] * c[1])
    s[3] = M[0, 0]
    s[4] = 2.0 * M[0, 1]
    s[5] = M[1, 1]
    return s


def _quartic_in_y(s, t):
    """Degree-4 resultant polynomial in y of the conic pencil
    (reference: EllipseIntersection.cpp::quartic_equation). Returns
    coefficients [u0..u4] (ascending)."""
    d = s[:, None] * t[None, :] - s[None, :] * t[:, None]
    u = np.empty(5)
    u[0] = d[3, 1] * d[1, 0] - d[3, 0] ** 2
    u[1] = (d[3, 4] * d[1, 0] + d[3, 1] * (d[4, 0] + d[1, 2])
            - 2 * d[3, 2] * d[3, 0])
    u[2] = (d[3, 4] * (d[4, 0] + d[1, 2]) + d[3, 1] * (d[4, 2] - d[5, 1])
            - d[3, 2] ** 2 - 2 * d[3, 5] * d[3, 0])
    u[3] = (d[3, 4] * (d[4, 2] - d[5, 1]) + d[3, 1] * d[4, 5]
            - 2 * d[3, 5] * d[3, 2])
    u[4] = d[3, 4] * d[4, 5] - d[3, 5] ** 2
    return u


def _conic_at(s, x, y):
    return (s[0] + s[1] * x + s[2] * y + s[3] * x * x + s[4] * x * y
            + s[5] * y * y)


def ellipse_intersection_points(c1, a1, t1, c2, a2, t2,
                                polish: bool = True) -> np.ndarray:
    """Exact intersection points of two ellipse boundaries (<= 4 points).

    Conic-pencil quartic in y, then per-root linear (or quadratic) solve in
    x (reference: EllipseIntersection.cpp::compute_intersection_points).
    """
    center = 0.5 * (np.asarray(c1, float) + np.asarray(c2, float))
    s = conic_equation_of_ellipse(np.asarray(c1, float) - center, a1, t1)
    t = conic_equation_of_ellipse(np.asarray(c2, float) - center, a2, t2)
    u = _quartic_in_y(s, t)
    if abs(u[4]) < 1e-15 * max(1.0, np.abs(u).max()):
        deg = np.nonzero(np.abs(u) > 1e-15 * max(1.0, np.abs(u).max()))[0]
        u_trim = u[:deg[-1] + 1] if len(deg) else u[:1]
    else:
        u_trim = u
    if len(u_trim) < 2:
        return np.zeros((0, 2))
    roots = np.roots(u_trim[::-1] / u_trim[-1])
    ys = [float(r.real) for r in roots
          if abs(r.imag) < 1e-2 * max(abs(r.real), 1e-12)]
    ys.sort()
    # Dedupe near-equal roots.
    dedup = []
    for y in ys:
        if not dedup or abs(y - dedup[-1]) > 1e-4:
            dedup.append(y)
    if polish:
        coeffs_desc = u_trim[::-1]
        dcoeffs = np.polyder(coeffs_desc)
        dedup = [_newton_polish(coeffs_desc, dcoeffs, y) for y in dedup]

    pts = []
    for y in dedup:
        sig = np.array([_conic_at(s, 0, y), s[1] + s[4] * y, s[3]])
        tau = np.array([_conic_at(t, 0, y), t[1] + t[4] * y, t[3]])
        denom = sig[1] * tau[2] - sig[2] * tau[1]
        cands = []
        if abs(denom) < 1e-12:
            disc = sig[1] ** 2 - 4 * sig[2] * sig[0]
            if disc >= 0 and abs(sig[2]) > 1e-15:
                sq = np.sqrt(disc)
                cands = [(-sig[1] + sq) / (2 * sig[2]),
                         (-sig[1] - sq) / (2 * sig[2])]
        else:
            cands = [(sig[2] * tau[0] - sig[0] * tau[2]) / denom]
        for x in cands:
            if abs(_conic_at(s, x, y)) < 1e-2 and abs(_conic_at(t, x, y)) < 1e-2:
                pts.append((x, y))
    # Dedupe points.
    out = []
    for p in pts:
        if all((p[0] - q[0]) ** 2 + (p[1] - q[1]) ** 2 > 1e-8 for q in out):
            out.append(p)
    return np.asarray(out).reshape(-1, 2) + center


def _newton_polish(coeffs_desc, dcoeffs_desc, y, iters: int = 10):
    for _ in range(iters):
        f = np.polyval(coeffs_desc, y)
        df = np.polyval(dcoeffs_desc, y)
        if abs(df) < 1e-15:
            break
        step = f / df
        y = y - step
        if abs(step) < 1e-14 * max(1.0, abs(y)):
            break
    return y


def _polar_antiderivative(a, b, theta):
    """Antiderivative of the ellipse polar-area integrand
    (reference: Ellipse.hpp:104-113)."""
    y = (b - a) * np.sin(2 * theta)
    x = (b + a) + (b - a) * np.cos(2 * theta)
    return a * b * 0.5 * (theta - np.arctan2(y, x))


def ellipse_sector_area(axes, theta0, theta1) -> float:
    """Positive area of the CCW sector from angle theta0 to theta1
    (geometric angles in the ellipse frame; reference: Ellipse.hpp:126-129)."""
    a, b = float(axes[0]), float(axes[1])
    return _polar_antiderivative(a, b, theta1) - _polar_antiderivative(a, b, theta0)


def _ellipse_point_at(center, axes, angle, theta):
    """Boundary point at geometric polar angle theta in the ellipse frame
    (reference: Ellipse.cpp::rho / operator())."""
    a, b = float(axes[0]), float(axes[1])
    c, sn = np.cos(theta), np.sin(theta)
    r = a * b / np.sqrt(b * b * c * c + a * a * sn * sn)
    ca, sa = np.cos(angle), np.sin(angle)
    R = np.array([[ca, -sa], [sa, ca]])
    return np.asarray(center, float) + R @ (r * np.array([c, sn]))


def ellipse_segment_area(axes, center, angle, theta0, theta1) -> float:
    """Area between the CCW arc theta0->theta1 and its chord
    (reference: Ellipse.cpp::segment_area)."""
    p0 = _ellipse_point_at(center, axes, angle, theta0)
    p1 = _ellipse_point_at(center, axes, angle, theta1)
    c = np.asarray(center, float)
    tri = 0.5 * abs(_cross2(p0 - c, p1 - c))
    sect = ellipse_sector_area(axes, theta0, theta1)
    if abs(theta1 - theta0) < np.pi:
        return sect - tri
    return sect + tri


def _ellipse_contains(center, axes, angle, p) -> bool:
    d = np.asarray(p, float) - np.asarray(center, float)
    return float(d @ _shape_matrix(np.asarray(axes, float), float(angle)) @ d) <= 1.0


def ellipse_intersection_area(c1, a1, t1, c2, a2, t2) -> float:
    """EXACT area of intersection of two ellipses: quartic intersection
    points + elliptic-segment decomposition
    (reference: EllipseIntersection.cpp::analytic_intersection_area).
    """
    pts = ellipse_intersection_points(c1, a1, t1, c2, a2, t2)
    area1 = np.pi * float(a1[0]) * float(a1[1])
    area2 = np.pi * float(a2[0]) * float(a2[1])

    if len(pts) < 2:
        if (_ellipse_contains(c1, a1, t1, c2) or
                _ellipse_contains(c2, a2, t2, c1)):
            return min(area1, area2)
        return 0.0

    # Sort intersection points by polar angle about their centroid.
    centroid = pts.mean(axis=0)
    ang = np.arctan2(pts[:, 1] - centroid[1], pts[:, 0] - centroid[0])
    pts = pts[np.argsort(ang)]
    n = len(pts)

    def orientations(center, axes, angle):
        ca, sa = np.cos(angle), np.sin(angle)
        u = np.array([ca, sa])
        v = np.array([-sa, ca])
        d = pts - np.asarray(center, float)
        return np.arctan2(d @ v, d @ u)

    o1 = orientations(c1, a1, t1)
    o2 = orientations(c2, a2, t2)

    area = 0.0
    for i in range(n):
        j = (i - 1) % n
        th0, th1 = o1[j], o1[i]
        if th0 > th1:
            th1 += 2 * np.pi
        ps0, ps1 = o2[j], o2[i]
        if ps0 > ps1:
            ps1 += 2 * np.pi
        area += min(ellipse_segment_area(a1, c1, t1, th0, th1),
                    ellipse_segment_area(a2, c2, t2, ps0, ps1))
    if n > 2:
        for i in range(n):
            j = (i - 1) % n
            area += 0.5 * (pts[j, 0] * pts[i, 1] - pts[i, 0] * pts[j, 1])
    return float(area)


def ellipse_jaccard_similarity(c1, a1, t1, c2, a2, t2) -> float:
    """Exact intersection-over-union of two ellipses
    (reference: EllipseIntersection.cpp::analytic_jaccard_similarity)."""
    inter = ellipse_intersection_area(c1, a1, t1, c2, a2, t2)
    union = (np.pi * float(a1[0]) * float(a1[1])
             + np.pi * float(a2[0]) * float(a2[1]) - inter)
    return inter / union if union > 0 else 0.0
