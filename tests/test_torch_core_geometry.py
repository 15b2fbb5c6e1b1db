"""Port parity: ``core/geometry.py``.

The host algorithms (hull, Ramer-Douglas-Peucker, clipping, area,
point-in-polygon, the exact ellipse intersection) run in float64 NumPy in
both packages and are held to 1e-9; the batched ellipse functions
(``fit_ellipse``, ``ellipse_parameters``, ``ellipse_points``) run in torch
and are held to 1e-9 in float64 (a conic's sign is its solver's, so the
fitted conics are compared up to sign). The cases are twins of the
ellipse cases of ``tests/test_geometry_contours.py``; its circle fits
belong to ``core/contours``, which is not ported yet, and the conic fit
of a circle's points stands in for them here.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from sara_tpu.core import geometry as jg
from sara_tpu_torch.core import geometry as tg

TOL = 1e-9


def _pairs(seed, n, lo, hi, spread):
    rs = np.random.RandomState(seed)
    out = []
    for _ in range(n):
        c1 = rs.uniform(-spread, spread, 2)
        c2 = rs.uniform(-spread, spread, 2)
        ax1 = np.sort(rs.uniform(lo, hi, 2))[::-1]
        ax2 = np.sort(rs.uniform(lo, hi, 2))[::-1]
        t1, t2 = rs.uniform(0, np.pi, 2)
        out.append((c1, ax1, t1, c2, ax2, t2))
    return out


CASES = {
    "identical_circles": ((0, 0), (2, 2), 0.0, (0, 0), (2, 2), 0.0),
    "contained": ((0, 0), (5, 4), 0.3, (0.5, 0), (1, 0.5), 1.0),
    "disjoint": ((0, 0), (1, 1), 0.0, (5, 0), (1, 1), 0.0),
    "lens": ((0, 0), (1, 1), 0.0, (1.0, 0), (1, 1), 0.0),
    "jaccard": ((0, 0), (2, 1), 0.2, (0.5, 0.2), (2, 1), 0.4),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_ellipse_area_and_jaccard_cases(case):
    args = CASES[case]
    a = tg.ellipse_intersection_area(*args)
    assert abs(a - jg.ellipse_intersection_area(*args)) < TOL
    j = tg.ellipse_jaccard_similarity(*args)
    assert abs(j - jg.ellipse_jaccard_similarity(*args)) < TOL
    if case == "lens":
        assert abs(a - (2 * np.arccos(0.5) - 0.5 * np.sqrt(3))) < TOL


def test_intersection_points_random_pairs():
    for args in _pairs(3, 20, 0.5, 3.0, 1.0):
        pj = jg.ellipse_intersection_points(*args)
        pt = tg.ellipse_intersection_points(*args)
        assert pj.shape == pt.shape and len(pt) <= 4
        np.testing.assert_allclose(pt, pj, atol=TOL, rtol=0)
        s = tg.conic_equation_of_ellipse(*args[:3])
        t = tg.conic_equation_of_ellipse(*args[3:])
        for p in pt:
            assert abs(tg._conic_at(s, *p)) < 1e-6
            assert abs(tg._conic_at(t, *p)) < 1e-6


def test_exact_and_polygonal_areas_random_pairs():
    """The exact area, and the polygonal one (ellipse_points sampled in
    torch, clipped on the host), which converges on the exact one."""
    for args in _pairs(0, 6, 0.8, 2.5, 0.5):
        exact = tg.ellipse_intersection_area(*args)
        assert abs(exact - jg.ellipse_intersection_area(*args)) < TOL
        a = tg.ellipse_intersection_area_polygonal(*args, n=128)
        assert abs(a - jg.ellipse_intersection_area_polygonal(
            *args, n=128)) < 1e-6
        assert abs(a - exact) < 1e-2 * exact


def test_sector_and_segment_areas():
    for th0, th1 in ((-np.pi, np.pi), (0.2, 1.4), (0.5, 4.0)):
        assert abs(tg.ellipse_sector_area((3, 2), th0, th1)
                   - jg.ellipse_sector_area((3, 2), th0, th1)) < TOL
        assert abs(tg.ellipse_segment_area((3, 2), (1, -1), 0.3, th0, th1)
                   - jg.ellipse_segment_area((3, 2), (1, -1), 0.3, th0,
                                             th1)) < TOL
    assert abs(tg.ellipse_sector_area((3, 2), -np.pi, np.pi)
               - 6 * np.pi) < TOL


@pytest.mark.parametrize("noise", [0.0, 0.02], ids=["clean", "noisy"])
def test_fit_ellipse_and_parameters(noise):
    """Conic fits in float64 of an ellipse's boundary and of a circle's
    (the circle fits' twin): the conic up to sign, then centre, axes and
    angle, then boundary samples."""
    rs = np.random.RandomState(1)
    for c, ax, th in (((3.0, -1.0), (2.5, 2.5), 0.0),
                      ((10.0, 4.0), (5.0, 2.0), 0.7)):
        pts = np.asarray(jg.ellipse_points(jnp.asarray(c), jnp.asarray(ax),
                                           jnp.asarray(th), 40))
        pts = pts + rs.normal(scale=noise, size=pts.shape)
        cj = np.asarray(jg.fit_ellipse(pts))
        ct = tg.fit_ellipse(pts)
        assert ct.dtype == torch.float64
        ct = ct.numpy()
        np.testing.assert_allclose(ct * np.sign(ct @ cj), cj, atol=TOL,
                                   rtol=0)
        for j, t in zip(jg.ellipse_parameters(jnp.asarray(cj)),
                        tg.ellipse_parameters(torch.from_numpy(cj.copy()))):
            np.testing.assert_allclose(t.numpy(), np.asarray(j), atol=TOL,
                                       rtol=0)
        centre, axes, angle = tg.ellipse_parameters(
            torch.from_numpy(cj.copy()))
        np.testing.assert_allclose(centre.numpy(), c, atol=0.1)
        np.testing.assert_allclose(axes.numpy(), ax, atol=0.1)
        np.testing.assert_allclose(
            tg.ellipse_points(centre, axes, angle, 16).numpy(),
            np.asarray(jg.ellipse_points(*(jnp.asarray(v.numpy()) for v in
                                           (centre, axes, angle)), 16)),
            atol=TOL, rtol=0)


def test_fit_ellipse_float32_input():
    """A float32 host array fits in float32, as in the twin."""
    pts = np.asarray(jg.ellipse_points(jnp.asarray([1.0, 2.0]),
                                       jnp.asarray([3.0, 1.5]),
                                       jnp.asarray(0.4), 32), np.float32)
    ct = tg.fit_ellipse(pts)
    assert ct.dtype == torch.float32
    cj = np.asarray(jg.fit_ellipse(pts))
    np.testing.assert_allclose(ct.numpy() * np.sign(ct.numpy() @ cj), cj,
                               atol=1e-4)


def test_polygon_algorithms():
    rs = np.random.RandomState(5)
    pts = rs.uniform(-3, 3, (60, 2))
    hj, ht = jg.convex_hull(pts), tg.convex_hull(pts)
    np.testing.assert_array_equal(ht, hj)
    assert tg.polygon_area(ht) > 0
    assert abs(tg.polygon_area(ht) - jg.polygon_area(hj)) < TOL
    square = np.array([[0.0, 0], [2, 0], [2, 2], [0, 2]])
    tri = np.array([[1.0, -1], [3, 1], [1, 3]])
    np.testing.assert_allclose(tg.clip_polygon(tri, square),
                               jg.clip_polygon(tri, square), atol=TOL)
    for p in rs.uniform(-1, 3, (20, 2)):
        assert tg.point_in_polygon(p, tri) == jg.point_in_polygon(p, tri)


@pytest.mark.parametrize("eps", [0.05, 0.5, 2.0])
def test_ramer_douglas_peucker(eps):
    t = np.linspace(0, 3 * np.pi, 200)
    poly = np.stack([t * 3, np.sin(t) * 4 + 0.01 * np.cos(7 * t)], axis=1)
    np.testing.assert_array_equal(tg.ramer_douglas_peucker(poly, eps),
                                  jg.ramer_douglas_peucker(poly, eps))
