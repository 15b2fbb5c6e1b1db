"""Port parity: ``core/contours.py``.

Both packages run the same host algorithms in NumPy (border following,
boundary tracing, region growing, the circle fit, polyline statistics), so
the port is held to the twin exactly: the same border ids, parents, types
and curves, the same boundary and region masks, and float results equal to
the last bit. The cases are the twins of the contour cases of
``tests/test_geometry_contours.py`` (its circle fits, border following,
region boundaries and polyline statistics), each also run on torch tensors,
which the port brings to the host itself.
"""

import numpy as np
import pytest
import torch

from sara_tpu.core import contours as jc
from sara_tpu_torch.core import contours as tc


def _blob_with_hole(n=32):
    img = np.zeros((n, n), np.int32)
    img[6:26, 6:26] = 1
    img[12:20, 12:20] = 0
    return img


def _two_rects():
    img = np.zeros((20, 40), np.int32)
    img[4:9, 4:12] = 1
    img[10:16, 20:33] = 1
    return img


def _random_blobs(seed=0, shape=(48, 64)):
    """Smoothed noise thresholded: nested outer borders and holes."""
    rs = np.random.RandomState(seed)
    f = rs.rand(*shape)
    for _ in range(3):
        f = (f + np.roll(f, 1, 0) + np.roll(f, -1, 0) + np.roll(f, 1, 1)
             + np.roll(f, -1, 1)) / 5
    return (f > np.median(f)).astype(np.int32)


def _same_borders(bt, bj):
    assert sorted(bt) == sorted(bj)
    for k in bj:
        assert (bt[k].id, bt[k].parent, int(bt[k].type)) == (
            bj[k].id, bj[k].parent, int(bj[k].type))
        assert np.array_equal(np.asarray(bt[k].curve).reshape(-1, 2),
                              np.asarray(bj[k].curve).reshape(-1, 2))


def _both(a):
    """The input as given, and as a CPU tensor."""
    return [a, torch.from_numpy(np.ascontiguousarray(a))]


# --- circle fit ------------------------------------------------------------

def test_circle_fit_exact_on_clean_points():
    t = np.linspace(0, 2 * np.pi, 40, endpoint=False)
    pts = np.stack([3 + 2.5 * np.cos(t), -1 + 2.5 * np.sin(t)], axis=1)
    cj, rj = jc.fit_circle(pts)
    for p in _both(pts):
        c, r = tc.fit_circle(p)
        np.testing.assert_allclose(c, [3, -1], atol=1e-9)
        assert abs(r - 2.5) < 1e-9
        assert np.array_equal(c, cj) and r == rj


def test_circle_fit_noisy_arc():
    rs = np.random.RandomState(1)
    t = np.linspace(0.3, 2.2, 60)
    pts = np.stack([10 + 5 * np.cos(t), 4 + 5 * np.sin(t)], axis=1)
    pts += rs.normal(scale=0.02, size=pts.shape)
    cj, rj = jc.fit_circle(pts)
    for p in _both(pts):
        c, r = tc.fit_circle(p)
        np.testing.assert_allclose(c, [10, 4], atol=0.1)
        assert abs(r - 5) < 0.1
        assert np.array_equal(c, cj) and r == rj


# --- border following / region boundaries ----------------------------------

def test_suzuki_abe_outer_and_hole_borders():
    img = _blob_with_hole()
    for x in _both(img):
        borders = tc.suzuki_abe_borders(x)
        _same_borders(borders, jc.suzuki_abe_borders(img))
        outers = [b for b in borders.values()
                  if b.type == tc.BorderType.OUTER]
        holes = [b for b in borders.values()
                 if b.type == tc.BorderType.HOLE and b.id != 1]
        assert len(outers) == 1 and len(holes) == 1
        assert holes[0].parent == outers[0].id and outers[0].parent == 1
        curve = np.asarray(outers[0].curve)
        assert curve[:, 0].min() == 6 and curve[:, 0].max() == 25
        assert curve[:, 1].min() == 6 and curve[:, 1].max() == 25
        on_border = ((curve[:, 0] == 6) | (curve[:, 0] == 25)
                     | (curve[:, 1] == 6) | (curve[:, 1] == 25))
        assert on_border.all()


def test_suzuki_abe_two_components():
    img = _two_rects()
    for x in _both(img):
        borders = tc.suzuki_abe_borders(x)
        _same_borders(borders, jc.suzuki_abe_borders(img))
        outers = [b for b in borders.values()
                  if b.type == tc.BorderType.OUTER]
        assert len(outers) == 2
        lens = sorted(len(b.curve) for b in outers)
        assert lens[0] == 2 * (7 + 4)
        assert lens[1] == 2 * (12 + 5)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_suzuki_abe_random_blobs(seed):
    """Seeded blobs with nested holes: every border, parent and curve equal
    to the twin's, from a NumPy array and from a bool tensor."""
    img = _random_blobs(seed)
    want = jc.suzuki_abe_borders(img)
    assert len(want) > 4
    _same_borders(tc.suzuki_abe_borders(img), want)
    _same_borders(tc.suzuki_abe_borders(torch.from_numpy(img > 0)), want)


@pytest.mark.parametrize("connectivity", [8, 4])
def test_region_inner_boundary_rectangle(connectivity):
    img = np.zeros((16, 16), np.int32)
    img[3:9, 4:12] = 7
    want = jc.region_inner_boundary(img, 7, connectivity)
    for x in _both(img):
        b = tc.region_inner_boundary(x, 7, connectivity)
        assert np.array_equal(b, want)
        if connectivity == 8:
            assert len(b) == 2 * (7 + 5)
        assert b[:, 0].min() == 4 and b[:, 0].max() == 11
        assert b[:, 1].min() == 3 and b[:, 1].max() == 8
        assert all(img[y, x_] == 7 for x_, y in b)
    assert len(tc.region_inner_boundary(img, 3)) == 0


@pytest.mark.parametrize("seed", [0, 1])
def test_region_inner_boundary_of_each_component(seed):
    """The boundary of every label of a seeded labelling, equal to the
    twin's."""
    from scipy import ndimage

    lab, n = ndimage.label(_random_blobs(seed))
    assert n > 2
    for r in range(1, n + 1):
        assert np.array_equal(tc.region_inner_boundary(lab, r),
                              jc.region_inner_boundary(lab, r))


@pytest.mark.parametrize("connectivity", [4, 8])
def test_region_grow_flood(connectivity):
    img = np.zeros((24, 24), np.float32)
    img[5:15, 5:15] = 1.0
    img[8:12, 14:20] = 1.0  # attached arm
    img[15, 15] = 1.0       # a diagonal neighbour of the square's corner
    want = jc.region_grow(img, (6, 6), lambda v: v > 0.5, connectivity)
    for x in _both(img):
        mask = tc.region_grow(x, (6, 6), lambda v: v > 0.5, connectivity)
        assert np.array_equal(mask, want)
        assert mask.sum() == 10 * 10 + 4 * 5 + (connectivity == 8)
        assert not mask[0, 0]
    assert not tc.region_grow(img, (0, 0), lambda v: v > 0.5).any()


# --- polyline statistics ---------------------------------------------------

def test_polyline_stats():
    p = np.array([[0, 0], [3, 0], [3, 4]], float)
    expected = (np.array([1.5, 0.0]) * 3 + np.array([3.0, 2.0]) * 4) / 7
    for x in _both(p):
        assert abs(tc.polyline_length(x) - 7) < 1e-12
        com = tc.polyline_center_of_mass(x)
        np.testing.assert_allclose(com, expected, atol=1e-12)
        assert np.array_equal(com, jc.polyline_center_of_mass(p))


def test_polyline_directional_mean_straightish():
    p = np.array([[0, 0], [1, 0.1], [2, -0.1], [3, 0]], float)
    for x in _both(p):
        ang = tc.polyline_directional_mean(x)
        assert abs(ang) < 0.05
        assert ang == jc.polyline_directional_mean(p)


def test_polyline_inertia_of_line():
    p = np.array([[0, 0], [10, 0]], float)
    for x in _both(p):
        M = tc.polyline_matrix_of_inertia(x)
        assert M[0, 0] > 0
        assert abs(M[1, 1]) < 1e-12
        assert abs(M[0, 1]) < 1e-12
        assert np.array_equal(M, jc.polyline_matrix_of_inertia(p))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_polyline_statistics_random(seed):
    """Random polylines, a degenerate one (all points equal) and a given
    centre: every statistic equal to the twin's."""
    rs = np.random.RandomState(seed)
    p = np.cumsum(rs.normal(size=(12, 2)), 0)
    still = np.repeat(p[:1], 4, 0)
    for q in (p, still, p.astype(np.float32)):
        for x in _both(q):
            assert tc.polyline_length(x) == jc.polyline_length(q)
            assert tc.polyline_directional_mean(x) == \
                jc.polyline_directional_mean(q)
            assert np.array_equal(tc.polyline_center_of_mass(x),
                                  jc.polyline_center_of_mass(q))
            assert np.array_equal(tc.polyline_matrix_of_inertia(x),
                                  jc.polyline_matrix_of_inertia(q))
            c = np.array([0.5, -1.0])
            assert np.array_equal(
                tc.polyline_matrix_of_inertia(x, torch.from_numpy(c)),
                jc.polyline_matrix_of_inertia(q, c))
