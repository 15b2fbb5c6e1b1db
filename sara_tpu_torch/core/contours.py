"""Contours and regions: border following, boundary tracing, circle fit,
polyline statistics.

Twin of ``sara_tpu/core/contours.py``, a host module in both packages:
these algorithms are sequential pointer-chasing, which the reference also
runs on the CPU. The port keeps its own copy of the NumPy code. Every
entry point also takes a tensor from any device and brings it to the host
itself (one device-to-host copy per argument); results are NumPy, as in
the twin.

- Suzuki-Abe hierarchical border following
  (reference: cpp/src/DO/Sara/Geometry/Algorithms/BorderFollowing.hpp:23-276);
- Moore region inner-boundary tracing
  (reference: cpp/src/DO/Sara/Geometry/Algorithms/Region.cpp:21-112);
- direct circle fit by perpendicular bisectors
  (reference: cpp/src/DO/Sara/Geometry/Algorithms/CircleFit.hpp:29-65);
- polyline length / directional mean / center of mass / inertia
  (reference: cpp/src/DO/Sara/Geometry/Algorithms/Polyline.hpp:23-125).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from enum import IntEnum
from typing import Dict, List

import numpy as np
import torch


def _host(a) -> np.ndarray:
    """``a`` as a NumPy array; a tensor comes to the host from its device."""
    if isinstance(a, torch.Tensor):
        return a.detach().cpu().numpy()
    return np.asarray(a)


class BorderType(IntEnum):
    NON_BORDER = 0
    OUTER = 1
    HOLE = 2


@dataclass
class Border:
    """One traced border: id, parent border id, type, and the (x, y) curve
    (reference: BorderFollowing.hpp::Border)."""

    id: int
    parent: int
    type: BorderType
    curve: List[np.ndarray] = field(default_factory=list)


# Clockwise 8-neighborhood directions starting East
_CW = np.array([(1, 0), (1, 1), (0, 1), (-1, 1),
                (-1, 0), (-1, -1), (0, -1), (1, -1)])
# Counterclockwise directions starting East
_CCW = np.array([(1, 0), (1, -1), (0, -1), (-1, -1),
                 (-1, 0), (-1, 1), (0, 1), (1, 1)])


def _dir_index(dirs, d):
    for i, v in enumerate(dirs):
        if v[0] == d[0] and v[1] == d[1]:
            return i
    raise ValueError(d)


def _follow_border(f, p, p2, nbd):
    """Trace one border starting at p with initial probe p2, marking f with
    +/-nbd (Suzuki-Abe steps 3.1-3.5; reference:
    BorderFollowing.hpp::follow_border)."""
    H, W = f.shape
    curve = [p.copy()]

    def inside(q):
        return 0 <= q[0] < W and 0 <= q[1] < H

    # (3.1) first nonzero pixel p1 clockwise from p2 around p.
    start = _dir_index(_CW, p2 - p)
    p1 = None
    for i in range(8):
        q = p + _CW[(start + i) % 8]
        if inside(q) and f[q[1], q[0]] != 0:
            p1 = q
            break
    if p1 is None:
        f[p[1], p[0]] = -nbd  # isolated pixel
        return curve

    # (3.2)
    p2 = p1.copy()
    p3 = p.copy()
    while True:
        # (3.3) next nonzero pixel p4 counterclockwise from p2 around p3.
        start = _dir_index(_CCW, p2 - p3)
        p4 = None
        examined_east = False
        for i in range(1, 9):
            q = p3 + _CCW[(start + i) % 8]
            if not inside(q):
                if (q - p3)[0] == 1 and (q - p3)[1] == 0:
                    examined_east = True
                continue
            if f[q[1], q[0]] != 0:
                p4 = q
                break
            if (q - p3)[0] == 1 and (q - p3)[1] == 0:
                examined_east = True
        # (3.4) marking.
        if examined_east and (p3[0] + 1 >= W or f[p3[1], p3[0] + 1] == 0):
            f[p3[1], p3[0]] = -nbd
        elif f[p3[1], p3[0]] == 1:
            f[p3[1], p3[0]] = nbd
        if p4 is None:
            break
        # (3.5) termination: back at the start in the same configuration.
        if (p4 == p).all() and (p3 == p1).all():
            break
        curve.append(p4.copy())
        p2 = p3
        p3 = p4
    return curve


def suzuki_abe_borders(binary) -> Dict[int, Border]:
    """Hierarchical border following of a binary image (Suzuki & Abe 1985).

    Returns {border_id: Border} with the outer/hole topology tree
    (reference: BorderFollowing.hpp::suzuki_abe_follow_border — same
    algorithm, same border ids: the frame is border 1).
    """
    f = _host(binary).astype(np.int32).copy()
    H, W = f.shape
    borders: Dict[int, Border] = {
        1: Border(id=1, parent=-1, type=BorderType.HOLE)}
    nbd = 1
    for y in range(H):
        lnbd = 1
        for x in range(W):
            v = f[y, x]
            if v == 0:
                continue
            is_outer = v == 1 and (x == 0 or f[y, x - 1] == 0)
            is_hole = v >= 1 and (x == W - 1 or f[y, x + 1] == 0)
            if is_outer or is_hole:
                if is_hole and v > 1:
                    lnbd = v
                nbd += 1
                btype = BorderType.OUTER if is_outer else BorderType.HOLE
                # Parent decision table (Suzuki-Abe table 1).
                prev = borders[abs(lnbd)]
                if prev.type == btype:
                    parent = prev.parent
                else:
                    parent = prev.id
                p = np.array([x, y])
                p2 = np.array([x - 1, y]) if is_outer else np.array([x + 1, y])
                curve = _follow_border(f, p, p2, nbd)
                borders[nbd] = Border(id=nbd, parent=parent, type=btype,
                                      curve=curve)
            if f[y, x] != 1:
                lnbd = abs(f[y, x])
    return borders


def region_inner_boundary(regions, region_id: int,
                          connectivity: int = 8) -> np.ndarray:
    """Moore boundary tracing of one labeled region; returns (N, 2) (x, y)
    (reference: Region.cpp::compute_region_inner_boundary)."""
    regions = _host(regions)
    H, W = regions.shape
    ys, xs = np.nonzero(regions == region_id)
    if len(ys) == 0:
        return np.zeros((0, 2), int)
    order = np.lexsort((xs, ys))
    start = np.array([xs[order[0]], ys[order[0]]])
    dirs = _CW if connectivity == 8 else np.array([(1, 0), (0, 1),
                                                   (-1, 0), (0, -1)])
    nd = len(dirs)
    boundary = [start]
    d = 7 if connectivity == 8 else 0
    while True:
        cur = boundary[-1]
        d = (d + 7) % 8 if (connectivity == 8 and d % 2 == 0) else (
            (d + 6) % 8 if connectivity == 8 else (d + 3) % 4)
        advanced = False
        for k in range(nd):
            q = cur + dirs[(d + k) % nd]
            if not (0 <= q[0] < W and 0 <= q[1] < H):
                continue
            if regions[q[1], q[0]] == region_id:
                boundary.append(q)
                d = (d + k) % nd
                advanced = True
                break
        if not advanced:
            break  # isolated pixel
        if (boundary[-1] == start).all():
            boundary.pop()
            break
    return np.asarray(boundary)


def region_grow(image, seed, predicate, connectivity: int = 4) -> np.ndarray:
    """Flood-fill region growing from ``seed`` over pixels satisfying
    ``predicate(image_value)``; returns a bool mask. BFS frontier expansion
    vectorized per ring (the device analog lives in
    matching/propagation.py; this is the host utility the reference's
    Region tools assume)."""
    img = _host(image)
    H, W = img.shape[:2]
    ok = predicate(img)
    mask = np.zeros((H, W), bool)
    sx, sy = (int(v) for v in _host(seed)[:2])
    if not ok[sy, sx]:
        return mask
    mask[sy, sx] = True
    frontier = [(sx, sy)]
    if connectivity == 4:
        dirs = ((1, 0), (-1, 0), (0, 1), (0, -1))
    else:
        dirs = tuple(map(tuple, _CW))
    while frontier:
        nxt = []
        for x, y in frontier:
            for dx, dy in dirs:
                qx, qy = x + dx, y + dy
                if 0 <= qx < W and 0 <= qy < H and not mask[qy, qx] \
                        and ok[qy, qx]:
                    mask[qy, qx] = True
                    nxt.append((qx, qy))
        frontier = nxt
    return mask


def fit_circle(points):
    """Direct circle fit via perpendicular bisectors: returns (center (2,),
    radius) (reference: CircleFit.hpp::fit_circle_2d — same normal
    equations, K. Jones' derivation)."""
    p = _host(points).astype(float)
    x, y = p[:, 0], p[:, 1]
    n = len(p)
    x2, y2 = x * x, y * y
    A = n * x2.sum() - x.sum() ** 2
    B = n * (x * y).sum() - x.sum() * y.sum()
    C = n * y2.sum() - y.sum() ** 2
    D = 0.5 * (n * (x * y2).sum() - x.sum() * y2.sum()
               + n * (x * x2).sum() - x.sum() * x2.sum())
    E = 0.5 * (n * (y * x2).sum() - y.sum() * x2.sum()
               + n * (y * y2).sum() - y.sum() * y2.sum())
    den = A * C - B * B
    c = np.array([(D * C - B * E) / den, (A * E - B * D) / den])
    r = float(np.hypot(x - c[0], y - c[1]).mean())
    return c, r


# ---------------------------------------------------------------------------
# Polyline statistics (reference: Polyline.hpp).
# ---------------------------------------------------------------------------

def polyline_length(p) -> float:
    p = _host(p).astype(float)
    return float(np.linalg.norm(np.diff(p, axis=0), axis=1).sum())


def polyline_directional_mean(p) -> float:
    """Linear directional mean angle of the segments
    (reference: Polyline.hpp::linear_directional_mean)."""
    p = _host(p).astype(float)
    d = np.diff(p, axis=0)
    ang = np.arctan2(d[:, 1], d[:, 0])
    return float(np.arctan2(np.sin(ang).sum(), np.cos(ang).sum()))


def polyline_center_of_mass(p) -> np.ndarray:
    """Length-weighted centroid of the polyline
    (reference: Polyline.hpp::center_of_mass)."""
    p = _host(p).astype(float)
    a, b = p[:-1], p[1:]
    li = np.linalg.norm(b - a, axis=1)
    ci = 0.5 * (a + b)
    L = li.sum()
    if L == 0:
        return p.mean(axis=0)
    return (ci * li[:, None]).sum(axis=0) / L


def polyline_matrix_of_inertia(p, center=None) -> np.ndarray:
    """Length-weighted 2x2 second-moment matrix about the center of mass
    (reference: Polyline.hpp::matrix_of_inertia)."""
    p = _host(p).astype(float)
    center = (polyline_center_of_mass(p) if center is None
              else _host(center).astype(float))
    a, b = p[:-1], p[1:]
    li = np.linalg.norm(b - a, axis=1)
    L = li.sum()
    if L == 0:
        d = p - center
        return (d.T @ d) / max(len(p), 1)
    cx, cy = center
    m00 = ((a[:, 0] ** 2 + b[:, 0] ** 2 - 2 * cx * cx) * li).sum()
    m11 = ((a[:, 1] ** 2 + b[:, 1] ** 2 - 2 * cy * cy) * li).sum()
    m01 = ((a[:, 0] * a[:, 1] + b[:, 0] * b[:, 1] - 2 * cx * cy) * li).sum()
    return np.array([[m00, m01], [m01, m11]]) / (2 * L)
