"""Chessboard square reconstruction from corners + edge chains.

Twin of ``sara_tpu/calib/squares.py``: the robustness layer for distorted
views. The greedy lattice BFS of ``calib.chessboard`` predicts neighbour
positions linearly and breaks under strong (fisheye / omnidirectional)
distortion; this path only assumes each square's four EDGES are observable
as curved chains. Only the edge chains (``image.edge_chains``) touch the
device; the square walks and the square-graph integer embedding are host
graph work, as in the twin.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from sara_tpu_torch.image.edge_chains import LineSegmentParams, edge_chains


def _chain_edges_between_corners(chains: List[np.ndarray],
                                 corners: np.ndarray,
                                 attach_radius: float):
    """Match chain endpoints to corners; returns per-edge statistics.

    An edge is a chain whose two ends each lie within ``attach_radius`` of
    distinct corners. Returns (edges (E, 2) corner indices, mean direction
    normal (E, 2), straightness (E,)).
    """
    from scipy.spatial import cKDTree

    tree = cKDTree(corners)
    # Chains run THROUGH x-corners (the edgel orientation is continuous
    # across them), so first cut every chain at its corner passages:
    # runs of points within attach_radius of a corner become cut events,
    # and the pieces between consecutive events are candidate edges.
    pieces = []
    for ch in chains:
        if len(ch) < 3:
            continue
        d, ci = tree.query(ch)
        near = d < attach_radius
        events = []            # (position along chain, corner id)
        k = 0
        while k < len(ch):
            if near[k]:
                j = k
                while j + 1 < len(ch) and near[j + 1]:
                    j += 1
                kk = k + int(np.argmin(d[k:j + 1]))
                events.append((kk, int(ci[kk])))
                k = j + 1
            else:
                k += 1
        for (k0, c0), (k1, c1) in zip(events, events[1:]):
            if c0 != c1 and k1 - k0 >= 2:
                pieces.append((ch[k0:k1 + 1], c0, c1))

    edges, normals, straight = [], [], []
    for ch, ia, ib in pieces:
        # Gradient statistics along the chain: the mean NORMAL of the
        # curve (reference edge_grad_mean). The curve tangent is the
        # local difference; its left normal approximates the gradient
        # direction up to sign — sign is fixed later by winding checks,
        # so we only need a consistent orientation per chain.
        t = np.diff(ch, axis=0)
        t = t / np.maximum(np.linalg.norm(t, axis=1, keepdims=True), 1e-9)
        nvec = np.stack([-t[:, 1], t[:, 0]], axis=1)
        # Make signs consistent along the chain before averaging.
        sgn = np.where((nvec @ nvec[0]) < 0, -1.0, 1.0)
        nvec = nvec * sgn[:, None]
        mean_n = nvec.mean(axis=0)
        norm = np.linalg.norm(mean_n)
        if norm < 1e-6:
            continue
        # Straightness: covariance cornerness test of the reference
        # (grad_cov det - kappa tr^2 <= 0 means straight); equivalent
        # here to the normals being concentrated.
        cov = (nvec - mean_n).T @ (nvec - mean_n) / len(nvec)
        cornerness = np.linalg.det(cov) - 0.2 * np.trace(cov) ** 2
        edges.append((int(ia), int(ib)))
        normals.append(mean_n / norm)
        straight.append(cornerness <= 0)
    if not edges:
        return (np.zeros((0, 2), int), np.zeros((0, 2)), np.zeros(0, bool))
    return np.asarray(edges), np.asarray(normals), np.asarray(straight)


def _walk_square(seed: int, first_edge: int, corners: np.ndarray,
                 edges: np.ndarray, inc: Dict[int, List[int]],
                 sign: float) -> Optional[tuple]:
    """Walk 4 edges starting at ``seed`` keeping a consistent winding
    (reference reconstruct_square_from_corner — the reference winds by
    gradient normals, which also classifies black/white; here the turn
    determinant of the corner DIRECTIONS serves the same purpose with no
    normal-sign ambiguity, and ``sign`` = +1/-1 explores both
    handednesses)."""
    square = [seed]
    edge = first_edge
    for _ in range(3):
        a, b = edges[edge]
        nxt = b if a == square[-1] else a
        if nxt in square:
            return None
        prev = square[-1]
        square.append(int(nxt))
        d1 = corners[nxt] - corners[prev]
        d1 = d1 / max(np.linalg.norm(d1), 1e-9)
        # Next edge: incident to nxt, making the sharpest consistent-
        # handed ~90-degree turn.
        best, best_det = -1, 0.5
        for e in inc.get(int(nxt), []):
            if e == edge:
                continue
            a2, b2 = edges[e]
            nxt2 = b2 if a2 == nxt else a2
            if nxt2 in square[1:]:
                continue
            d2 = corners[nxt2] - corners[nxt]
            d2 = d2 / max(np.linalg.norm(d2), 1e-9)
            det = sign * (d1[0] * d2[1] - d1[1] * d2[0])
            if det > best_det:
                best, best_det = e, det
        if best < 0:
            return None
        edge = best
    # Closing edge must connect back to the seed.
    a, b = edges[edge]
    if {int(a), int(b)} != {seed, square[-1]}:
        return None
    # Validate rough side-length consistency (reference: parallel sides
    # comparable even under distortion).
    p = corners[square]
    L = [np.linalg.norm(p[(i + 1) % 4] - p[i]) for i in range(4)]
    if max(L) > 3.0 * min(L):
        return None
    # Canonical form: min corner first, then the smaller of the two
    # traversal directions — both windings map to ONE tuple.
    k = int(np.argmin(square))
    cyc = square[k:] + square[:k]
    rev = [cyc[0]] + cyc[1:][::-1]
    return tuple(min(cyc, rev))


def reconstruct_squares(corners: np.ndarray, chains: List[np.ndarray],
                        attach_radius: float = 5.0) -> List[tuple]:
    """All unambiguous 4-cycles (squares) over the corner/edge-chain graph."""
    edges, normals, straight = _chain_edges_between_corners(
        chains, corners, attach_radius)
    inc: Dict[int, List[int]] = {}
    seen_pairs = set()
    for e, (a, b) in enumerate(edges):
        if not straight[e]:
            continue
        key = (min(a, b), max(a, b))
        if key in seen_pairs:
            continue
        seen_pairs.add(key)
        inc.setdefault(int(a), []).append(e)
        inc.setdefault(int(b), []).append(e)
    found = set()
    for c, ces in inc.items():
        for e in ces:
            for sign in (1.0, -1.0):
                sq = _walk_square(c, e, corners, edges, inc, sign)
                if sq is not None:
                    found.add(sq)
    return sorted(found)


def squares_to_grid(corners: np.ndarray,
                    squares: List[tuple]) -> Optional[np.ndarray]:
    """Integer lattice embedding of the square graph
    (reference: SquareGraph.hpp). Returns (rows, cols, 2) corner grid.

    BFS over squares sharing an edge. A neighbor square's two unknown
    corners lie on one of the two lattice sides of the shared edge; the
    side is disambiguated GEOMETRICALLY (a local affine frame fitted to
    already-placed corners predicts both candidates; the closer one
    wins), so the embedding follows the board even under distortion.
    """
    if not squares:
        return None
    edge_of: Dict[tuple, List[int]] = {}
    for si, sq in enumerate(squares):
        for k in range(4):
            key = tuple(sorted((sq[k], sq[(k + 1) % 4])))
            edge_of.setdefault(key, []).append(si)
    coords: Dict[int, Tuple[int, int]] = {}

    # Seed square -> unit cell (winding arbitrary; fixes the global
    # handedness).
    sq0 = squares[0]
    for c, pos in zip(sq0, [(0, 0), (0, 1), (1, 1), (1, 0)]):
        coords[c] = pos

    def _affine_predict(anchor_corners):
        """LS affine map lattice->image from placed corners near the
        shared edge."""
        A = np.asarray([[*coords[c], 1.0] for c in anchor_corners])
        Y = corners[list(anchor_corners)]
        M, *_ = np.linalg.lstsq(A, Y, rcond=None)
        return lambda ij: np.asarray([ij[0], ij[1], 1.0]) @ M

    placed = {0}
    frontier = [0]
    while frontier:
        si = frontier.pop()
        sq = squares[si]
        for k in range(4):
            u, v = sq[k], sq[(k + 1) % 4]
            key = tuple(sorted((u, v)))
            for sj in edge_of.get(key, []):
                if sj in placed:
                    continue
                sq2 = list(squares[sj])
                if u not in coords or v not in coords:
                    continue
                # Rotate sq2's cycle so it starts u -> v.
                if v not in sq2 or u not in sq2:
                    continue
                iu = sq2.index(u)
                cyc = sq2[iu:] + sq2[:iu]
                if cyc[1] != v:
                    cyc = [cyc[0]] + cyc[1:][::-1]   # reverse winding
                    if cyc[1] != v:
                        continue
                w, z = cyc[2], cyc[3]                # v-w and z-u adjacent
                cu = np.asarray(coords[u])
                cv = np.asarray(coords[v])
                step = cv - cu
                if abs(step).sum() != 1:
                    continue
                perp = np.asarray([-step[1], step[0]])
                anchors = [c for c in sq if c in coords]
                predict = _affine_predict(anchors)
                cand = {}
                for s in (1, -1):
                    pw = tuple(cv + s * perp)
                    cand[s] = np.linalg.norm(predict(pw) - corners[w])
                s = 1 if cand[1] <= cand[-1] else -1
                pos_w = tuple(cv + s * perp)
                pos_z = tuple(cu + s * perp)
                ok = True
                for c, pos in ((w, pos_w), (z, pos_z)):
                    if c in coords and coords[c] != pos:
                        ok = False
                if not ok:
                    continue
                coords[w] = pos_w
                coords[z] = pos_z
                placed.add(sj)
                frontier.append(sj)
    if len(coords) < 4:
        return None

    # Completion pass: a few lattice edges are typically lost (hysteresis
    # breaks, corner-merge cuts — the reference recovers them with its
    # LineReconstruction stage). Predict empty neighbor cells from a
    # local affine fit over nearby embedded corners and snap to unused
    # detected corners.
    from scipy.spatial import cKDTree

    tree = cKDTree(corners)
    used = set(coords.keys())
    changed = True
    while changed:
        changed = False
        occupied = set(coords.values())
        cands = set()
        for (i, j) in occupied:
            for di, dj in ((0, 1), (0, -1), (1, 0), (-1, 0)):
                p = (i + di, j + dj)
                if p not in occupied:
                    cands.add(p)
        inv = {q: c for c, q in coords.items()}
        for p in cands:
            near = [(c, q) for c, q in coords.items()
                    if abs(q[0] - p[0]) <= 2 and abs(q[1] - p[1]) <= 2]
            if len(near) < 4:
                continue
            A = np.asarray([[q[0], q[1], 1.0] for _, q in near])
            Y = corners[[c for c, _ in near]]
            M, *_ = np.linalg.lstsq(A, Y, rcond=None)
            pred = np.asarray([p[0], p[1], 1.0]) @ M
            # Local spacing from the nearest embedded lattice edge.
            spacings = [np.linalg.norm(corners[c1] - corners[c2])
                        for c1, q1 in near for c2, q2 in near
                        if abs(q1[0] - q2[0]) + abs(q1[1] - q2[1]) == 1]
            if not spacings:
                continue
            tol = 0.35 * float(np.median(spacings))
            d, k = tree.query(pred)
            if k not in used and d < tol:
                coords[int(k)] = p
                used.add(int(k))
                changed = True

    ij = np.asarray(list(coords.values()))
    imin, jmin = ij.min(axis=0)
    imax, jmax = ij.max(axis=0)
    grid = np.full((imax - imin + 1, jmax - jmin + 1, 2), np.nan)
    for c, (i, j) in coords.items():
        grid[i - imin, j - jmin] = corners[c]
    if np.isnan(grid).any():
        return None
    return grid


def assemble_grid_from_squares(image, corners: np.ndarray,
                               attach_radius: float = 6.0,
                               device: str | torch.device | None = None
                               ) -> Optional[np.ndarray]:
    """End-to-end: edge chains (on ``device``, None = the card) -> squares
    -> integer grid."""
    params = LineSegmentParams(min_chain=3, angular_threshold_deg=30.0,
                               high_threshold_ratio=8e-2,
                               low_threshold_ratio=3e-2)
    chains = edge_chains(np.asarray(image, np.float32), params, device)
    squares = reconstruct_squares(corners, chains, attach_radius)
    return squares_to_grid(corners, squares)
