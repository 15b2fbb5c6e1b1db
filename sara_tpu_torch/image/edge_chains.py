"""Edge-chain machinery: orientation-consistent edgel grouping, chain
ordering, polyline simplification, and a chain-based line segment detector.

Twin of ``sara_tpu/image/edge_chains.py``. The dense per-pixel work (Canny
NMS, hysteresis, gradient orientation) is one device program whose two
maps come to the host in one transfer; the irregular graph work (connected
components over orientation-consistent edgel adjacency on the native
union-find, chain walking, polyline simplification) runs on the host, as
in the twin.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List

import numpy as np
import torch

from sara_tpu_torch import resolve_device
from sara_tpu_torch.core.geometry import ramer_douglas_peucker
from sara_tpu_torch.image.differential import gradient
from sara_tpu_torch.image.edges import canny
from sara_tpu_torch.image.filtering import gaussian_blur
from sara_tpu_torch.sfm.disjoint_sets import connected_components
from sara_tpu_torch.utils.host import fetch, put


@dataclass(frozen=True)
class LineSegmentParams:
    """The twin's defaults (the reference's LineSegmentDetector.hpp)."""

    high_threshold_ratio: float = 5e-2
    low_threshold_ratio: float = 2e-2
    sigma: float = 1.4
    angular_threshold_deg: float = 20.0
    rdp_eps: float = 1.5
    min_length: float = 10.0
    min_chain: int = 5
    polish: bool = True


def _edge_orientation_program(image: torch.Tensor, low: float, high: float,
                              sigma: float = 1.4):
    """ONE device program: Canny edge map + gradient orientation."""
    edges = canny(image, low=low, high=high, sigma=sigma)
    gx, gy = gradient(gaussian_blur(image, sigma))
    return edges, torch.atan2(gy, gx)


def _orientation_consistent_components(edge_map: np.ndarray,
                                       orientation: np.ndarray,
                                       angular_threshold: float):
    """Union 8-adjacent edgels whose orientations agree mod pi within the
    angular threshold."""
    H, W = edge_map.shape
    idx = np.arange(H * W).reshape(H, W)
    pairs_a, pairs_b = [], []
    for dy, dx in ((0, 1), (1, 0), (1, 1), (1, -1)):
        sl_a = (slice(0, H - dy), slice(max(0, -dx), min(W, W - dx)))
        sl_b = (slice(dy, H), slice(max(0, dx), min(W, W + dx)))
        both = edge_map[sl_a] & edge_map[sl_b]
        da = np.mod(orientation[sl_a] - orientation[sl_b], np.pi)
        da = np.minimum(da, np.pi - da)
        ok = both & (da < angular_threshold)
        pairs_a.append(idx[sl_a][ok])
        pairs_b.append(idx[sl_b][ok])
    a = np.concatenate(pairs_a)
    b = np.concatenate(pairs_b)
    labels, _ = connected_components(H * W, a, b)
    labels = labels.reshape(H, W)
    return np.where(edge_map, labels, -1)


def _walk_chain(points: np.ndarray) -> np.ndarray:
    """Order a component's edgels into a polyline by walking from an
    endpoint (reference contour extraction, EdgePostProcessing.hpp)."""
    if len(points) <= 2:
        return points
    pset = {tuple(p): i for i, p in enumerate(points)}
    neigh = [[] for _ in range(len(points))]
    for i, (y, x) in enumerate(points):
        for dy in (-1, 0, 1):
            for dx in (-1, 0, 1):
                if dy == 0 and dx == 0:
                    continue
                j = pset.get((y + dy, x + dx))
                if j is not None:
                    neigh[i].append(j)
    # Start at an endpoint (1 neighbor); fall back to any point (loop).
    start = next((i for i, nb in enumerate(neigh) if len(nb) == 1), 0)
    out = [start]
    seen = {start}
    cur = start
    while True:
        nxt = [j for j in neigh[cur] if j not in seen]
        if not nxt:
            break
        # Prefer the closest continuation (4-neighbors before diagonals).
        cur = min(nxt, key=lambda j: abs(points[j][0] - points[cur][0])
                  + abs(points[j][1] - points[cur][1]))
        seen.add(cur)
        out.append(cur)
    return points[out]


def edge_chains(image, params: LineSegmentParams = LineSegmentParams(),
                device: str | torch.device | None = None) -> List[np.ndarray]:
    """Ordered edge chains (list of (N, 2) float arrays, (x, y) order).

    Device (``device``, None = the card): Canny + orientation, fetched in
    one transfer. Host: orientation-consistent CCL (native union-find) +
    chain walking."""
    g = np.asarray(image, np.float32)
    scale = max(g.max(), 1e-6)
    edges, ori = fetch(*_edge_orientation_program(
        put(g, resolve_device(device)), params.low_threshold_ratio * scale,
        params.high_threshold_ratio * scale, sigma=params.sigma))
    labels = _orientation_consistent_components(
        edges, ori, np.deg2rad(params.angular_threshold_deg))
    chains = []
    ys, xs = np.nonzero(labels >= 0)
    lab = labels[ys, xs]
    order = np.argsort(lab, kind="stable")
    ys, xs, lab = ys[order], xs[order], lab[order]
    starts = np.nonzero(np.r_[True, lab[1:] != lab[:-1]])[0]
    ends = np.r_[starts[1:], len(lab)]
    for s, e in zip(starts, ends):
        if e - s < params.min_chain:
            continue
        pts = np.stack([ys[s:e], xs[s:e]], axis=1)
        ordered = _walk_chain(pts)
        chains.append(ordered[:, ::-1].astype(float))  # (x, y)
    return chains


def _polish_segment(chain_xy: np.ndarray, a: np.ndarray, b: np.ndarray):
    """Least-squares line fit over the chain points between vertices a, b,
    endpoints re-projected onto the fitted line (reference
    polish_line_segments, LineSegmentDetector.hpp:54)."""
    d = b - a
    L = np.linalg.norm(d)
    if L < 1e-9:
        return a, b
    u = d / L
    t = (chain_xy - a) @ u
    sel = (t >= -0.5) & (t <= L + 0.5)
    pts = chain_xy[sel]
    if len(pts) < 2:
        return a, b
    c = pts.mean(axis=0)
    cov = (pts - c).T @ (pts - c)
    w, V = np.linalg.eigh(cov)
    dirv = V[:, -1]
    tt = (pts - c) @ dirv
    return c + tt.min() * dirv, c + tt.max() * dirv


def line_segments_from_chains(chains: List[np.ndarray],
                              params: LineSegmentParams =
                              LineSegmentParams()) -> np.ndarray:
    """(M, 2, 2) line segments [(x1,y1),(x2,y2)] by RDP-splitting each
    chain and keeping pieces longer than min_length."""
    segs = []
    for ch in chains:
        poly = ramer_douglas_peucker(ch, params.rdp_eps)
        for k in range(len(poly) - 1):
            a, b = poly[k], poly[k + 1]
            if np.linalg.norm(b - a) < params.min_length:
                continue
            if params.polish:
                a, b = _polish_segment(ch, a, b)
            segs.append((a, b))
    return (np.asarray(segs, float) if segs
            else np.zeros((0, 2, 2)))


def detect_line_segments(image,
                         params: LineSegmentParams = LineSegmentParams(),
                         device: str | torch.device | None = None
                         ) -> np.ndarray:
    """Full chain-based line segment detector (the twin's pipeline)."""
    return line_segments_from_chains(edge_chains(image, params, device),
                                     params)


def group_aligned_segments(segments: np.ndarray,
                           angle_threshold_deg: float = 20.0,
                           dist_threshold: float = 10.0) -> np.ndarray:
    """Group segments whose endpoints are close and directions aligned
    (reference EndPointGraph::mark_plausible_alignments + group(),
    EdgeGrouping.hpp:95-199). Returns (M,) group labels."""
    M = len(segments)
    if M == 0:
        return np.zeros(0, np.int64)
    d = segments[:, 1] - segments[:, 0]
    L = np.maximum(np.linalg.norm(d, axis=1), 1e-9)
    u = d / L[:, None]
    cos_t = np.cos(np.deg2rad(angle_threshold_deg))
    ends = segments.reshape(M * 2, 2)               # endpoint k of seg k//2
    dist = np.linalg.norm(ends[:, None, :] - ends[None, :, :], axis=-1)
    seg_of = np.repeat(np.arange(M), 2)
    aligned = np.abs(u @ u.T) >= cos_t
    close = dist <= dist_threshold
    pair_ok = close & aligned[seg_of[:, None], seg_of[None, :]]
    ii, jj = np.nonzero(np.triu(pair_ok, 1))
    labels, _ = connected_components(M, seg_of[ii], seg_of[jj])
    return labels
