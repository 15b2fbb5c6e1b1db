"""The city-grid synthetic scene of BASELINE config 5 on the PyTorch /
CUDA port.

Twin of ``scripts/bench_city_scale_scene.py``: the boustrophedon street
sweep with street-level structure and proximity loop pairs, the same
numpy draws, with each view's keypoints as the port's ``Keypoints`` on a
device. ``scripts/torch_bench_city_scale.py`` runs it through the global
SfM. It imports only ``sara_tpu_torch`` and numpy.
"""

from __future__ import annotations

import numpy as np


def _path(n_views: int):
    """Camera centers / yaws / pitches of the boustrophedon sweep.

    Straight street rows joined by SMOOTH turn arcs (consecutive views
    always overlap — {0, pi}-only headings both fragment the epipolar
    graph at row ends and form a degenerate rotation subgroup that breaks
    spectral rotation averaging)."""
    turn_views = 8
    row_len = max(8, int(np.ceil(n_views / np.sqrt(n_views))))
    centers, yaws, pitches = [], [], []
    pos = np.array([0.0, 0.0, 0.0])
    heading = 0.0
    f = 0
    while f < n_views:
        for _ in range(row_len):
            if f >= n_views:
                break
            d = np.array([np.sin(heading), 0.0, np.cos(heading)])
            pos = pos + d
            centers.append(pos.copy())
            yaws.append(heading + 0.1 * np.sin(0.7 * f))
            pitches.append(0.1 * np.sin(0.41 * f + 1.0))
            f += 1
        for _ in range(turn_views):
            if f >= n_views:
                break
            heading += np.pi / turn_views
            d = np.array([np.sin(heading), 0.0, np.cos(heading)])
            pos = pos + 0.8 * d
            centers.append(pos.copy())
            yaws.append(heading)
            pitches.append(0.1 * np.sin(0.41 * f + 1.0))
            f += 1
    return np.asarray(centers), np.asarray(yaws), np.asarray(pitches)


def _rot(yaw: float, pitch: float) -> np.ndarray:
    Ry = np.array([[np.cos(yaw), 0, -np.sin(yaw)], [0, 1, 0],
                   [np.sin(yaw), 0, np.cos(yaw)]])
    Rx = np.array([[1, 0, 0], [0, np.cos(pitch), -np.sin(pitch)],
                   [0, np.sin(pitch), np.cos(pitch)]])
    return Rx @ Ry


def gt_rotations(n_views: int) -> np.ndarray:
    """(V, 3, 3) world->camera ground-truth rotations of the sweep."""
    _, yaws, pitches = _path(n_views)
    return np.stack([_rot(y, p) for y, p in zip(yaws, pitches)])


def make_city_scene(n_views: int, capacity: int = 384, pts_per_seg: int = 36,
                    noise: float = 0.3, seed: int = 3, device="cuda"):
    """City-grid scene: per-view Keypoints with planted descriptors,
    ground-truth centers, and shared intrinsics. Structure is facade points
    ahead of each view in its heading frame, so visibility is LOCAL (the
    regime map-block partitioning targets) and adjacent rows create genuine
    loop pairs. The keypoints are the port's, on ``device``."""
    from sara_tpu_torch.convert import keypoints_from_numpy

    rs = np.random.RandomState(seed)
    centers, yaws, pitches = _path(n_views)

    X = []
    for f in range(n_views):
        yaw = yaws[f]
        d = np.array([np.sin(yaw), 0.0, np.cos(yaw)])
        side = np.array([np.cos(yaw), 0.0, -np.sin(yaw)])
        local = np.stack([
            rs.uniform(-4, 4, pts_per_seg),
            rs.uniform(-2.5, 2.5, pts_per_seg),
            rs.uniform(2.0, 14.0, pts_per_seg),
        ], axis=1)
        pts = (centers[f][None] + local[:, 2:3] * d[None]
               + local[:, 0:1] * side[None]
               + local[:, 1:2] * np.array([0.0, 1.0, 0.0])[None])
        X.append(pts)
    X = np.concatenate(X)
    desc = rs.normal(size=(len(X), 128))
    desc /= np.linalg.norm(desc, axis=1, keepdims=True)
    K = np.array([[600.0, 0, 320.0], [0, 600.0, 240.0], [0, 0, 1.0]])

    kps = []
    for f in range(n_views):
        R = _rot(yaws[f], pitches[f])
        t = -R @ centers[f]
        Xc = X @ R.T + t
        vis = (Xc[:, 2] > 1.0) & (Xc[:, 2] < 16.0)
        uv = Xc @ K.T
        uv = uv[:, :2] / np.where(vis, Xc[:, 2], 1.0)[:, None]
        inside = ((uv[:, 0] >= 0) & (uv[:, 0] < 640)
                  & (uv[:, 1] >= 0) & (uv[:, 1] < 480))
        idx = np.nonzero(vis & inside)[0][:capacity]
        n = len(idx)
        xy = np.zeros((capacity, 2), np.float32)
        xy[:n] = uv[idx] + rs.normal(scale=noise, size=(n, 2))
        d = np.zeros((capacity, 128), np.float32)
        d[:n] = desc[idx]
        mask = np.zeros(capacity, bool)
        mask[:n] = True
        kps.append(keypoints_from_numpy(
            (xy, np.full(capacity, 2.0, np.float32),
             np.zeros(capacity, np.float32), mask.astype(np.float32), d,
             mask), device))
    return kps, centers, K


def proximity_pairs(centers, window: int = 3, radius: float = 7.0,
                    gap: int = 12, max_loop_per_view: int = 2):
    """Sequential window pairs + loop pairs between spatially close,
    temporally distant views (stand-in for retrieval)."""
    V = len(centers)
    pairs = []
    for i in range(V):
        for j in range(i + 1, min(i + 1 + window, V)):
            pairs.append((i, j))
        d = np.linalg.norm(centers[i + gap:] - centers[i], axis=1)
        close = np.nonzero(d < radius)[0][:max_loop_per_view]
        for c in close:
            pairs.append((i, i + gap + int(c)))
    return sorted(set(pairs))
