"""Point cloud bookkeeping: track -> scene point mapping, growth, export.

Twin of ``sara_tpu/sfm/pointcloud.py`` (NumPy only). Host-side rebuild
of the reference's PointCloudGenerator (reference:
cpp/src/DO/Sara/SfM/BuildingBlocks/PointCloudGenerator.hpp:25-173,
.cpp:190-507 — scene-point index propagation across merged tracks,
barycentric compression, growth by triangulation with cheirality +
distance_max filtering, color sampling, PLY export). Triangulation itself
runs on the device (``mvg/two_view.py::triangulate_linear``); this module
owns the mutable map state.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np

DISTANCE_MAX = 1e3  # reference: PointCloudGenerator.cpp distance_max


class PointCloudGenerator:
    """Keys of ``scene_point_of_track`` are STABLE track representatives
    (``FeatureTracker.rep_of_tracks``), not generation-local dense track
    ids — dense ids are renumbered whenever components merge. Call
    :meth:`propagate` after every ``compute_tracks`` to barycenter-merge
    the scene points of fused tracks (reference:
    PointCloudGenerator::propagate_scene_point_indices, .cpp:190-244)."""

    def __init__(self):
        self.points = np.zeros((0, 3))
        self.colors = np.zeros((0, 3))
        self.scene_point_of_track: Dict[int, int] = {}

    @property
    def num_points(self) -> int:
        return len(self.points)

    def track_has_point(self, track_id: int) -> bool:
        return track_id in self.scene_point_of_track

    def point_of_track(self, track_id: int) -> Optional[np.ndarray]:
        i = self.scene_point_of_track.get(track_id)
        return self.points[i] if i is not None else None

    def add_points(self, track_ids, xyz: np.ndarray,
                   colors: Optional[np.ndarray] = None):
        """Assign new scene points to (trackless) tracks, filtering
        non-finite / too-distant points (reference: grow_point_cloud,
        PointCloudGenerator.cpp:289-427)."""
        xyz = np.asarray(xyz, float)
        ok = np.isfinite(xyz).all(axis=1) & (np.linalg.norm(xyz, axis=1) < DISTANCE_MAX)
        if colors is None:
            colors = np.full_like(xyz, 0.5)
        base = len(self.points)
        kept = 0
        new_pts = []
        new_cols = []
        for ti, good, p, c in zip(track_ids, ok, xyz, colors):
            ti = int(ti)
            if not good or ti in self.scene_point_of_track:
                continue
            self.scene_point_of_track[ti] = base + kept
            new_pts.append(p)
            new_cols.append(c)
            kept += 1
        if kept:
            self.points = np.concatenate([self.points, np.asarray(new_pts)])
            self.colors = np.concatenate([self.colors, np.asarray(new_cols)])
        return kept

    def propagate(self, tracker):
        """Reference ``propagate_scene_point_indices``
        (PointCloudGenerator.cpp:190-244): when feature tracks have merged
        since scene points were created, several stored keys now resolve to
        the same component — replace their scene points by the barycenter
        (positions AND colors), re-key everything to the component's
        current canonical representative, and keep the first point index.

        Keys are stable representative gids from
        :meth:`FeatureTracker.canonical_rep`.
        """
        if not self.scene_point_of_track or tracker.comp_min_gid is None:
            return
        keys = np.fromiter(self.scene_point_of_track.keys(), np.int64)
        idxs = np.fromiter(self.scene_point_of_track.values(), np.int64)
        canon = tracker.canonical_rep(keys)
        new_map: Dict[int, int] = {}
        order = np.argsort(canon, kind="stable")
        canon_o, idxs_o = canon[order], idxs[order]
        starts = np.nonzero(np.r_[True, canon_o[1:] != canon_o[:-1]])[0]
        ends = np.r_[starts[1:], len(canon_o)]
        for s, e in zip(starts, ends):
            members = idxs_o[s:e]
            first = int(members[0])
            if e - s > 1:
                bary = self.points[members].mean(axis=0)
                col = self.colors[members].mean(axis=0)
                self.points[first] = bary
                self.colors[first] = col
            new_map[int(canon_o[s])] = first
        # Compact: drop the non-kept duplicate rows (they would otherwise
        # overcount num_points, miss BA refreshes, and leak into exports).
        live = np.asarray(sorted(set(new_map.values())), np.int64)
        remap = {int(old): new for new, old in enumerate(live)}
        self.points = self.points[live] if len(live) else np.zeros((0, 3))
        self.colors = self.colors[live] if len(live) else np.zeros((0, 3))
        self.scene_point_of_track = {t: remap[i] for t, i in new_map.items()}

    def update_points(self, track_ids, xyz: np.ndarray):
        """Overwrite positions of existing tracks' scene points (e.g. after
        bundle adjustment)."""
        for ti, p in zip(track_ids, np.asarray(xyz, float)):
            i = self.scene_point_of_track.get(int(ti))
            if i is not None and np.isfinite(p).all():
                self.points[i] = p

    def compress(self, live_track_ids):
        """Drop scene points whose tracks are gone; re-index densely
        (reference: compress_point_cloud, PointCloudGenerator.cpp:246-287)."""
        live = set(int(t) for t in live_track_ids)
        keep = [(t, i) for t, i in self.scene_point_of_track.items() if t in live]
        idx = np.asarray([i for _, i in keep], int)
        self.points = self.points[idx] if len(idx) else np.zeros((0, 3))
        self.colors = self.colors[idx] if len(idx) else np.zeros((0, 3))
        self.scene_point_of_track = {t: k for k, (t, _) in enumerate(keep)}

    def write_ply(self, path: str):
        """ASCII PLY export (reference: PointCloudGenerator.cpp:447-507)."""
        write_ply(path, self.points, self.colors)


def write_ply(path: str, points, colors=None):
    """ASCII PLY export of an (N, 3) point array with optional (N, 3)
    colors in [0, 1] (reference: PointCloudGenerator.cpp:447-507)."""
    points = np.asarray(points, float)
    colors = (np.full_like(points, 0.7) if colors is None
              else np.asarray(colors, float))
    with open(path, "w") as f:
        f.write("ply\nformat ascii 1.0\n")
        f.write(f"element vertex {len(points)}\n")
        f.write("property float x\nproperty float y\nproperty float z\n")
        f.write("property uchar red\nproperty uchar green\nproperty uchar blue\n")
        f.write("end_header\n")
        for p, c in zip(points, colors):
            r, g, b = (np.clip(c, 0, 1) * 255).astype(int)
            f.write(f"{p[0]:.6f} {p[1]:.6f} {p[2]:.6f} {r} {g} {b}\n")
