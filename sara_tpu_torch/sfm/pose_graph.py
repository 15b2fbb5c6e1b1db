"""Camera pose graph (host-side).

Twin of ``sara_tpu/sfm/pose_graph.py``, NumPy only (the rotation-vector
packing uses scipy). Rebuild of the reference's CameraPoseGraph
(reference: cpp/src/DO/Sara/SfM/Graph/CameraPoseGraph.hpp:28-131 —
vertices carry AbsolutePoseData (pose, keypoints), edges carry
RelativePoseData (matches, inliers, relative motion)). Boost.Graph becomes
plain Python/NumPy structures; poses are stored as (R, t) world->camera.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import numpy as np


@dataclass
class AbsolutePose:
    R: np.ndarray              # (3,3) world->camera
    t: np.ndarray              # (3,)
    frame_index: int = 0       # source frame number (after skipping)

    def matrix(self) -> np.ndarray:
        M = np.eye(4)
        M[:3, :3] = self.R
        M[:3, 3] = self.t
        return M

    def center(self) -> np.ndarray:
        """Camera center in world coordinates: -R^T t."""
        return -self.R.T @ self.t


@dataclass
class RelativePoseEdge:
    src: int
    dst: int
    R: np.ndarray              # relative motion: x_dst = R x_src + t
    t: np.ndarray
    num_matches: int = 0
    num_inliers: int = 0


class CameraPoseGraph:
    def __init__(self):
        self.poses: List[AbsolutePose] = []
        self.edges: List[RelativePoseEdge] = []
        self._adj: Dict[int, List[int]] = {}

    def __len__(self):
        return len(self.poses)

    def add_absolute_pose(self, R: np.ndarray, t: np.ndarray,
                          frame_index: int = 0) -> int:
        v = len(self.poses)
        self.poses.append(AbsolutePose(np.asarray(R, float),
                                       np.asarray(t, float), frame_index))
        self._adj[v] = []
        return v

    def add_relative_pose(self, src: int, dst: int, R, t,
                          num_matches: int = 0, num_inliers: int = 0) -> int:
        e = len(self.edges)
        self.edges.append(RelativePoseEdge(src, dst, np.asarray(R, float),
                                           np.asarray(t, float),
                                           num_matches, num_inliers))
        self._adj[src].append(e)
        self._adj[dst].append(e)
        return e

    def set_pose(self, v: int, R, t):
        self.poses[v].R = np.asarray(R, float)
        self.poses[v].t = np.asarray(t, float)

    def pose(self, v: int) -> Tuple[np.ndarray, np.ndarray]:
        p = self.poses[v]
        return p.R, p.t

    def neighbors(self, v: int) -> List[int]:
        out = []
        for e in self._adj.get(v, []):
            edge = self.edges[e]
            out.append(edge.dst if edge.src == v else edge.src)
        return out

    def trajectory(self) -> np.ndarray:
        """(N, 3) camera centers."""
        return np.stack([p.center() for p in self.poses]) if self.poses else \
            np.zeros((0, 3))

    def poses_se3(self) -> np.ndarray:
        """(N, 6) angle-axis + t packing for the bundle adjuster."""
        from scipy.spatial.transform import Rotation

        out = np.zeros((len(self.poses), 6))
        for i, p in enumerate(self.poses):
            out[i, :3] = Rotation.from_matrix(p.R).as_rotvec()
            out[i, 3:] = p.t
        return out

    def update_from_se3(self, packed: np.ndarray):
        from scipy.spatial.transform import Rotation

        # Copy: packed may be a read-only view, which scipy's Cython
        # internals reject.
        packed = np.array(packed, dtype=float, copy=True)
        for i, p in enumerate(self.poses):
            if i < len(packed):
                p.R = Rotation.from_rotvec(packed[i, :3]).as_matrix()
                p.t = np.asarray(packed[i, 3:])
