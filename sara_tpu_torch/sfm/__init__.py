"""Incremental SfM: pose graph, feature tracks, point cloud, odometry
pipeline (twin of ``sara_tpu/sfm``, the slice's part).

Graph bookkeeping runs on the host (NumPy + the native C++ union-find);
the per-frame heavy compute (detection, matching, RANSAC, triangulation,
BA) runs on the pipeline's device with fixed-capacity tensors.
"""

from sara_tpu_torch.sfm.disjoint_sets import DisjointSets, connected_components
from sara_tpu_torch.sfm.tracker import FeatureTracker
from sara_tpu_torch.sfm.pose_graph import CameraPoseGraph
from sara_tpu_torch.sfm.pointcloud import PointCloudGenerator
from sara_tpu_torch.sfm.odometry import OdometryPipeline, OdometryConfig

__all__ = [
    "DisjointSets", "connected_components", "FeatureTracker",
    "CameraPoseGraph", "PointCloudGenerator",
    "OdometryPipeline", "OdometryConfig",
]
