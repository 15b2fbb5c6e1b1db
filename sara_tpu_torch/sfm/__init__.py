"""Incremental and global SfM: pose graph, feature tracks, point cloud,
odometry pipeline, loop closure, pose-graph optimization, rotation
averaging and the global pipeline (twin of ``sara_tpu/sfm``, the ported
part).

Graph bookkeeping runs on the host (NumPy + the native C++ union-find);
the heavy compute (detection, matching, RANSAC, triangulation, averaging,
pose-graph and bundle adjustment) runs on the pipeline's device with
fixed-capacity tensors.
"""

from sara_tpu_torch.sfm.disjoint_sets import DisjointSets, connected_components
from sara_tpu_torch.sfm.tracker import FeatureTracker
from sara_tpu_torch.sfm.pose_graph import CameraPoseGraph
from sara_tpu_torch.sfm.pointcloud import PointCloudGenerator
from sara_tpu_torch.sfm.odometry import OdometryPipeline, OdometryConfig
from sara_tpu_torch.sfm.pose_graph_opt import (PoseGraphProblem,
                                               optimize_pose_graph)
from sara_tpu_torch.sfm.rotation_averaging import average_rotations
from sara_tpu_torch.sfm.loop_closure import LoopCloser, LoopClosureConfig
from sara_tpu_torch.sfm.global_sfm import GlobalSfMConfig, run_global_sfm

__all__ = [
    "DisjointSets", "connected_components", "FeatureTracker",
    "CameraPoseGraph", "PointCloudGenerator",
    "OdometryPipeline", "OdometryConfig",
    "PoseGraphProblem", "optimize_pose_graph", "average_rotations",
    "LoopCloser", "LoopClosureConfig", "GlobalSfMConfig", "run_global_sfm",
]
