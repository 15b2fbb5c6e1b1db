"""Visualization (twin of ``sara_tpu/viz``): matplotlib drawings of
features, matches, point clouds and trajectories rendered to files with a
headless backend (reference: cpp/src/DO/Sara/Visualization/Match/
Draw.hpp:40-44, Features/Draw.hpp; Kalpana point-cloud scenes), and the
self-contained HTML point-cloud viewer that the odometry pipeline's live
view writes."""

from sara_tpu_torch.viz.draw import (
    draw_keypoints, draw_matches, draw_point_cloud, draw_trajectory)
from sara_tpu_torch.viz.html_viewer import write_html_viewer

__all__ = ["draw_keypoints", "draw_matches", "draw_point_cloud",
           "draw_trajectory", "write_html_viewer"]
