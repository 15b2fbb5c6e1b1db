"""I/O (twin of ``sara_tpu/io``): images, video, datasets, feature
serialization (HDF5), the nuScenes tables and checkpoints of the
incremental SfM state."""

from sara_tpu_torch.io.image import imread, imwrite, imread_gray
from sara_tpu_torch.io.video import VideoStream, VideoWriter
from sara_tpu_torch.io.datasets import read_strecha_camera, load_image_pair
from sara_tpu_torch.io.features_io import (
    save_keypoints_h5, load_keypoints_h5, save_matches_h5, load_matches_h5,
    save_two_view_geometry_h5, load_two_view_geometry_h5)
from sara_tpu_torch.io.checkpoint import save_sfm_state, load_sfm_state

__all__ = [
    "imread", "imwrite", "imread_gray",
    "VideoStream", "VideoWriter",
    "read_strecha_camera", "load_image_pair",
    "save_keypoints_h5", "load_keypoints_h5",
    "save_matches_h5", "load_matches_h5",
    "save_two_view_geometry_h5", "load_two_view_geometry_h5",
    "save_sfm_state", "load_sfm_state",
]
