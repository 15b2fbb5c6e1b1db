"""Robust estimation: batched RANSAC engine and model estimators."""

from sara_tpu_torch.ransac.engine import ransac, RansacResult, ransac_num_samples
from sara_tpu_torch.ransac.estimators import (
    estimate_homography,
    estimate_fundamental,
    estimate_relative_pose,
    estimate_absolute_pose,
)

__all__ = [
    "ransac", "RansacResult", "ransac_num_samples",
    "estimate_homography", "estimate_fundamental",
    "estimate_relative_pose", "estimate_absolute_pose",
]
