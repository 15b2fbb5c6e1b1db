"""State estimation & multiple-object tracking (twin of
``sara_tpu/tracking``).

The reference's KalmanFilter / MultipleObjectTracking layers (reference:
cpp/src/DO/Sara/KalmanFilter/*.hpp — concept-based observation /
state-transition equations; MultipleObjectTracking/*.hpp — observation /
process noise models + cosine re-ID distance).
"""

from sara_tpu_torch.tracking.kalman import (
    GaussianState, KalmanModel, kf_predict, kf_update,
    constant_velocity_box_model)
from sara_tpu_torch.tracking.mot import MultiObjectTracker, iou_matrix

__all__ = [
    "GaussianState", "KalmanModel", "kf_predict", "kf_update",
    "constant_velocity_box_model", "MultiObjectTracker", "iou_matrix",
]
