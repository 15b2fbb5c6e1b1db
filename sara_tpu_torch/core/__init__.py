"""Core typed containers (twin of ``sara_tpu/core``; ``geometry`` and
``contours`` are imported by module, as in the twin)."""

from sara_tpu_torch.core.types import (Keypoints, Matches, concat_keypoints,
                                       take_keypoints)
from sara_tpu_torch.core import lie
from sara_tpu_torch.core import cameras
from sara_tpu_torch.core import poly

__all__ = ["Keypoints", "Matches", "concat_keypoints", "take_keypoints",
           "lie", "cameras", "poly"]
