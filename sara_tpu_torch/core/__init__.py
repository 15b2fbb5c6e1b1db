"""Core typed containers (twin of ``sara_tpu/core``, the slice's part)."""

from sara_tpu_torch.core.types import (Keypoints, Matches, concat_keypoints,
                                       take_keypoints)
from sara_tpu_torch.core import cameras

__all__ = ["Keypoints", "Matches", "concat_keypoints", "take_keypoints",
           "cameras"]
