"""Feature detection & description (twin of ``sara_tpu/features``, the
ported part)."""

from sara_tpu_torch.features.dog import DoGParams, detect_dog_octave
from sara_tpu_torch.features.orientation import dominant_orientations
from sara_tpu_torch.features.sift import sift_descriptors
from sara_tpu_torch.features.api import SIFTParams, compute_sift_keypoints

__all__ = [
    "DoGParams", "detect_dog_octave",
    "dominant_orientations", "sift_descriptors",
    "SIFTParams", "compute_sift_keypoints",
]
