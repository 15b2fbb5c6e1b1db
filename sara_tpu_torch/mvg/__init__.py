"""Multi-view geometry: minimal solvers, two-view geometry, normalization.

Twin of ``sara_tpu/mvg``. Every solver takes a leading batch of minimal
samples, so a RANSAC hypothesis batch is one call.
"""

from sara_tpu_torch.mvg.normalizer import hartley_normalize, normalize_points
from sara_tpu_torch.mvg.solvers import (
    eight_point_fundamental,
    seven_point_fundamental,
    four_point_homography,
)
from sara_tpu_torch.mvg.two_view import (
    essential_to_motions,
    triangulate_linear,
    sampson_epipolar_distance,
    symmetric_epipolar_distance,
    symmetric_transfer_error,
    two_view_geometry,
)
from sara_tpu_torch.mvg.fivepoint import five_point_essential
from sara_tpu_torch.mvg.degeneracy import (dominant_plane_ratio,
                                           homography_from_epipolar)
from sara_tpu_torch.mvg.p3p import p3p_lambda_twist

__all__ = [
    "hartley_normalize", "normalize_points",
    "eight_point_fundamental", "seven_point_fundamental", "four_point_homography",
    "essential_to_motions", "triangulate_linear",
    "sampson_epipolar_distance", "symmetric_epipolar_distance",
    "symmetric_transfer_error", "two_view_geometry",
    "dominant_plane_ratio", "homography_from_epipolar",
    "five_point_essential", "p3p_lambda_twist",
]
