"""Camera calibration: chessboard detection + intrinsics estimation (twin of
``sara_tpu/calib``). ``python -m sara_tpu_torch.calib.cli`` is the
command-line tool: chessboard frames in, intrinsics JSON out."""

from sara_tpu_torch.calib.calibrate import (
    zhang_init_intrinsics, homography_pose, calibrate_pinhole,
    calibrate_omnidirectional)
from sara_tpu_torch.calib.chessboard import (detect_chessboard_corners,
                                             ChessboardParams)

__all__ = [
    "zhang_init_intrinsics", "homography_pose", "calibrate_pinhole",
    "calibrate_omnidirectional",
    "detect_chessboard_corners", "ChessboardParams",
]
