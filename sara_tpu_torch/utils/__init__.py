"""Utilities (twin of ``sara_tpu/utils``): trajectory metrics, timers,
logging and roofline estimates."""

from sara_tpu_torch.utils.log import get_logger
from sara_tpu_torch.utils.metrics import umeyama_alignment, ate_rmse
from sara_tpu_torch.utils.timing import Timer, TicToc, device_trace
from sara_tpu_torch.utils.roofline import (Estimate, ba_lm_iteration,
                                          sift_frame,
                                          report as roofline_report)

__all__ = ["umeyama_alignment", "ate_rmse", "Timer", "TicToc",
           "device_trace", "get_logger", "Estimate", "ba_lm_iteration",
           "sift_frame", "roofline_report"]
