"""Utilities (twin of ``sara_tpu/utils``): trajectory metrics, logging and
roofline estimates. The twin's timing helpers (``Timer``, ``TicToc``,
``device_trace``) come with the port's bench (ROADMAP A8)."""

from sara_tpu_torch.utils.log import get_logger
from sara_tpu_torch.utils.metrics import umeyama_alignment, ate_rmse
from sara_tpu_torch.utils.roofline import (Estimate, ba_lm_iteration,
                                          sift_frame,
                                          report as roofline_report)

__all__ = ["umeyama_alignment", "ate_rmse", "get_logger", "Estimate",
           "ba_lm_iteration", "sift_frame", "roofline_report"]
