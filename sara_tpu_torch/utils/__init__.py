"""Utilities (twin of ``sara_tpu/utils``, the ported part: trajectory
metrics and logging)."""

from sara_tpu_torch.utils.log import get_logger
from sara_tpu_torch.utils.metrics import umeyama_alignment, ate_rmse

__all__ = ["umeyama_alignment", "ate_rmse", "get_logger"]
