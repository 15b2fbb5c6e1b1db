"""Utilities (twin of ``sara_tpu/utils``, the slice's part: trajectory
metrics)."""

from sara_tpu_torch.utils.metrics import umeyama_alignment, ate_rmse

__all__ = ["umeyama_alignment", "ate_rmse"]
