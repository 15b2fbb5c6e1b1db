"""Bundle adjustment: Levenberg-Marquardt + Schur complement (twin of
``sara_tpu/ba``; the partitioned solver is ``ba/partitioned.py``)."""

from sara_tpu_torch.ba.core import (
    BAProblem, BAOptions, bundle_adjust, bundle_adjust_cg, ba_cost,
    project_obs,
)
from sara_tpu_torch.ba.dense_schur import DenseSchurSession

__all__ = ["BAProblem", "BAOptions", "bundle_adjust", "bundle_adjust_cg",
           "ba_cost", "project_obs", "DenseSchurSession"]
