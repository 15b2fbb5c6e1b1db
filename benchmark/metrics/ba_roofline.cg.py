"""Share (%) of one PCG LM iteration's least time
(``counts/ba.py::cg_iteration_work``) in the device time per iteration of
the matrix-free LM loop (CUDA events around ``core._lm_cg``, over its
iterations)."""
from benchmark.metrics._read import roofline_pct


def read(ctx):
    return roofline_pct(ctx, "ba_iteration", "lm")
