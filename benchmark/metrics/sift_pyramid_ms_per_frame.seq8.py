"""Device ms per frame of the program's ``sift.pyramid`` span: the
Gaussian and DoG pyramids inside ``_compute_sift_batch``."""
from benchmark.metrics._program import device_ms_per_unit


def read(ctx):
    return device_ms_per_unit(ctx, "sift.pyramid")
