"""Device ms per frame of ``_compute_sift_batch``: CUDA events around
each call, over its frames."""
from benchmark.metrics._read import device_ms_per


def read(ctx):
    return device_ms_per(ctx, "sift")
