"""Device ms per pair of ``_match_sets``: CUDA events around each chunk,
over its real (unpadded) pairs."""
from benchmark.metrics._read import device_ms_per


def read(ctx):
    return device_ms_per(ctx, "match")
