"""Host ms per frame inside the program's ``sift`` span: the time the
host takes to issue the features layer's work, to read against the
device's ``sift_ms_per_frame.stereo``."""
from benchmark.metrics._program import span


def read(ctx):
    s = span(ctx, "sift")
    return 1e3 * s["host_s"] / s["units"] if s and s["units"] else None
