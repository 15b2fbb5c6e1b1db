"""Share (%) of a frame's least time (``counts/sift.py`` at the traced
frames' mean keypoint count) in its measured device ms."""
from benchmark.metrics._read import roofline_pct


def read(ctx):
    return roofline_pct(ctx, "sift_frame", "sift")
