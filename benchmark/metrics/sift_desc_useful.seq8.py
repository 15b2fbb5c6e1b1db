"""Share of the descriptor rows the frontend described that hold a kept
keypoint: the program's counters ``sift.kept`` over ``sift.desc_rows``."""
from benchmark.metrics._program import share


def read(ctx):
    return share(ctx, "sift.kept", "sift.desc_rows")
