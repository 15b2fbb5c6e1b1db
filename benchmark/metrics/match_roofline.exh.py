"""Share (%) of a pair's least time (``counts/match.py`` at the traced
pairs' mean valid rows) in its measured device ms."""
from benchmark.metrics._read import roofline_pct


def read(ctx):
    return roofline_pct(ctx, "match_pair", "match")
